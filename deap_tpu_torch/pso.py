"""Particle swarm optimization — the port's counterpart of
``deap_tpu/pso.py``.

The whole swarm is one :class:`PSOState` of ``(pop, dim)`` tensors —
positions, velocities, personal bests — and one step updates every
particle at once.

* :func:`pso_init` / :func:`pso_step` / :func:`pso` — gbest PSO (the
  reference example's ``phi1``/``phi2`` rule with speed limits), or the
  Clerc–Kennedy constriction update (``constriction=True``).
* :func:`multiswarm_init` / :func:`multiswarm_step` — multi-swarm PSO
  with exclusion, anti-convergence and quantum-cloud reinitialisation
  (Blackwell & Branke); the swarms are a leading axis.

Float forms follow XLA's CPU backend under ``jit``: the velocity update's
products are fused into its adds (``_xla_math.fma``), norms are row
reductions in XLA's order (``_xla_math.row_dot``), ``argmax`` takes the
first maximum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import random
from ._xla_math import fma, row_dot, sqrt
from .base import Fitness, Population

__all__ = ["PSOState", "pso_init", "pso_step", "pso",
           "MultiswarmState", "multiswarm_init", "multiswarm_step"]


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class PSOState:
    """Whole-swarm state: the reference's per-particle ``speed`` and
    ``best`` plus the global best."""

    position: torch.Tensor        # (pop, dim)
    speed: torch.Tensor           # (pop, dim)
    pbest: torch.Tensor           # (pop, dim)   personal best position
    pbest_w: torch.Tensor         # (pop,)       its weighted fitness
    gbest: torch.Tensor           # (dim,)       global best position
    gbest_w: torch.Tensor         # ()           its weighted fitness


def _weighted_rows(evaluate: Callable, weights) -> Callable:
    """``x (..., dim) -> (...,)`` weighted single-objective fitness of
    every row: the evaluate's batched form when it has one, else
    vmapped."""
    if len(weights) != 1:
        raise ValueError("PSO supports single-objective fitness")
    from .algorithms import evaluate_rows
    w = float(weights[0])

    def rows(x):
        flat = x.reshape(-1, x.shape[-1])
        return (evaluate_rows(evaluate, flat)[:, 0] * w).reshape(
            x.shape[:-1])
    return rows


def _unweight(x: torch.Tensor, w: float) -> torch.Tensor:
    """``x / w``, a true division on every device (on the card PyTorch
    turns a division by a Python scalar into a multiply by its
    reciprocal)."""
    return x / torch.tensor(float(w), device=x.device)


def pso_init(key, n: int, dim: int, pmin: float, pmax: float,
             smin: float, smax: float) -> PSOState:
    """Uniform positions in ``[pmin, pmax)``, speeds in ``[smin, smax)``
    (the reference's ``generate``), on the key's device."""
    kp, ks = random.split(key)
    pos = random.uniform(kp, (n, dim), minval=pmin, maxval=pmax)
    spd = random.uniform(ks, (n, dim), minval=smin, maxval=smax)
    return PSOState(position=pos, speed=spd, pbest=pos,
                    pbest_w=torch.full((n,), float("-inf"),
                                       device=key.device),
                    gbest=pos[0],
                    gbest_w=torch.tensor(float("-inf"), device=key.device))


def pso_step(key, state: PSOState, evaluate: Callable, weights=(-1.0,),
             phi1: float = 2.0, phi2: float = 2.0,
             smin: float | None = None, smax: float | None = None,
             constriction: bool = False, chi: float = 0.729843788,
             c: float = 2.05) -> tuple[PSOState, torch.Tensor]:
    """One synchronous PSO generation.

    Canonical rule: ``v += u1*(pbest - x) + u2*(gbest - x)`` (``u1``,
    ``u2`` uniform in ``[0, phi1)``, ``[0, phi2)``), each component's
    magnitude clamped to ``[smin, smax]``; constriction rule: ``v += chi
    * (ce1*(gbest - x) + ce2*(pbest - x)) - (1 - chi)*v``.  The
    positions are evaluated first, so the returned bests are those of
    the positions before the move.  Returns ``(new_state, raw fitness of
    the evaluated positions)``."""
    wfit = _weighted_rows(evaluate, weights)(state.position)      # (pop,)

    better = wfit > state.pbest_w
    pbest = torch.where(better[:, None], state.position, state.pbest)
    pbest_w = torch.where(better, wfit, state.pbest_w)

    i_best = torch.argmax(pbest_w)
    g_better = pbest_w[i_best] > state.gbest_w
    gbest = torch.where(g_better, pbest[i_best], state.gbest)
    gbest_w = torch.where(g_better, pbest_w[i_best], state.gbest_w)

    k1, k2 = random.split(key)
    shape = tuple(state.position.shape)
    x, v = state.position, state.speed
    if constriction:
        ce1 = _f32(c) * random.uniform(k1, shape)
        ce2 = _f32(c) * random.uniform(k2, shape)
        pull = fma(ce1, gbest - x, ce2 * (pbest - x))
        a = fma(pull, _f32(chi), v * -_f32(1.0 - chi))
        speed = v + a
    else:
        u1 = random.uniform(k1, shape, maxval=phi1)
        u2 = random.uniform(k2, shape, maxval=phi2)
        speed = fma(u2, gbest - x, fma(u1, pbest - x, v))
        if smin is not None or smax is not None:
            lo = 0.0 if smin is None else _f32(smin)
            hi = float("inf") if smax is None else _f32(smax)
            speed = torch.sign(speed) * torch.clamp(
                torch.clamp(speed.abs(), min=lo), max=hi)
    position = x + speed

    new = PSOState(position=position, speed=speed, pbest=pbest,
                   pbest_w=pbest_w, gbest=gbest, gbest_w=gbest_w)
    return new, _unweight(wfit, weights[0])


def pso(key, state: PSOState, evaluate: Callable, ngen: int,
        weights=(-1.0,), stats=None, verbose=False, **step_kwargs):
    """The gbest PSO loop (the reference example's main loop): each
    generation ``key, k = split(key)`` and one :func:`pso_step`.
    Returns ``(final_state, logbook)``; the logbook holds generations
    1..ngen."""
    from .algorithms import _logbook
    records = []
    for _ in range(ngen):
        key, k = random.split(key)
        state, raw = pso_step(k, state, evaluate, weights, **step_kwargs)
        pop = Population(
            genome=state.position,
            fitness=Fitness(values=raw[:, None],
                            valid=torch.ones(raw.shape[0], dtype=torch.bool,
                                             device=raw.device),
                            weights=tuple(weights)))
        records.append(dict(stats.compile(pop)) if stats is not None else {})
    return state, _logbook(stats, None, records, ngen, verbose, nevals=False)


# ---------------------------------------------------------------------------
# multiswarm PSO for dynamic landscapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiswarmState:
    """Stacked swarms, leading axis = swarm.  ``active`` masks the live
    swarms (a fixed capacity and a mask, where the reference grows and
    kills lists of swarms)."""

    position: torch.Tensor        # (ns, np, dim)
    speed: torch.Tensor           # (ns, np, dim)
    pbest: torch.Tensor           # (ns, np, dim)
    pbest_w: torch.Tensor         # (ns, np)
    sbest: torch.Tensor           # (ns, dim)    per-swarm best
    sbest_w: torch.Tensor         # (ns,)
    active: torch.Tensor          # (ns,) bool


def multiswarm_init(key, nswarm: int, nparticle: int, dim: int,
                    pmin: float, pmax: float, active: int | None = None
                    ) -> MultiswarmState:
    """Uniform positions in ``[pmin, pmax)`` and speeds in ``[-span,
    span)`` with ``span = (pmax - pmin) / 2``; the first ``active``
    swarms live (all by default)."""
    kp, ks = random.split(key)
    span = (pmax - pmin) / 2.0
    pos = random.uniform(kp, (nswarm, nparticle, dim), minval=pmin,
                         maxval=pmax)
    spd = random.uniform(ks, (nswarm, nparticle, dim), minval=-span,
                         maxval=span)
    dev = key.device
    act = torch.arange(nswarm, device=dev) < (nswarm if active is None
                                               else active)
    return MultiswarmState(
        position=pos, speed=spd, pbest=pos,
        pbest_w=torch.full((nswarm, nparticle), float("-inf"), device=dev),
        sbest=pos[:, 0],
        sbest_w=torch.full((nswarm,), float("-inf"), device=dev),
        active=act)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last axis: the square root of XLA's
    row sum of squares, its products fused into the sum (jitted alone or
    inside a step)."""
    return sqrt(row_dot(x, x, fused=True))


def _quantum_cloud(key, centre, rcloud, shape, fused=True):
    """The NUVD quantum cloud around ``centre`` (reference
    ``convertQuantum``): a direction from normals, normalized, at radius
    ``rcloud * |N(0, 1/3)|``.  Under ``jit`` XLA folds the normals'
    ``sqrt(2)`` into the constants: ``|e2 * (sqrt(2) / 3)| * (rcloud *
    sqrt(2))`` scales ``e1``, the ``erf_inv`` draw of the direction;
    ``fused=False`` takes the op-by-op form."""
    kd, ku = random.split(key)
    if fused:
        e1 = random.normal_erf_inv(kd, shape)
        norm = _norm(e1 * random.SQRT2)[..., None]
        e2 = random.normal_erf_inv(ku, shape[:-1] + (1,))
        third = float(np.float32(random.SQRT2) / np.float32(3.0))
        scale = float(np.float32(rcloud) * np.float32(random.SQRT2))
        num = e1 * ((e2 * third).abs() * scale)
        return centre + num / torch.clamp(norm, min=1e-12)
    direction = random.normal(kd, shape)
    norm = _norm(direction)[..., None]
    u = _unweight(random.normal(ku, shape[:-1] + (1,)), 3.0).abs()
    return centre + _f32(rcloud) * direction * u / torch.clamp(norm,
                                                                min=1e-12)


def multiswarm_step(key, state: MultiswarmState, evaluate: Callable,
                    weights=(1.0,), rexcl: float = 0.5, rcloud: float = 0.5,
                    chi: float = 0.729843788, c: float = 2.05, *,
                    fused: bool = True
                    ) -> tuple[MultiswarmState, torch.Tensor]:
    """One generation of multiswarm PSO (reference main loop of
    examples/pso/multiswarm.py):

    1. the constriction update within each swarm;
    2. exclusion: of two live swarms whose bests lie closer than
       ``rexcl``, the worse (the later on a tie) is reinitialised as a
       quantum cloud around its best;
    3. anti-convergence: when every live swarm has converged (radius <
       ``rexcl``), the worst live swarm is reinitialised.

    A reinitialised swarm's speeds are uniform in ``[-span, span)`` with
    ``span`` the largest speed magnitude: a device scalar, never read to
    the host.  ``fused`` takes the velocity update's float form under
    ``jit`` (products fused into the adds); ``fused=False`` rounds every
    product, as the JAX step does when called op by op.  Returns
    ``(state, each swarm's best raw fitness)``."""
    w0 = float(weights[0])
    wfit = _weighted_rows(evaluate, weights)(state.position)     # (ns, np)
    ns = state.position.shape[0]
    dev = state.position.device

    better = wfit > state.pbest_w
    pbest = torch.where(better[..., None], state.position, state.pbest)
    pbest_w = torch.where(better, wfit, state.pbest_w)

    i_best = torch.argmax(pbest_w, dim=1)                        # (ns,)
    rows = torch.arange(ns, device=dev)
    row, row_w = pbest[rows, i_best], pbest_w[rows, i_best]
    s_better = row_w > state.sbest_w
    sbest = torch.where(s_better[:, None], row, state.sbest)
    sbest_w = torch.where(s_better, row_w, state.sbest_w)

    ks = random.split(key, 4)
    k1, k2, k3, k4 = ks[0], ks[1], ks[2], ks[3]
    shape = tuple(state.position.shape)
    x, v = state.position, state.speed
    ce1 = _f32(c) * random.uniform(k1, shape)
    ce2 = _f32(c) * random.uniform(k2, shape)
    if fused:
        pull = fma(ce1, sbest[:, None] - x, ce2 * (pbest - x))
        a = fma(pull, _f32(chi), v * -_f32(1.0 - chi))
    else:
        pull = ce1 * (sbest[:, None] - x) + ce2 * (pbest - x)
        a = _f32(chi) * pull - _f32(1.0 - chi) * v
    speed = v + a
    position = x + speed

    d = _norm(sbest[:, None] - sbest[None, :])
    both = state.active[:, None] & state.active[None, :]
    eye = torch.eye(ns, dtype=torch.bool, device=dev)
    close = (d < _f32(rexcl)) & both & ~eye
    worse = (sbest_w[:, None] < sbest_w[None, :]) | (
        (sbest_w[:, None] == sbest_w[None, :]) & (rows[:, None] > rows[None, :]))
    reinit = (close & worse).any(dim=1)                          # (ns,)

    radius = _norm(position - sbest[:, None]).amax(dim=1)
    all_conv = (~state.active | (radius < _f32(rexcl))).all()
    masked_w = torch.where(state.active, sbest_w, float("inf"))
    worst = torch.argmin(masked_w)
    reinit = reinit | (all_conv & (rows == worst))

    cloud = _quantum_cloud(k3, sbest[:, None], rcloud, shape, fused)
    span = speed.abs().amax()
    new_speed = random.uniform(k4, shape, minval=-span, maxval=span)
    r3 = reinit[:, None, None]
    position = torch.where(r3, cloud, position)
    speed = torch.where(r3, new_speed, speed)
    pbest = torch.where(r3, position, pbest)
    pbest_w = torch.where(reinit[:, None], float("-inf"), pbest_w)

    new = MultiswarmState(position=position, speed=speed, pbest=pbest,
                          pbest_w=pbest_w, sbest=sbest, sbest_w=sbest_w,
                          active=state.active)
    return new, _unweight(sbest_w, w0)
