"""Covariance Matrix Adaptation ES — the PyTorch counterpart of
``deap_tpu/cma.py``.  Three strategies, the JAX package's names and
math:

* :class:`Strategy` — (mu/mu_w, lambda) CMA-ES.  The hyper-parameters
  are Python floats computed in numpy float64 at construction (the
  weights rounded to float32 once); the evolving state is a
  :class:`CMAState` of tensors on the strategy's device, and
  ``generate``/``update`` are functions of it, driven by
  :func:`deap_tpu_torch.algorithms.ea_generate_update`.  The
  per-generation eigendecomposition is ``torch.linalg.eigh`` on the
  device (cuSOLVER on the card; it checks its ``info`` on the host, one
  synchronisation a generation).
* :class:`StrategyOnePlusLambda` — (1+lambda) with success-rule step
  size and a Cholesky refresh (``torch.linalg.cholesky_ex``: a matrix
  that is not positive definite gives a NaN factor, as
  ``jnp.linalg.cholesky`` does, instead of raising).
* :class:`StrategyMultiObjective` — MO-CMA-ES, host-driven numpy as in
  the JAX package; sampling draws its normals and parent picks on the
  device, and the hypervolume selection at two objectives runs as tensor
  code on the device (:func:`_mo_select_device`).

Eigenvectors carry no canonical sign: cuSOLVER, LAPACK and XLA may
return a column of ``B`` negated, which changes every later sample
(though not the law it is drawn from).  Nothing here normalises signs,
as the JAX package does not; hold two runs to each other generation by
generation from one state, and whole runs by their quality.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from . import random
from ._device import resolve_device
from .base import Population, lex_sort_indices
from .ops import indicator as _indicator
from .ops.emo import nondominated_ranks
from .utils.support import _host

__all__ = ["Strategy", "StrategyOnePlusLambda", "StrategyMultiObjective",
           "CMAState", "OnePlusLambdaState"]


def _f32(x) -> float:
    """A Python number rounded to float32, as jax rounds a weak-typed
    Python float where it meets a float32 array."""
    return float(np.float32(x))


def _sqrt_f32(x: float) -> float:
    """``jnp.sqrt`` of a Python float: the float32-rounded value's
    float32 square root (``math.sqrt`` rounds once from double and can
    differ in the last place)."""
    return float(np.sqrt(np.float32(x)))


def _symmetrize(a: torch.Tensor) -> torch.Tensor:
    """``(a + aᵀ) / 2``, what ``jnp.linalg.eigh``/``cholesky`` factor (the
    torch routines read one triangle only)."""
    return (a + a.mT) / 2


def _eigh(C: torch.Tensor):
    return torch.linalg.eigh(_symmetrize(C))


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class CMAState:
    centroid: torch.Tensor       # (dim,)
    sigma: torch.Tensor          # ()
    C: torch.Tensor              # (dim, dim)
    ps: torch.Tensor             # (dim,)
    pc: torch.Tensor             # (dim,)
    B: torch.Tensor              # (dim, dim) eigenvectors
    diagD: torch.Tensor          # (dim,) sqrt eigenvalues
    update_count: torch.Tensor   # () int32


class Strategy:
    """(mu/mu_w, lambda) CMA-ES (reference cma.py:30-205).  ``device``
    (default ``"cuda"``) holds the state; the other keywords are the
    reference's (``lambda_``, ``mu``, ``weights``, ``cmatrix``,
    ``ccum``, ``cs``, ``ccov1``, ``ccovmu``, ``damps``)."""

    def __init__(self, centroid, sigma: float, device=None, **kargs):
        self.device = resolve_device(device)
        self.centroid0 = _as_f32(centroid, self.device)
        self.dim = int(self.centroid0.shape[0])
        self.sigma0 = float(sigma)
        self.cmatrix0 = _as_f32(kargs.get("cmatrix", np.identity(self.dim)),
                                self.device)
        self.lambda_ = int(kargs.get("lambda_", 4 + 3 * math.log(self.dim)))
        self.chiN = math.sqrt(self.dim) * (
            1 - 1.0 / (4.0 * self.dim) + 1.0 / (21.0 * self.dim ** 2))
        self.params = kargs
        self.computeParams(kargs)

    def computeParams(self, params):
        """Static hyper-parameters from lambda, in numpy float64
        (reference cma.py:173-205); the weights are rounded to float32
        once."""
        self.mu = int(params.get("mu", self.lambda_ / 2))
        rweights = params.get("weights", "superlinear")
        if rweights == "superlinear":
            w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        elif rweights == "linear":
            w = self.mu + 0.5 - np.arange(1, self.mu + 1)
        elif rweights == "equal":
            w = np.ones(self.mu)
        else:
            raise RuntimeError(
                f"unrecognized recombination weighting {rweights!r}: "
                "expected 'superlinear', 'linear' or 'equal'")
        w = w / np.sum(w)
        self.weights = torch.tensor(w.astype(np.float32), device=self.device)
        self.mueff = float(1.0 / np.sum(w ** 2))
        self.cc = params.get("ccum", 4.0 / (self.dim + 4.0))
        self.cs = params.get(
            "cs", (self.mueff + 2.0) / (self.dim + self.mueff + 3.0))
        self.ccov1 = params.get(
            "ccov1", 2.0 / ((self.dim + 1.3) ** 2 + self.mueff))
        ccovmu = params.get(
            "ccovmu", 2.0 * (self.mueff - 2.0 + 1.0 / self.mueff)
            / ((self.dim + 2.0) ** 2 + self.mueff))
        self.ccovmu = min(1 - self.ccov1, ccovmu)
        damps = (1.0 + 2.0 * max(0.0, math.sqrt((self.mueff - 1.0)
                                                / (self.dim + 1.0)) - 1.0)
                 + self.cs)
        self.damps = params.get("damps", damps)

    def init(self) -> CMAState:
        diagD, B = _eigh(self.cmatrix0)
        return CMAState(
            centroid=self.centroid0,
            sigma=torch.tensor(self.sigma0, dtype=torch.float32,
                               device=self.device),
            C=self.cmatrix0,
            ps=torch.zeros(self.dim, device=self.device),
            pc=torch.zeros(self.dim, device=self.device),
            B=B,
            diagD=torch.sqrt(diagD),
            update_count=torch.tensor(0, dtype=torch.int32,
                                      device=self.device))

    def generate(self, state: CMAState, key) -> torch.Tensor:
        """lambda candidates: centroid + (sigma·z) @ (B·diagD)ᵀ, with z
        the threefry normals of ``key``."""
        arz = random.normal(key, (self.lambda_, self.dim))
        BD = state.B * state.diagD
        return state.centroid + (state.sigma * arz) @ BD.T

    def update(self, state: CMAState, population: Population) -> CMAState:
        """Evolution paths, rank-1 plus rank-mu covariance and sigma
        (reference cma.py:123-171), then ``eigh`` of the new C.  Python
        floats meet tensors where jax's weak types put them, in the JAX
        package's association order."""
        cs, cc, ccov1, ccovmu = self.cs, self.cc, self.ccov1, self.ccovmu
        w = population.fitness.masked_wvalues()
        order = lex_sort_indices(w, descending=True)
        genomes = population.genome[order[: self.mu]]          # (mu, dim)

        old_centroid = state.centroid
        centroid = self.weights @ genomes
        c_diff = centroid - old_centroid

        inv_D = 1.0 / state.diagD
        ps = ((1 - cs) * state.ps
              + _sqrt_f32(cs * (2 - cs) * self.mueff) / state.sigma
              * (state.B @ (inv_D * (state.B.T @ c_diff))))

        update_count = state.update_count + 1
        norm_ps = torch.linalg.vector_norm(ps)
        hsig = (norm_ps
                / torch.sqrt(1.0 - (1.0 - cs) ** (2.0 * update_count.float()))
                / self.chiN < (1.4 + 2.0 / (self.dim + 1.0))).float()

        pc = ((1 - cc) * state.pc
              + hsig * _sqrt_f32(cc * (2 - cc) * self.mueff)
              / state.sigma * c_diff)

        artmp = genomes - old_centroid
        C = ((1 - ccov1 - ccovmu
              + (1 - hsig) * ccov1 * cc * (2 - cc)) * state.C
             + ccov1 * torch.outer(pc, pc)
             + ccovmu * (self.weights * artmp.T) @ artmp
             / state.sigma ** 2)

        sigma = state.sigma * torch.exp(
            (norm_ps / self.chiN - 1.0) * cs / self.damps)

        diagD2, B = _eigh(C)
        diagD = torch.sqrt(torch.clamp(diagD2, min=1e-30))
        return CMAState(centroid=centroid, sigma=sigma, C=C, ps=ps, pc=pc,
                        B=B, diagD=diagD, update_count=update_count)


# ---------------------------------------------------------------------------
# (1 + lambda)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnePlusLambdaState:
    parent: torch.Tensor          # (dim,)
    parent_wvalues: torch.Tensor  # (nobj,)
    parent_valid: torch.Tensor    # () bool
    sigma: torch.Tensor           # ()
    C: torch.Tensor               # (dim, dim)
    A: torch.Tensor               # (dim, dim) Cholesky factor
    pc: torch.Tensor              # (dim,)
    psucc: torch.Tensor           # ()


def _lex_leq(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a <= b`` on weighted-value vectors (the
    reference's ``Fitness.__le__`` tuple compare), broadcast over
    leading axes."""
    result = torch.ones(torch.broadcast_shapes(wa.shape[:-1], wb.shape[:-1]),
                        dtype=torch.bool, device=wb.device)
    decided = torch.zeros_like(result)
    for j in range(wa.shape[-1]):
        lt = wa[..., j] < wb[..., j]
        gt = wa[..., j] > wb[..., j]
        result = torch.where(~decided & lt, True,
                             torch.where(~decided & gt, False, result))
        decided = decided | lt | gt
    return result


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN on and below the diagonal when ``a`` is
    not positive definite (``jnp.linalg.cholesky``'s answer;
    ``torch.linalg.cholesky`` would raise, and read the info word on the
    host to do so)."""
    L, info = torch.linalg.cholesky_ex(_symmetrize(a))
    return torch.where(info == 0, L, float("nan")).tril()


class StrategyOnePlusLambda:
    """(1+lambda) CMA-ES with success-rule step-size control (reference
    cma.py:208-325).  ``device`` (default ``"cuda"``) holds the state."""

    def __init__(self, parent, sigma: float,
                 weights: Sequence[float] = (-1.0,), device=None, **kargs):
        self.device = resolve_device(device)
        self.parent0 = _as_f32(parent, self.device)
        self.dim = int(self.parent0.shape[0])
        self.sigma0 = float(sigma)
        self.fitness_weights = tuple(weights)
        self.computeParams(kargs)

    def computeParams(self, params):
        """Reference cma.py:250-264."""
        self.lambda_ = int(params.get("lambda_", 1))
        self.d = params.get("d", 1.0 + self.dim / (2.0 * self.lambda_))
        self.ptarg = params.get("ptarg",
                                1.0 / (5 + math.sqrt(self.lambda_) / 2.0))
        self.cp = params.get(
            "cp", self.ptarg * self.lambda_ / (2 + self.ptarg * self.lambda_))
        self.cc = params.get("cc", 2.0 / (self.dim + 2.0))
        self.ccov = params.get("ccov", 2.0 / (self.dim ** 2 + 6.0))
        self.pthresh = params.get("pthresh", 0.44)

    def init(self) -> OnePlusLambdaState:
        nobj = len(self.fitness_weights)
        dev = self.device
        return OnePlusLambdaState(
            parent=self.parent0,
            parent_wvalues=torch.full((nobj,), float("-inf"), device=dev),
            parent_valid=torch.tensor(False, device=dev),
            sigma=torch.tensor(self.sigma0, dtype=torch.float32, device=dev),
            C=torch.eye(self.dim, device=dev),
            A=torch.eye(self.dim, device=dev),
            pc=torch.zeros(self.dim, device=dev),
            psucc=torch.tensor(self.ptarg, dtype=torch.float32, device=dev))

    def generate(self, state: OnePlusLambdaState, key) -> torch.Tensor:
        """parent + (sigma·z) @ Aᵀ."""
        arz = random.normal(key, (self.lambda_, self.dim))
        return state.parent + (state.sigma * arz) @ state.A.T

    def update(self, state: OnePlusLambdaState, population: Population
               ) -> OnePlusLambdaState:
        """Success rate, conditional parent replacement, pc/C/sigma, and
        the Cholesky refresh (reference cma.py:279-325).  Every branch is
        a ``torch.where``: nothing is read on the host."""
        cc, ccov = self.cc, self.ccov
        w = population.fitness.masked_wvalues()
        best = lex_sort_indices(w, descending=True)[:1]   # no host read
        best_w = w[best][0]
        best_genome = population.genome[best][0]

        # lambda_succ: offspring at least as good as the parent; the mean
        # is jax's sum times the float32 reciprocal of the count
        succ = _lex_leq(state.parent_wvalues, w)
        p_succ = succ.float().sum() * _f32(1.0 / w.shape[0])
        psucc = (1 - self.cp) * state.psucc + self.cp * p_succ

        improved = _lex_leq(state.parent_wvalues, best_w)
        x_step = (best_genome - state.parent) / state.sigma
        parent = torch.where(improved, best_genome, state.parent)
        parent_w = torch.where(improved, best_w, state.parent_wvalues)

        pc_low = (1 - cc) * state.pc + _sqrt_f32(cc * (2 - cc)) * x_step
        C_low = (1 - ccov) * state.C + ccov * torch.outer(pc_low, pc_low)
        pc_high = (1 - cc) * state.pc
        C_high = ((1 - ccov) * state.C
                  + ccov * (torch.outer(pc_high, pc_high)
                            + cc * (2 - cc) * state.C))
        use_low = psucc < self.pthresh
        pc = torch.where(improved, torch.where(use_low, pc_low, pc_high),
                         state.pc)
        C = torch.where(improved, torch.where(use_low, C_low, C_high),
                        state.C)

        sigma = state.sigma * torch.exp(
            1.0 / self.d * (psucc - self.ptarg) / (1.0 - self.ptarg))
        eye = torch.eye(self.dim, device=C.device)
        A = _cholesky_or_nan(C + 1e-12 * eye)
        return OnePlusLambdaState(
            parent=parent, parent_wvalues=parent_w,
            parent_valid=torch.ones_like(state.parent_valid), sigma=sigma,
            C=C, A=A, pc=pc, psucc=psucc)


# ---------------------------------------------------------------------------
# MO-CMA-ES
# ---------------------------------------------------------------------------


def _mo_select_device(w: torch.Tensor, mu: int):
    """MO-CMA environmental selection for two objectives as tensor code on
    ``w``'s device: fronts are admitted whole in rank order until one
    would overflow ``mu``; that split front is peeled one least
    2-D-hypervolume contributor at a time (ties to the lowest index),
    with the reference point ``max(-w) + 1`` over every candidate.

    The JAX package runs the peel as a ``lax.while_loop``; here the
    number of peels is read once (one host synchronisation) and the peel
    is a loop of device ops.  Returns ``(chosen_mask, ranks)``."""
    n = w.shape[0]
    ranks, _ = nondominated_ranks(w)
    r = ranks.long()
    sizes = torch.zeros(n + 1, dtype=torch.int64, device=w.device)
    sizes.index_add_(0, r, torch.ones_like(r))
    csum = torch.cumsum(sizes, 0)                 # through front r
    prev = csum - sizes                           # before front r
    whole = csum[r] <= mu
    is_mid = (prev[r] < mu) & (csum[r] > mu)
    prev_mid = torch.where(is_mid, prev[r], n).min()
    k_target = torch.clamp(mu - prev_mid, min=0)

    obj = -w                                      # minimisation space
    ref = obj.max(0).values + 1
    idx = torch.arange(n, device=w.device)
    mask = is_mid
    for _ in range(int(is_mid.sum() - k_target)):
        contribs = _indicator.hypervolume_contributions_2d(obj, mask, ref)
        victim = torch.argmin(torch.where(mask, contribs, float("inf")))
        mask = mask & (idx != victim)
    return whole | mask, ranks


class StrategyMultiObjective:
    """MO-CMA-ES (reference cma.py:328-547): per-parent step sizes and
    Cholesky factors, indicator-based (hypervolume) environmental
    selection.  Host-stateful numpy float64, like the JAX package's.

    ``device`` (default ``"cuda"``) is where the normals, the parent
    picks and the selection at two objectives with the hypervolume
    indicator run (:func:`_mo_select_device`); ``select_backend="host"``
    forces the reference-shaped host peel, which also serves every other
    indicator and objective count.  Both routes rank and measure the
    candidates in float32, as the JAX package's do (its arrays are
    float32 with 64-bit types off)."""

    def __init__(self, population_genomes, fitness_weights, sigma: float,
                 values=None, device=None, **params):
        self.device = resolve_device(device)
        self.parents = np.asarray(_host(population_genomes), np.float64)
        self.fitness_weights = tuple(fitness_weights)
        # (n, nobj) raw objective values of the parents; may be supplied
        # later by set_parent_values, before the first update
        self.parent_values = (None if values is None
                              else np.asarray(_host(values), np.float64))
        self.dim = self.parents.shape[1]
        n = self.parents.shape[0]
        self.mu = int(params.get("mu", n))
        self.lambda_ = int(params.get("lambda_", 1))
        self.d = params.get("d", 1.0 + self.dim / 2.0)
        self.ptarg = params.get("ptarg", 1.0 / (5.0 + 0.5))
        self.cp = params.get("cp", self.ptarg / (2.0 + self.ptarg))
        self.cc = params.get("cc", 2.0 / (self.dim + 2.0))
        self.ccov = params.get("ccov", 2.0 / (self.dim ** 2 + 6.0))
        self.pthresh = params.get("pthresh", 0.44)
        self.indicator = params.get("indicator", _indicator.hypervolume)
        self.select_backend = params.get("select_backend", "auto")

        self.sigmas = np.full(n, sigma, np.float64)
        self.A = np.stack([np.identity(self.dim) for _ in range(n)])
        self.invCholesky = np.stack([np.identity(self.dim) for _ in range(n)])
        self.pc = np.zeros((n, self.dim))
        self.psucc = np.full(n, self.ptarg)
        self._last_offspring_parent = None

    def _ranks(self, w: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        return nondominated_ranks(t)[0].cpu().numpy()

    # -- ask ----------------------------------------------------------------
    def generate(self, key) -> np.ndarray:
        """lambda offspring, each from its parent's own Gaussian
        (reference cma.py:394-428); records each offspring's parent.  A
        Python integer key is ``PRNGKey(key)`` of the default key
        implementation (:func:`deap_tpu_torch.random.default_impl`), as
        jax's ``PRNGKey`` follows ``jax_default_prng_impl``."""
        if isinstance(key, torch.Tensor):
            key = key.to(self.device)
        else:
            key = random.PRNGKey(int(key), device=self.device)
        k_z, k_pick = random.split(key)
        arz = random.normal(k_z, (self.lambda_, self.dim)).cpu().numpy()
        n = len(self.parents)
        if self.lambda_ == self.mu and n == self.lambda_:
            p_idx = np.arange(self.lambda_)
        else:
            # uniformly among the first-front parents
            if self.parent_values is not None:
                w = self.parent_values * np.asarray(self.fitness_weights)
                front = np.nonzero(self._ranks(w) == 0)[0]
            else:
                front = np.arange(n)
            picks = random.randint(k_pick, (self.lambda_,), 0,
                                   len(front)).cpu().numpy()
            p_idx = front[picks]
        Az = np.einsum("pij,pj->pi", self.A[p_idx], arz)
        offspring = self.parents[p_idx] + self.sigmas[p_idx, None] * Az
        self._last_offspring_parent = p_idx
        return offspring

    # -- selection ----------------------------------------------------------
    def _select(self, genomes, values, tags):
        """Front filling and hypervolume-contributor peeling (reference
        cma.py:430-469).  Returns (chosen indices, not-chosen indices);
        chosen in (rank, index) order, which is what concatenating the
        fronts in rank order gives."""
        n = len(genomes)
        if n <= self.mu:
            return list(range(n)), []
        w = values * np.asarray(self.fitness_weights)
        if (self.select_backend != "host" and w.shape[1] == 2
                and self.indicator is _indicator.hypervolume):
            mask, ranks_d = _mo_select_device(
                torch.as_tensor(w, dtype=torch.float32, device=self.device),
                self.mu)
            mask = mask.cpu().numpy()
            ranks_np = ranks_d.cpu().numpy()
            idx = np.arange(n)
            chosen = sorted(idx[mask], key=lambda i: (ranks_np[i], i))
            # the order of not_chosen does not matter: its one consumer
            # applies commuting per-parent-slot decays (see update())
            return [int(i) for i in chosen], [int(i) for i in idx[~mask]]
        ranks = self._ranks(w)
        order_fronts = [np.nonzero(ranks == r)[0]
                        for r in range(int(ranks.max()) + 1)]
        chosen, not_chosen = [], []
        mid_front = None
        full = False
        for front in order_fronts:
            front = list(front)
            if len(chosen) + len(front) <= self.mu and not full:
                chosen += front
            elif mid_front is None and len(chosen) < self.mu:
                mid_front = front
                full = True
            else:
                not_chosen += front
        k = self.mu - len(chosen)
        if k > 0 and mid_front is not None:
            ref = np.max(-w, axis=0) + 1
            while len(mid_front) > k:
                idx = self.indicator(w[mid_front].astype(np.float32), ref=ref)
                not_chosen.append(mid_front.pop(idx))
            chosen += mid_front
        return chosen, not_chosen

    @staticmethod
    def _rank_one_update(invCholesky, A, alpha, beta, v):
        """Reference _rankOneUpdate (cma.py:471-485)."""
        w = invCholesky @ v
        if w.max() > 1e-20:
            w_inv = w @ invCholesky
            norm_w2 = np.sum(w ** 2)
            a = math.sqrt(alpha)
            root = np.sqrt(1 + beta / alpha * norm_w2)
            b = a / norm_w2 * (root - 1)
            A = a * A + b * np.outer(v, w)
            invCholesky = (1.0 / a * invCholesky
                           - b / (a ** 2 + a * b * norm_w2) * np.outer(w, w_inv))
        return invCholesky, A

    # -- tell ---------------------------------------------------------------
    def set_parent_values(self, values):
        """Attach the parents' evaluated objective values."""
        self.parent_values = np.asarray(_host(values), np.float64)

    def update(self, offspring_genomes, offspring_values):
        """Indicator-based selection over offspring and parents, then the
        per-slot success-rate, step-size and Cholesky updates (reference
        cma.py:487-547)."""
        if self.parent_values is None:
            raise RuntimeError(
                "StrategyMultiObjective.update called before the parents were "
                "evaluated: pass values= to the constructor or call "
                "set_parent_values(values) with the (n, nobj) objective "
                "values of the initial population.")
        off_g = np.asarray(_host(offspring_genomes), np.float64)
        off_v = np.asarray(_host(offspring_values), np.float64)
        par_g = self.parents
        par_v = np.asarray(self.parent_values, np.float64)
        genomes = np.concatenate([off_g, par_g])
        values = np.concatenate([off_v, par_v])
        nlam = len(off_g)
        # tag: (is_offspring, parent index)
        tags = ([("o", int(self._last_offspring_parent[i]))
                 for i in range(nlam)]
                + [("p", i) for i in range(len(par_g))])

        chosen, not_chosen = self._select(genomes, values, tags)

        cp, cc, ccov = self.cp, self.cc, self.ccov
        d, ptarg, pthresh = self.d, self.ptarg, self.pthresh

        # offspring copies derive from the parents' state before the
        # update (reference cma.py:495-501)
        sig0 = self.sigmas.copy()
        psucc0 = self.psucc.copy()

        # per-offspring parameter copies and parent-slot success credits
        off_params = {}
        for i in chosen:
            t, p_idx = tags[i]
            if t != "o":
                continue
            last_step = sig0[p_idx]
            psucc = (1.0 - cp) * psucc0[p_idx] + cp
            sigma = sig0[p_idx] * math.exp(
                (psucc - ptarg) / (d * (1.0 - ptarg)))
            inv = self.invCholesky[p_idx].copy()
            A = self.A[p_idx].copy()
            pc = self.pc[p_idx].copy()
            if psucc < pthresh:
                xp = genomes[i]
                x = self.parents[p_idx]
                pc = (1.0 - cc) * pc + math.sqrt(cc * (2.0 - cc)) * (
                    xp - x) / last_step
                inv, A = self._rank_one_update(inv, A, 1 - ccov, ccov, pc)
            else:
                pc = (1.0 - cc) * pc
                pc_weight = cc * (2.0 - cc)
                inv, A = self._rank_one_update(
                    inv, A, 1 - ccov + pc_weight, ccov, pc)
            self.psucc[p_idx] = (1.0 - cp) * self.psucc[p_idx] + cp
            self.sigmas[p_idx] = self.sigmas[p_idx] * math.exp(
                (self.psucc[p_idx] - ptarg) / (d * (1.0 - ptarg)))
            off_params[i] = (sigma, inv, A, pc, psucc)

        # unsuccessful offspring only decay their parent slot
        for i in not_chosen:
            t, p_idx = tags[i]
            if t == "o":
                self.psucc[p_idx] = (1.0 - cp) * self.psucc[p_idx]
                self.sigmas[p_idx] = self.sigmas[p_idx] * math.exp(
                    (self.psucc[p_idx] - ptarg) / (d * (1.0 - ptarg)))

        # offspring take their copies, surviving parents their slots
        new_sigmas, new_inv, new_A, new_pc, new_psucc = [], [], [], [], []
        for i in chosen:
            t, p_idx = tags[i]
            if t == "o":
                sigma, inv, A, pc, psucc = off_params[i]
            else:
                sigma = self.sigmas[p_idx]
                inv = self.invCholesky[p_idx]
                A = self.A[p_idx]
                pc = self.pc[p_idx]
                psucc = self.psucc[p_idx]
            new_sigmas.append(sigma)
            new_inv.append(inv)
            new_A.append(A)
            new_pc.append(pc)
            new_psucc.append(psucc)

        self.parents = genomes[chosen]
        self.parent_values = values[chosen]
        self.sigmas = np.asarray(new_sigmas)
        self.invCholesky = np.stack(new_inv)
        self.A = np.stack(new_A)
        self.pc = np.stack(new_pc)
        self.psucc = np.asarray(new_psucc)
