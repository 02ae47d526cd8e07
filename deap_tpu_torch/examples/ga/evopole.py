"""Neuroevolution: MLP policy weights on CartPole (BASELINE config 5) —
the port's counterpart of ``examples/ga/evopole.py``.

The genome is the dict ``{"w1", "b1", "w2", "b2"}`` of per-layer
weights (leaves ``(pop, 4, 16)``, ``(pop, 16)``, ``(pop, 16, 2)``,
``(pop, 2)``); every loop of :mod:`deap_tpu_torch.algorithms` handles it
through ``base._map``, which visits a dict's leaves by sorted key —
``b1, b2, w1, w2`` — as ``jax.tree_util`` does.

* **Environment**: CartPole-v1 physics (pole past 12 degrees or cart past
  +-2.4 ends an episode, 500 steps at most), one Euler step per call.
* **Policy**: obs(4) -> tanh(16) -> logits(2), action = argmax (the first
  index on ties).
* **Fitness**: mean episode length over ``N_EPISODES`` fixed random
  starts.  The rollout steps the ``(pop, episodes)`` batch of
  environments ``MAX_STEPS`` times as a Python loop of tensor ops on the
  population's device; the masked form stops once every episode ended.
* **Variation**: leaf-wise blend crossover and Gaussian weight mutation,
  each with a population-level form that draws ``split(key, n)`` and
  per row ``split(row_key, 4)`` over the sorted leaves, as the JAX
  package's ``vmap`` over per-row keys does (for rbg keys that vmap
  draws all rows from the first row's key, and so do these forms,
  through :func:`deap_tpu_torch.random.bits`).

Every float32 operation is the one XLA's CPU backend compiles for the
jitted JAX example: a division by a constant is a multiply by its
float32 reciprocal, a multiply whose only use is an add or a subtract
is fused into it (:func:`~deap_tpu_torch._xla_math.fma`), ``sin``/``cos``
are glibc's and ``tanh`` is Eigen's rational form
(:mod:`deap_tpu_torch._xla_math`), and the dot products of the policy
are summed in index order.  The rollout is therefore bitwise-equal to
jitted JAX on the CPU and the same on every device
(``tests/test_torch_evopole.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import algorithms, base, random
from ..._xla_math import (deferred_rounding, fma, fma_product, row_mean,
                          sincos, sincos_small, tanh)
from ...ops import selection
from ...ops._dispatch import batched_op
from ...utils.support import HallOfFame, Statistics

__all__ = ["env_step", "policy_action", "rollout", "rollout_masked",
           "rollout_population", "make_evaluate", "mate_blend",
           "mut_gaussian_tree", "init_population", "main"]

# -- environment (CartPole-v1 physics) --------------------------------------

GRAVITY = 9.8
MASS_CART, MASS_POLE = 1.0, 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
HALF_LEN = 0.5                      # half pole length
POLEMASS_LEN = MASS_POLE * HALF_LEN
FORCE_MAG = 10.0
TAU = 0.02
X_LIMIT, THETA_LIMIT = 2.4, 12 * 2 * np.pi / 360
MAX_STEPS = 500

HIDDEN = 16
N_EPISODES = 4
POP, NGEN = 256, 30
CXPB, MUTPB, SIGMA = 0.5, 0.8, 0.1


def _f32(v: float) -> float:
    """A Python float rounded to float32, as jax's weak-typed constants."""
    return float(np.float32(v))


# the float32 constants of the compiled step: a division by the total
# mass becomes a multiply by its float32 reciprocal, and in the
# pole-mass fraction of cos^2 that reciprocal and the pole mass are
# folded into one constant (their float32 product)
_INV_TOTAL = _f32(np.float32(1.0) / np.float32(TOTAL_MASS))
_POLE_FRAC = _f32(np.float32(MASS_POLE) * np.float32(_INV_TOTAL))
_PML, _TAU, _G = _f32(POLEMASS_LEN), _f32(TAU), _f32(GRAVITY)
_FOUR_THIRDS, _HALF = _f32(4.0 / 3.0), _f32(HALF_LEN)
_X_LIMIT, _THETA_LIMIT = _f32(X_LIMIT), _f32(THETA_LIMIT)


def env_step(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """One Euler step of the cart-pole dynamics: ``state`` ``(..., 4)``
    float32 ``(x, x_dot, theta, theta_dot)``, ``action`` ``(...)`` in
    {0, 1}."""
    return _env_step(state, action, sincos)


def _env_step(state, action, trig):
    x, x_dot, theta, theta_dot = state.unbind(-1)
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG)
    sin_t, cos_t = trig(theta)
    # force + POLEMASS_LEN * theta_dot**2 * sin_t, before the division by
    # the total mass; x_acc fuses its multiply by the reciprocal
    pushed = fma(theta_dot * theta_dot * _PML, sin_t, force)
    temp = pushed * _INV_TOTAL
    theta_acc = fma(sin_t, _G, -(cos_t * temp)) / (
        fma(-(cos_t * cos_t), _POLE_FRAC, _FOUR_THIRDS) * _HALF)
    x_acc = fma(pushed, _INV_TOTAL,
                -((theta_acc * _PML) * cos_t * _INV_TOTAL))
    # the four Euler updates, each value + TAU * its rate fused: one FMA
    # over the stacked state
    return fma(torch.stack([x_dot, x_acc, theta_dot, theta_acc], -1), _TAU,
               state)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_i x[..., i] * w[..., i, :]`` as XLA's CPU loop sums it: from
    0 in index order, each product fused into the running sum (the first
    is a plain product: fused into an add of zero)."""
    p = x.unsqueeze(-1).double() * w.double()          # exact products
    acc = p[..., 0, :].float()
    for i in range(1, x.shape[-1]):
        acc = fma_product(p[..., i, :], acc)
    return acc


def policy_action(genome, obs: torch.Tensor) -> torch.Tensor:
    """obs(4) -> tanh(16) -> logits(2) -> argmax (the first index on ties,
    a NaN logit wins as in ``jnp.argmax``).  The genome's leaves broadcast
    against ``obs``'s leading axes."""
    h = tanh(_dot(obs, genome["w1"]) + genome["b1"])
    logits = _dot(h, genome["w2"]) + genome["b2"]
    l0, l1 = logits[..., 0], logits[..., 1]
    return (~l0.isnan() & (l1.isnan() | (l1 > l0))).to(torch.int32)


def _alive(state: torch.Tensor) -> torch.Tensor:
    return ((state[..., 0].abs() < _X_LIMIT)
            & (state[..., 2].abs() < _THETA_LIMIT))


def _initial_states(episode_keys: torch.Tensor) -> torch.Tensor:
    """``(episodes, 4)`` random starts in [-0.05, 0.05), one a key (the
    draws of jax's ``vmap`` over the episode keys)."""
    return random.uniform(episode_keys, (4,), minval=-0.05, maxval=0.05)


# the masked rollout reads "any episode alive" on the host every this
# many steps: a read waits for the card, and a few steps past the last
# episode's end change no length
MASK_CHECK_EVERY = 10


def rollout_population(genome, episode_keys: torch.Tensor,
                       masked: bool = False) -> torch.Tensor:
    """Episode lengths ``(pop, episodes)`` float32 of every individual of a
    population genome (leaves ``(pop, ...)``) from every start of
    ``episode_keys`` ``(episodes, w)``: ``MAX_STEPS`` steps of the whole
    batch, an episode's length the steps it stayed within the limits.
    ``masked`` stops once every episode has ended (the JAX example's
    ``rollout_masked``): the same lengths, fewer steps while policies
    are weak.

    The emulated FMAs run under :func:`~deap_tpu_torch._xla_math.
    deferred_rounding`: each step checks its sums in bulk, and the one
    host read at the end says whether every rounding was exact; if not,
    the rollout runs again with every FMA corrected.  Both give the same
    lengths."""
    with deferred_rounding() as rounding:
        steps = _rollout(genome, episode_keys, masked, rounding.check)
    if rounding.exact():
        return steps
    return _rollout(genome, episode_keys, masked, lambda: None)


def _rollout(genome, episode_keys, masked, after_step):
    # an episode axis on every leaf; the weights widened once for the
    # exact products of the policy's sums
    g = {k: v.unsqueeze(1).double() if k[0] == "w" else v.unsqueeze(1)
         for k, v in genome.items()}
    state0 = _initial_states(episode_keys)
    pop = genome["w1"].shape[0]
    state = state0.unsqueeze(0).expand((pop,) + tuple(state0.shape))
    alive = torch.ones(state.shape[:-1], dtype=torch.bool,
                       device=state.device)
    steps = torch.zeros(state.shape[:-1], dtype=torch.int32,
                        device=state.device)
    for t in range(MAX_STEPS):
        if masked and t % MASK_CHECK_EVERY == 0 and not bool(alive.any()):
            break
        # a live episode's pole is within 12 degrees (0.21 rad), so its
        # sine and cosine take glibc's branch without reduction; the
        # values of ended episodes are never read
        state = _env_step(state, policy_action(g, state), sincos_small)
        after_step()
        alive = alive & _alive(state)
        steps += alive
    return steps.to(torch.float32)


def _one(genome, key, masked: bool) -> torch.Tensor:
    batch = {k: v.unsqueeze(0) for k, v in genome.items()}
    return rollout_population(batch, key.unsqueeze(0), masked)[0, 0]


def rollout(genome, key: torch.Tensor) -> torch.Tensor:
    """Episode length (survival steps, max 500) of one individual from the
    random start of ``key``."""
    return _one(genome, key, False)


def rollout_masked(genome, key: torch.Tensor) -> torch.Tensor:
    """:func:`rollout`'s length, stepping only until the episode ends."""
    return _one(genome, key, True)


def make_evaluate(episode_keys: torch.Tensor, masked: bool = False):
    """``evaluate(genome) -> (mean episode length,)`` of one individual,
    with a population-level ``.batched`` form (one call evaluates the
    whole population, as :func:`~deap_tpu_torch.algorithms.
    evaluate_population` prefers)."""

    def evaluate_batched(genome):
        return (row_mean(rollout_population(genome, episode_keys, masked)),)

    def evaluate(genome):
        batch = {k: v.unsqueeze(0) for k, v in genome.items()}
        return (evaluate_batched(batch)[0][0],)

    return batched_op(evaluate, evaluate_batched)


# -- variation on pytree genomes --------------------------------------------


def _leaf_keys(key: torch.Tensor, g) -> list:
    """One key a leaf, in ``jax.tree_util`` order, from
    ``split(key, n_leaves)`` (for a key batch ``(n, w)``, ``(n, w)`` keys a
    leaf)."""
    n = len(base._leaves(g))
    keys = random.split(key, n)
    return [keys[..., i, :] for i in range(n)]


def _like(g, leaves: list):
    """A tree of ``g``'s structure holding ``leaves`` (in tree order)."""
    it = iter(leaves)
    return base._map(lambda _: next(it), g)


def _blend(u, a, b, alpha: float):
    """BLX-alpha on uniforms ``u``: ``gamma = (1 + 2 alpha) u - alpha`` and
    the two symmetric blends ``(1 - gamma) a + gamma b`` and ``gamma a +
    (1 - gamma) b``, each with its product of ``a`` fused into the add,
    as XLA's CPU backend compiles them inside the generation loop."""
    gamma = fma(u, _f32(1.0 + 2.0 * alpha), -_f32(alpha))
    rest = 1.0 - gamma
    return fma(rest, a, gamma * b), fma(gamma, a, rest * b)


def _blend_trees(keys: list, g1, g2, alpha: float, rows: int):
    pairs = [_blend(random.uniform(k, a.shape[rows:]), a, b, alpha)
             for k, a, b in zip(keys, base._leaves(g1), base._leaves(g2))]
    return (_like(g1, [p[0] for p in pairs]),
            _like(g1, [p[1] for p in pairs]))


def mate_blend(key, g1, g2, alpha: float = 0.5):
    """Leaf-wise BLX-alpha blend of two individuals (the pytree form of
    ``cx_blend``): leaf ``i`` draws from ``split(key, n_leaves)[i]``."""
    return _blend_trees(_leaf_keys(key, g1), g1, g2, alpha, 0)


def _mate_blend_batched(key, g1, g2, alpha: float = 0.5):
    """:func:`mate_blend` over ``n`` pairs of rows with one key: row ``r``
    takes ``split(key, n)[r]``, as jax's ``vmap`` over per-row keys."""
    n = base._leaves(g1)[0].shape[0]
    return _blend_trees(_leaf_keys(random.split(key, n), g1), g1, g2,
                        alpha, 1)


batched_op(mate_blend, _mate_blend_batched)


def _gauss_scale(sigma: float) -> float:
    # sigma times normal's float32 sqrt(2), folded into one constant
    return _f32(np.float32(sigma) * np.float32(random.SQRT2))


def _noise_trees(keys: list, g, sigma: float, rows: int):
    """``w + erf_inv(u) * (sigma * sqrt(2))`` a leaf.  Inside the
    generation loop XLA's CPU backend fuses the add into an FMA under
    threefry2x32 keys; under rbg keys its fused loop computes the noise
    in another basic block than the add (after the crossover's branch),
    so the product is rounded on its own."""
    c = _gauss_scale(sigma)
    fused = random.impl_of(keys[0]) != "rbg"
    out = []
    for k, a in zip(keys, base._leaves(g)):
        e = random.normal_erf_inv(k, a.shape[rows:])
        out.append(fma(e, c, a) if fused else a + e * c)
    return _like(g, out)


def mut_gaussian_tree(key, g, sigma: float = SIGMA):
    """Add ``N(0, sigma)`` noise to every weight: leaf ``i`` draws from
    ``split(key, n_leaves)[i]`` (the float32 forms of
    :func:`_noise_trees`)."""
    return _noise_trees(_leaf_keys(key, g), g, sigma, 0)


def _mut_gaussian_tree_batched(key, g, sigma: float = SIGMA):
    """:func:`mut_gaussian_tree` over ``n`` rows with one key: row ``r``
    takes ``split(key, n)[r]``, as jax's ``vmap`` over per-row keys."""
    n = base._leaves(g)[0].shape[0]
    return _noise_trees(_leaf_keys(random.split(key, n), g), g, sigma, 1)


batched_op(mut_gaussian_tree, _mut_gaussian_tree_batched)


def init_population(key, pop_size: int):
    """``pop_size`` random policies: row ``r`` splits ``split(key,
    pop_size)[r]`` into the keys of ``w1`` and ``w2`` (weights ``0.5 *
    N(0, 1)``); the biases start at zero."""
    keys = random.split(random.split(key, pop_size))
    dev = key.device
    return {
        "w1": 0.5 * random.normal(keys[:, 0], (4, HIDDEN)),
        "b1": torch.zeros((pop_size, HIDDEN), dtype=torch.float32,
                          device=dev),
        "w2": 0.5 * random.normal(keys[:, 1], (HIDDEN, 2)),
        "b2": torch.zeros((pop_size, 2), dtype=torch.float32, device=dev),
    }


def main(seed: int = 42, ngen: int = NGEN, pop_size: int = POP,
         verbose: bool = True, device=None):
    """The JAX example's run: ``ea_simple`` with blend crossover, Gaussian
    weight mutation, ``sel_tournament(tournsize=3)``, ``Statistics`` (max,
    avg) and ``HallOfFame(1)``, from ``PRNGKey(seed)`` of the default key
    implementation (``random.default_impl("rbg")`` for the bench's).
    Returns the best mean episode length."""
    key = random.PRNGKey(seed, device=device)
    key, k_init, k_eps = random.split(key, 3)
    episode_keys = random.split(k_eps, N_EPISODES)

    tb = base.Toolbox()
    tb.register("evaluate", make_evaluate(episode_keys))
    tb.register("mate", mate_blend)
    tb.register("mutate", mut_gaussian_tree)
    tb.register("select", selection.sel_tournament, tournsize=3)

    genome = init_population(k_init, pop_size)
    pop = base.Population(genome, base.Fitness.empty(
        pop_size, (1.0,), device=key.device))

    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("avg", row_mean)
    hof = HallOfFame(1)

    pop, logbook = algorithms.ea_simple(
        key, pop, tb, cxpb=CXPB, mutpb=MUTPB, ngen=ngen,
        stats=stats, halloffame=hof, verbose=verbose)

    best = float(np.max(np.asarray(logbook.select("max"))))
    if verbose:
        print(f"best mean episode length: {best:.1f} / {MAX_STEPS}")
    return best
