"""The port's neuroevolution example (BASELINE config 5) against
``examples/ga/evopole.py``, piece by piece.

* A dict genome's leaves go in ``jax.tree_util`` order (sorted keys) in
  the port's ``base._leaves``/``_map``; a leaf-wise keyed operator on a
  dict built in another order draws each leaf's key as JAX does.
* ``_xla_math.tanh`` is jitted ``jnp.tanh`` bit for bit over every class
  of float32; ``_xla_math.sincos_small`` (the rollout's) is ``sincos``
  below 0.75.
* ``env_step`` and the policy are bitwise on random states, teacher
  forced; a 500-step rollout of a few genomes gives JAX's episode
  lengths, masked or not.
* ``init_population``, the blend (``mate_blend``, ``ops.crossover.
  cx_blend``) and ``mut_gaussian_tree`` are bitwise.  Each is compiled by
  XLA into different float32 forms depending on what it is fused with:
  jitted alone they are compared here under threefry2x32 keys (and
  ``cx_blend`` under both); inside the generation loop, under both key
  implementations, ``tests/test_torch_evopole_slice.py`` holds them.

Tolerance 0 everywhere: every float32 operation is XLA's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu.ops import crossover as jcx
from deap_tpu_torch import _xla_math as xm
from deap_tpu_torch import base as tbase, interop, random as tr
from deap_tpu_torch.examples.ga import evopole as T
from deap_tpu_torch.ops import crossover as tcx
from examples.ga import evopole as E

torch.set_num_threads(1)

RBG = np.asarray([0, 42, 0, 42], np.uint32)          # PRNGKey(42), rbg
THREEFRY = np.asarray([0, 42], np.uint32)


def _keys(words):
    impl = "rbg" if len(words) == 4 else "threefry2x32"
    return (jax.random.wrap_key_data(jnp.asarray(words), impl=impl),
            interop.key_to_torch(words, device="cpu"))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _genomes(n, seed=0, scale=1.0):
    """Random policies, the dict built in the example's insertion order
    (``w1, b1, w2, b2``), not the sorted one."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (4, T.HIDDEN), "b1": (T.HIDDEN,), "w2": (T.HIDDEN, 2),
              "b2": (2,)}
    return {k: (scale * rng.standard_normal((n,) + s)).astype(np.float32)
            for k, s in shapes.items()}


def _balancing(n=6):
    """Three hand-set balancing controllers (the first hidden unit reads
    ``x, x_dot, theta, theta_dot``; the action is its sign) that last
    all 500 steps, then random policies that fall early."""
    g = _genomes(n, seed=4, scale=0.3)
    g["b1"][:], g["b2"][:] = 0.0, 0.0
    for i, c in enumerate([(0.05, 0.5, 10, 2), (0.0, 0.3, 8, 1.5),
                           (0.1, 1.0, 20, 3)]):
        g["w1"][i, :, 0] = c
        g["w2"][i, 0] = (-1.0, 1.0)
    return g


def _torch(g):
    return {k: torch.from_numpy(v.copy()) for k, v in g.items()}


def test_dict_leaves_follow_jax_tree_util_order():
    g = _genomes(3)
    assert list(g) == ["w1", "b1", "w2", "b2"]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]
    got = tbase._leaves(_torch(g))
    assert [x.shape for x in got] == [x.shape for x in want]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got, want))
    seen = []
    out = tbase._map(lambda x: seen.append(x.shape) or x, _torch(g))
    assert seen == [x.shape for x in want]
    assert set(out) == set(g)
    assert all(np.array_equal(out[k].numpy(), g[k]) for k in g)


def test_leafwise_keyed_operator_on_a_dict_genome_matches_jax():
    """Would have caught the insertion-order fault: each leaf takes its
    key from ``split(row_key, 4)`` in sorted order."""
    g = _genomes(16, seed=1)
    jk, tk = _keys(THREEFRY)
    want = jax.jit(jax.vmap(E.mut_gaussian_tree))(
        jax.random.split(jk, 16), g)
    got = T.mut_gaussian_tree.batched(tk, _torch(g))
    assert list(got) == list(want)               # sorted, as jax's
    for k in g:
        assert _same(want[k], got[k].numpy()), k
    one = T.mut_gaussian_tree(tr.split(tk, 16)[3],
                              {k: v[3] for k, v in _torch(g).items()})
    for k in g:
        assert _same(want[k][3], one[k].numpy()), k


def test_tanh_is_jitted_jnp_tanh():
    rng = np.random.default_rng(0)
    x = np.concatenate(
        [rng.standard_normal(1 << 16).astype(np.float32) * s
         for s in (1e-4, 1e-2, 1.0, 5.0, 30.0)]
        + [np.arange(0, 0x7F800000, 4099, dtype=np.uint32).view(np.float32),
           np.float32([0.0, -0.0, 4e-4, -4e-4, 7.998811721801758, 8.0,
                       19.999, 20.0, -20.0, np.inf, -np.inf, np.nan])])
    x = np.concatenate([x, -x])
    want = np.asarray(jax.jit(jnp.tanh)(x))
    got = xm.tanh(torch.from_numpy(x)).numpy()
    same = (want.view(np.uint32) == got.view(np.uint32)) | (
        np.isnan(want) & np.isnan(got))
    assert same.all(), x[~same][:5]


def test_sincos_small_is_sincos_below_three_quarters():
    """The rollout's sine and cosine (live episodes keep |theta| < 0.21):
    glibc's branch without reduction, bitwise to ``sincos`` on every
    4099th float32 of |y| < 0.75, NaN from 0.75 on."""
    b = np.arange(0, 0x3F400000, 4099, dtype=np.uint32).view(np.float32)
    y = torch.from_numpy(np.concatenate([b, -b]))
    want, got = xm.sincos(y), xm.sincos_small(y)
    for w, g in zip(want, got):
        assert torch.equal(w.view(torch.int32), g.view(torch.int32))
    far = xm.sincos_small(torch.tensor([0.75, -0.8, 100.0, float("inf")]))
    assert all(bool(v.isnan().all()) for v in far)


def test_deferred_rounding_flags_a_double_rounding():
    """``(1 + 2^-12) * 2^-24 (1 - 2^-12 + 2^-24) + 1`` is ``1 + 2^-24 +
    2^-60``: its float64 sum is the float32 midpoint ``1 + 2^-24``, which
    rounds to 1, while the exact FMA gives ``1 + 2^-23``.  Deferred, the
    straight rounding is kept and the check reports it; a sum with no
    such case checks exact."""
    a = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1 - 2.0 ** -12 + 2.0 ** -24)],
                     dtype=torch.float32)
    assert float(xm.fma(a, b, 1.0)) == 1 + 2.0 ** -23
    with xm.deferred_rounding() as rounding:
        straight = xm.fma(a, b, 1.0)
        fine = xm.fma(torch.tensor([0.5]), torch.tensor([3.0]), 1.0)
    assert float(straight) == 1.0 and float(fine) == 2.5
    assert not rounding.exact()
    with xm.deferred_rounding() as rounding:
        xm.fma(torch.tensor([0.5]), torch.tensor([3.0]), 1.0)
    assert rounding.exact()


def test_rollout_reruns_exactly_when_the_check_fails(monkeypatch):
    g = _torch(_balancing(3))
    keys = tr.split(tr.PRNGKey(5, impl="rbg", device="cpu"), 2)
    want = T.rollout_population(g, keys, masked=True)
    monkeypatch.setattr(xm.DeferredRounding, "exact", lambda self: False)
    assert torch.equal(T.rollout_population(g, keys, masked=True), want)


def test_env_step_and_policy_teacher_forced():
    rng = np.random.default_rng(2)
    n = 4096
    state = (rng.standard_normal((n, 4)) * [1.0, 2.0, 0.1, 2.0]
             ).astype(np.float32)
    action = rng.integers(0, 2, n).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(E.env_step))(state, action))
    got = T.env_step(torch.from_numpy(state), torch.from_numpy(action))
    assert _same(want, got.numpy())
    g = _genomes(n, seed=3)
    want = np.asarray(jax.jit(jax.vmap(E.policy_action))(g, state))
    got = T.policy_action(_torch(g), torch.from_numpy(state)).numpy()
    assert np.array_equal(want, got)
    assert 0.2 < got.mean() < 0.8


@pytest.mark.parametrize("words", [RBG, THREEFRY])
def test_rollouts_of_a_few_genomes_match_jax(words):
    """Six policies x 4 episodes x 500 steps: the episode lengths are
    JAX's (three policies balance the pole for up to all 500 steps, the
    others drop it early); the masked rollout, which stops once every
    episode has ended, gives the same lengths, and so does one episode
    from one key."""
    jk, tk = _keys(words)
    g = _balancing()
    jeps = jax.random.split(jk, T.N_EPISODES)
    teps = tr.split(tk, T.N_EPISODES)
    want = np.asarray(jax.jit(jax.vmap(
        lambda gg: jax.vmap(lambda k: E.rollout(gg, k))(jeps)))(g))
    got = T.rollout_population(_torch(g), teps).numpy()
    assert _same(want, got)
    assert got[:3].max() == T.MAX_STEPS and got[3:].max() < T.MAX_STEPS
    falling = {k: v[3:] for k, v in _torch(g).items()}
    assert _same(T.rollout_population(falling, teps, masked=True).numpy(),
                 got[3:])
    # one episode from one key: under rbg its start is that key's first
    # four words, not the batch's row (jax's vmap reads the first key)
    one = {k: v[4] for k, v in g.items()}
    want_one = jax.jit(E.rollout_masked)(one, jeps[2])
    got_one = T.rollout_masked(_torch(one), teps[2])
    assert float(got_one) == float(want_one)


@pytest.mark.parametrize("words", [RBG, THREEFRY])
def test_init_population_bitwise(words):
    jk, tk = _keys(words)
    want = jax.jit(E.init_population, static_argnums=1)(jk, 32)
    got = T.init_population(tk, 32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same(want[k], got[k].numpy()), k


def test_mate_blend_alone_bitwise():
    """``jax.jit(jax.vmap(mate_blend))``: jitted alone XLA fuses each
    child's product with ``gamma``; the loop's form fuses the other one
    (``T._blend``), so this form is spelled out here."""
    g1, g2 = _genomes(8, seed=5), _genomes(8, seed=6)
    jk, tk = _keys(THREEFRY)
    want = jax.jit(jax.vmap(E.mate_blend))(jax.random.split(jk, 8), g1, g2)
    keys = T._leaf_keys(tr.split(tk, 8), _torch(g1))
    for i, k in enumerate(sorted(g1)):
        a, b = _torch(g1)[k], _torch(g2)[k]
        gamma = xm.fma(tr.uniform(keys[i], a.shape[1:]), 2.0, -0.5)
        rest = 1.0 - gamma
        assert _same(want[0][k], xm.fma(gamma, b, rest * a).numpy()), k
        assert _same(want[1][k], xm.fma(gamma, a, rest * b).numpy()), k


@pytest.mark.parametrize("words", [RBG, THREEFRY])
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_cx_blend_bitwise(words, alpha):
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((64, 37)).astype(np.float32)
            for _ in range(2))
    jk, tk = _keys(words)
    want = jax.jit(jcx.cx_blend, static_argnums=3)(jk, a, b, alpha)
    got = tcx.cx_blend(tk, torch.from_numpy(a), torch.from_numpy(b), alpha)
    assert _same(want[0], got[0].numpy()) and _same(want[1], got[1].numpy())
    assert tcx.cx_blend.batched is tcx.cx_blend
