"""The port's rest of multi-objective against jitted JAX, piece by piece:
``random.permutation``, the ``base`` helpers, ``sel_tournament_dcd``,
NSGA-III (``uniform_reference_points``, the intercept solve, the niche
association, ``sel_nsga3``, ``SelNSGA3WithMemory``), SPEA2 (both
``kth_method``s, ``sel_spea2_staged``, the fill, exact and truncation
branches), the K4-strength identity, the epsilon indicators, the
constraint penalties and the probe tool's permutation tables.

Tolerances: integers (permutations, winners, ranks, niches, selected
indices, counts) bit for bit; floats bit for bit (intercepts and niche
distances up to 4 objectives, SPEA2's fitness) except where stated:
the intercept solve at 5 and 8 objectives within 2 ulp (jax's OpenBLAS
``sgetrf`` takes another path there), and ``ClosestValidPenalty``
within rtol 1e-6 (XLA compiles the sums of squares of the wrapped
evaluation and of its distance as a fused or an unfused sum depending on
the shape).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, benchmarks as jbench
from deap_tpu.algorithms import evaluate_population as jevaluate
from deap_tpu.ops import constraint as jcon, emo as jemo
from deap_tpu.ops import indicator as jind
from deap_tpu_torch import base as tbase, benchmarks as tbench, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch._xla_math import row_sum
from deap_tpu_torch.algorithms import evaluate_population as tevaluate
from deap_tpu_torch.ops import constraint as tcon, emo as temo
from deap_tpu_torch.ops import dominance as tdom, indicator as tind
from deap_tpu_torch.probes import ga as tprobe

torch.set_num_threads(1)

IMPLS = ["threefry2x32", "rbg"]
# seeds whose first shuffle round at n = 4097 draws two equal sort keys
COLLIDING_SEED = {"threefry2x32": 217, "rbg": 72}


def _jkey(seed, impl):
    if impl == "rbg":
        return jax.random.key_data(jax.random.key(seed, impl="rbg"))
    return jax.random.PRNGKey(seed)


def _tkey(jk):
    return interop.key_to_torch(np.asarray(jk), device="cpu")


def _wrap(jk):
    """A typed rbg key for JAX's samplers (raw words are threefry)."""
    jk = np.asarray(jk)
    return jax.random.wrap_key_data(jk, impl="rbg") if jk.shape[-1] == 4 \
        else jnp.asarray(jk)


def _fits(vals, valid=None, weights=None):
    n, m = vals.shape
    valid = np.ones(n, bool) if valid is None else valid
    weights = weights or (-1.0,) * m
    return (jbase.Fitness(jnp.asarray(vals), jnp.asarray(valid), weights),
            tbase.Fitness(torch.from_numpy(vals.copy()),
                          torch.from_numpy(valid.copy()), weights))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _ulps(a, b):
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def _front(rng, n, m):
    """Points on DTLZ2's (m = 3) or ZDT1's (m = 2) front: every one
    nondominated."""
    x = rng.uniform(0, 1, (n, m - 1)).astype(np.float32)
    if m == 2:
        return np.stack([x[:, 0], 1 - np.sqrt(x[:, 0])], 1).astype(np.float32)
    th = x * np.float32(np.pi / 2)
    return np.stack([np.cos(th[:, 0]) * np.cos(th[:, 1]),
                     np.cos(th[:, 0]) * np.sin(th[:, 1]),
                     np.sin(th[:, 0])], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# random.permutation
# ---------------------------------------------------------------------------

_perm = jax.jit(jax.random.permutation, static_argnums=1)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [1, 2, 64, 1000, 4097])
def test_permutation_is_bitwise_to_jax(impl, n):
    jk = _jkey(n, impl)
    want = np.asarray(_perm(_wrap(jk), n))
    got = tr.permutation(_tkey(jk), n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert tr._shuffle_rounds(n) == (2 if n > 1625 else int(n > 1))


@pytest.mark.parametrize("impl", IMPLS)
def test_permutation_keeps_colliding_sort_keys_in_order(impl):
    """A key whose first round draws two equal 32-bit sort keys: the
    stable sort keeps the pair in place, as ``lax.sort_key_val`` does."""
    n = 4097
    jk = _jkey(COLLIDING_SEED[impl], impl)
    sub = tr.split(_tkey(jk))[1]
    assert torch.unique(tr.bits(sub, (n,))).numel() < n
    want = np.asarray(_perm(_wrap(jk), n))
    assert np.array_equal(tr.permutation(_tkey(jk), n).numpy(), want)


def test_shuffle_of_rows_is_bitwise_to_jax():
    x = np.random.default_rng(0).uniform(size=(300, 3)).astype(np.float32)
    jk = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(jax.random.permutation)(jk, x))
    got = tr.shuffle(_tkey(jk), torch.from_numpy(x))
    assert _bits_equal(got.numpy(), want)


def test_probe_tool_permutation_tables_are_the_jax_tools():
    """``gidx`` and ``lookup`` of the GA probe tool at its POP (2**20)."""
    pop = tprobe.POP
    kp, ko = jax.random.split(jax.random.PRNGKey(0))
    assert np.array_equal(tprobe.gidx_table(pop, "cpu").numpy(),
                          np.asarray(_perm(ko, pop)))
    assert np.array_equal(tprobe.lookup_table(pop, "cpu").numpy(),
                          np.asarray(_perm(jax.random.PRNGKey(0), pop)))


# ---------------------------------------------------------------------------
# base helpers
# ---------------------------------------------------------------------------


def test_base_helpers_equal_jax():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 3, (40, 3)).astype(np.float32)
    w[5] = w[6]
    w[7, 1] = -np.inf
    tw = torch.from_numpy(w)
    assert _bits_equal(
        tbase.wvalues_of(tw, (1.0, -1.0, 2.0)).numpy(),
        jbase.wvalues_of(jnp.asarray(w), (1.0, -1.0, 2.0)))
    assert np.array_equal(tbase.dominance_matrix(tw).numpy(),
                          np.asarray(jbase.dominance_matrix(jnp.asarray(w))))
    assert np.array_equal(tbase.lex_cmp_matrix(tw).numpy(),
                          np.asarray(jbase.lex_cmp_matrix(jnp.asarray(w))))
    blocks = w.reshape(4, 10, 3)
    for axis, t in ((0, blocks.transpose(1, 0, 2)), (1, blocks)):
        want = np.asarray(jbase.lex_argmax(jnp.asarray(t), axis=axis))
        got = tbase.lex_argmax(torch.from_numpy(np.ascontiguousarray(t)),
                               axis=axis).numpy()
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# sel_tournament_dcd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,m,k", [(64, 2, 64), (100, 3, 37), (257, 2, 300)])
def test_sel_tournament_dcd_is_bitwise_to_jax(impl, n, m, k):
    rng = np.random.default_rng(n)
    vals = rng.uniform(0, 1, (n, m)).astype(np.float32)
    vals[:8] = vals[8:16]                        # crowding ties
    valid = np.ones(n, bool)
    valid[-3:] = False
    jf, tf = _fits(vals, valid)
    jk = _jkey(k, impl)
    want = jax.jit(lambda key, f: jemo.sel_tournament_dcd(key, f, k))(
        _wrap(jk), jf)
    assert np.array_equal(temo.sel_tournament_dcd(_tkey(jk), tf, k).numpy(),
                          np.asarray(want))


# ---------------------------------------------------------------------------
# NSGA-III
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nobj,p,scaling", [(2, 99, None), (3, 12, None),
                                            (4, 5, 0.5), (5, 4, None)])
def test_uniform_reference_points_equal(nobj, p, scaling):
    np.testing.assert_array_equal(
        temo.uniform_reference_points(nobj, p, scaling),
        jemo.uniform_reference_points(nobj, p, scaling))


_solve = jax.jit(jax.vmap(lambda a: jnp.linalg.solve(
    a + 1e-12 * jnp.eye(a.shape[0]), jnp.ones(a.shape[0]))))


def _matrices(m, seed):
    rng = np.random.default_rng(seed)
    mats = rng.uniform(-1, 1, (200, m, m)).astype(np.float32)
    mats[100:] = (np.eye(m) * rng.uniform(0.5, 2, (100, m, 1))
                  + rng.uniform(0, 0.05, (100, m, m))).astype(np.float32)
    return mats


def _port_solve(mats):
    eye = np.eye(mats.shape[1], dtype=np.float32) * np.float32(1e-12)
    return np.stack([temo._solve_ones(torch.from_numpy(a + eye)).numpy()
                     for a in mats])


@pytest.mark.parametrize("m", [2, 3, 4])
def test_intercept_solve_is_bitwise_to_lapack(m):
    mats = _matrices(m, m)
    assert _bits_equal(_port_solve(mats), _solve(jnp.asarray(mats)))


@pytest.mark.parametrize("m", [5, 8])
def test_intercept_solve_within_two_ulp_past_four_objectives(m):
    mats = _matrices(m, m)[100:]                 # extreme points: near-diagonal
    assert _ulps(_port_solve(mats), _solve(jnp.asarray(mats))).max() <= 2


def test_intercepts_fall_back_to_the_worst_point():
    extreme = np.array([[1.0, 0.0], [2.0, 0.0]], np.float32)   # singular
    obj = np.array([[0.5, 3.0], [1.0, 0.25], [4.0, 1.0]], np.float32)
    cand = np.array([True, True, False])
    want = jax.jit(jemo._find_intercepts)(extreme, obj, cand)
    got = temo._find_intercepts(*(torch.from_numpy(x) for x in
                                  (extreme, obj, cand)))
    assert _bits_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), [1.0, 3.0])


@pytest.mark.parametrize("nobj,p", [(2, 99), (3, 12), (4, 5)])
def test_niche_association_is_bitwise_in_both_forms(nobj, p):
    """Constant reference points (their norms folded, a reciprocal
    multiply) and traced ones (fused norms, a division) are two float
    forms; each is bitwise to its JAX compile, and they differ."""
    rng = np.random.default_rng(nobj)
    rp = jemo.uniform_reference_points(nobj, p)
    obj = rng.uniform(0, 2, (2000, nobj)).astype(np.float32)
    ideal = obj.min(0)
    inter = (obj.max(0) - ideal).astype(np.float32)
    const = jax.jit(lambda o, i, t: jemo._associate_to_niche(o, rp, i, t))
    traced = jax.jit(jemo._associate_to_niche)
    args = [torch.from_numpy(x) for x in (obj, ideal, inter)]
    rpt = torch.from_numpy(rp.astype(np.float32))
    dists = []
    for want, traced_form in ((const(obj, ideal, inter), False),
                              (traced(obj, rp.astype(np.float32), ideal,
                                      inter), True)):
        niche, dist = temo._associate_to_niche(args[0], rpt, args[1],
                                               args[2], traced_form)
        assert np.array_equal(niche.numpy(), np.asarray(want[0]))
        assert _bits_equal(dist.numpy(), want[1])
        dists.append(dist.numpy())
    assert (dists[0] != dists[1]).any()


_nsga3_cache = {}


def _jax_nsga3(k, rp, with_io, with_pe):
    key_ = (k, rp.shape, with_io, with_pe)
    if key_ not in _nsga3_cache:
        def f(key, fit, io, pe):
            return jemo.sel_nsga3(key, fit, k, rp,
                                  ideal_override=io if with_io else None,
                                  prior_extreme=pe if with_pe else None,
                                  return_memory=True)
        _nsga3_cache[key_] = jax.jit(f)
    return _nsga3_cache[key_]


@pytest.mark.parametrize("nobj,p,n,k", [(2, 12, 200, 100), (3, 12, 184, 92),
                                        (3, 6, 400, 150)])
@pytest.mark.parametrize("impl,memory", [
    ("threefry2x32", "none"), ("threefry2x32", "ideal"),
    ("threefry2x32", "extreme"), ("threefry2x32", "both"), ("rbg", "none")])
def test_sel_nsga3_is_bitwise_to_jax(impl, nobj, p, n, k, memory):
    rng = np.random.default_rng(n + nobj)
    vals = rng.uniform(0, 1, (n, nobj)).astype(np.float32)
    vals[:10] = vals[10:20]
    rp = jemo.uniform_reference_points(nobj, p)
    io = vals.min(0) - np.float32(0.05)
    pe = (np.eye(nobj) * 1.5 + 0.1).astype(np.float32)
    with_io = memory in ("ideal", "both")
    with_pe = memory in ("extreme", "both")
    jf, tf = _fits(vals)
    jk = _jkey(n + k, impl)
    want, (wi, we) = _jax_nsga3(k, rp, with_io, with_pe)(_wrap(jk), jf, io,
                                                         pe)
    got, (gi, ge) = temo.sel_nsga3(
        _tkey(jk), tf, k, rp, ideal_override=io if with_io else None,
        prior_extreme=pe if with_pe else None, return_memory=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert _bits_equal(gi.numpy(), wi) and _bits_equal(ge.numpy(), we)
    plain = temo.sel_nsga3(_tkey(jk), tf, k, rp, ideal_override=io
                           if with_io else None, prior_extreme=pe
                           if with_pe else None)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("nobj", [2, 3])
def test_sel_nsga3_degenerate_front_takes_the_worst_point(nobj):
    """Objectives at 1e14: the solve's ``x`` falls under the 1e-12 guard,
    the intercepts are not finite and the worst point replaces them."""
    rng = np.random.default_rng(nobj)
    vals = (rng.uniform(0, 1, (60, nobj)) * 1e14).astype(np.float32)
    rp = jemo.uniform_reference_points(nobj, 6)
    jf, tf = _fits(vals)
    jk = jax.random.PRNGKey(4)
    want = jax.jit(lambda key, f: jemo.sel_nsga3(key, f, 20, rp))(jk, jf)
    assert np.array_equal(temo.sel_nsga3(_tkey(jk), tf, 20, rp).numpy(),
                          np.asarray(want))
    obj_t = torch.from_numpy(vals - vals.min(0))
    everyone = torch.ones(60, dtype=torch.bool)
    extreme = temo._find_extreme_points(obj_t, everyone)
    assert torch.equal(temo._find_intercepts(extreme, obj_t, everyone),
                       obj_t.amax(0))


@pytest.mark.parametrize("nobj,p", [(2, 12), (3, 6)])
def test_nsga3_with_memory_carries_jax_state(nobj, p):
    """JAX's memory selection for two host generations, its state carried
    across by ``interop.nsga3_memory_to_torch``, then three more
    generations in both packages: indices and state bitwise."""
    rng = np.random.default_rng(nobj)
    rp = jemo.uniform_reference_points(nobj, p)
    js = jemo.SelNSGA3WithMemory(rp)
    ts = temo.SelNSGA3WithMemory(rp)
    for g in range(5):
        vals = (rng.uniform(0, 1, (120, nobj)) * (1 - 0.15 * g)).astype(
            np.float32)
        jf, tf = _fits(vals)
        jk = jax.random.PRNGKey(g)
        want = np.asarray(js(jk, jf, 60))
        if g == 2:
            ts.best_point, ts.extreme_points = interop.nsga3_memory_to_torch(
                js_state[0], js_state[1])
        if g >= 2:
            assert np.array_equal(ts(_tkey(jk), tf, 60).numpy(), want)
            assert _bits_equal(ts.best_point, js.best_point)
            assert _bits_equal(ts.extreme_points, js.extreme_points)
        js_state = (js.best_point, js.extreme_points)


def test_nsga3_memory_interop_checks_shapes():
    ideal, extreme = interop.nsga3_memory_to_torch(np.full(3, np.inf), None)
    assert ideal.dtype == np.float32 and extreme is None
    with pytest.raises(ValueError):
        interop.nsga3_memory_to_torch(np.zeros(3), np.zeros((2, 3)))


# ---------------------------------------------------------------------------
# SPEA2
# ---------------------------------------------------------------------------


def _spea2_case(case, m, rng):
    n = 240
    if case == "fill":
        return rng.uniform(0, 1, (n, m)).astype(np.float32), 80
    vals = _front(rng, n, m)
    vals[:12] = vals[12:24]                      # duplicated points
    return vals, (96 if case == "truncation" else n)


_spea2_cache = {}


def _jax_spea2(k, chunk, how):
    key_ = (k, chunk, how)
    if key_ not in _spea2_cache:
        if how == "staged":
            _spea2_cache[key_] = lambda f: jemo.sel_spea2_staged(None, f, k,
                                                                 chunk)
        else:
            _spea2_cache[key_] = jax.jit(lambda f: jemo.sel_spea2(
                None, f, k, chunk=chunk, kth_method=how))
    return _spea2_cache[key_]


@pytest.mark.parametrize("case", ["fill", "exact", "truncation"])
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("how,chunk", [("blocked", 7), ("blocked", 1024),
                                       ("bisect", 1024), ("staged", 7)])
def test_sel_spea2_is_bitwise_to_jax(case, m, chunk, how):
    rng = np.random.default_rng(m * 10 + len(case))
    vals, k = _spea2_case(case, m, rng)
    jf, tf = _fits(vals)
    n_nondom = int((np.asarray(jemo.nondominated_ranks(
        jf.masked_wvalues())[0]) == 0).sum())
    assert {"fill": n_nondom < k, "exact": n_nondom == k,
            "truncation": n_nondom > k}[case]
    want = np.asarray(_jax_spea2(k, chunk, how)(jf))
    if how == "staged":
        got = temo.sel_spea2_staged(None, tf, k, chunk)
    else:
        got = temo.sel_spea2(None, tf, k, chunk=chunk, kth_method=how)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("how", ["blocked", "bisect"])
def test_spea2_fitness_stage_is_bitwise(how):
    """SPEA2 fitness (raw + density) and the nondominated mask, with
    duplicates: raw below 2**24, so JAX's float32 sums are exact and the
    port's exact sum rounds to them."""
    rng = np.random.default_rng(5)
    vals = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    vals[:20] = vals[20:40]
    jf, tf = _fits(vals)
    want = jax.jit(lambda w: jemo._spea2_fitness_stage(w, 64, how))(
        jf.masked_wvalues())
    got = temo._spea2_fitness_stage(tf.masked_wvalues(), 64, how)
    assert _bits_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("how", ["blocked", "bisect"])
def test_spea2_rows_past_the_candidates_take_every_column(how):
    """100 copies of one point: their nearest distances tie beyond the
    candidates the unfused distance picks, so those rows take the exact
    distance to every column; fitness and selection stay bitwise (a
    front on which the truncation runs too)."""
    rng = np.random.default_rng(6)
    vals = _front(rng, 300, 3)
    vals[:100] = vals[100]
    tw = torch.from_numpy(-vals)
    rows = torch.arange(300)
    sure = temo._nearest_candidates(tw, rows, 18)[2]
    assert not sure[:100].any() and sure[101:].any()
    jf, tf = _fits(vals)
    want = jax.jit(lambda w: jemo._spea2_fitness_stage(w, 64, how))(
        jf.masked_wvalues())
    got = temo._spea2_fitness_stage(tf.masked_wvalues(), 64, how)
    assert _bits_equal(got[0].numpy(), want[0])
    want = _jax_spea2(150, 64, how)(jf)
    got = temo.sel_spea2(None, tf, 150, chunk=64, kth_method=how)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_spea2_strength_is_k4_with_roles_swapped():
    """``strength[i] = #{j : w[i] dominates w[j]}`` equals
    ``rows_dominate_counts(-w, -w)``, with duplicates and ``-inf`` rows
    (``+inf`` once negated), against the direct count and JAX's."""
    rng = np.random.default_rng(8)
    w = -rng.integers(0, 5, (500, 3)).astype(np.float32)
    w[:30] = w[30:60]
    w[::17] = -np.inf
    tw = torch.from_numpy(w)
    nw = (-tw).contiguous()
    got = tdom.rows_dominate_counts(nw, nw)
    direct = tbase.dominance_matrix(tw).sum(1, dtype=torch.int32)
    jw = jnp.asarray(w)
    want = np.asarray(jax.jit(lambda x: jnp.sum(
        jbase.dominates(x[:, None, :], x[None, :, :]), axis=1))(jw))
    assert torch.equal(got, direct)
    assert np.array_equal(got.numpy(), want)


def test_spea2_raw_sums_are_exact_past_two_to_the_24():
    """The raw-fitness sums of large strengths, split into digits, equal
    the int64 sums exactly (here up to ~10**8, past float32's 2**24)."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.integers(0, 6, (3000, 3)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, 1 << 18, 1000))
    got = temo._weighted_dominated(w[:1000], s, w, 18)
    want = (tbase.dominance_matrix(w)[:1000].long() * s[:, None]).sum(0)
    assert want.max() > 1 << 24
    assert torch.equal(got.long(), want) and torch.equal(got, want.double())


def test_top_k_smallest_takes_lower_indices_on_ties():
    d2 = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 7.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = temo._top_k_smallest_blocked(d2, 3)
    assert idx.tolist() == [[3, 1, 2], [0, 1, 2]]
    jv, ji = jemo._top_k_smallest_blocked(jnp.asarray(d2.numpy()), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert _bits_equal(vals.numpy(), jv)


# ---------------------------------------------------------------------------
# indicators and constraints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_epsilon_indicators_equal_jax(seed):
    front = _front(np.random.default_rng(seed), 40, 2 + seed % 2) + 0.1
    wv = -front
    jf = jbase.Fitness(jnp.asarray(front), jnp.ones(40, bool),
                       (-1.0,) * front.shape[1])
    tf = tbase.Fitness(torch.from_numpy(front), torch.ones(40,
                       dtype=torch.bool), (-1.0,) * front.shape[1])
    assert tind.additive_epsilon(tf) == jind.additive_epsilon(jf)
    assert tind.multiplicative_epsilon(tf) == jind.multiplicative_epsilon(jf)
    assert tind.additive_epsilon(wv) == jind.additive_epsilon(wv)


def _penalties():
    """The penalty decorators of ``tests/test_aux.py:20-60`` in both
    packages: ``(JAX evaluate, port evaluate, rtol)``."""
    return {
        "delta": (
            jcon.DeltaPenalty(lambda g: jnp.all(jnp.abs(g) <= 1.0), 100.0,
                              weights=(-1.0,), distance=lambda g: jnp.sum(
                                  jnp.maximum(jnp.abs(g) - 1.0, 0.0)))(
                jbench.sphere),
            tcon.DeltaPenalty(lambda g: (g.abs() <= 1.0).all(), 100.0,
                              weights=(-1.0,), distance=lambda g: row_sum(
                                  torch.clamp(g.abs() - 1.0, min=0.0)))(
                tbench.sphere), 1e-6),
        "closest": (
            jcon.ClosestValidPenalty(lambda g: jnp.all(jnp.abs(g) <= 1.0),
                                     lambda g: jnp.clip(g, -1.0, 1.0),
                                     alpha=2.0, weights=(-1.0,))(
                jbench.sphere),
            tcon.ClosestValidPenality(lambda g: (g.abs() <= 1.0).all(),
                                      lambda g: torch.clamp(g, -1.0, 1.0),
                                      alpha=2.0, weights=(-1.0,))(
                tbench.sphere), 1e-6)}


@pytest.mark.parametrize("kind", ["delta", "closest"])
def test_penalties_as_test_aux_exercises_them(kind):
    jev, tev, _ = _penalties()[kind]
    if kind == "delta":
        cases = [([0.5, 0.5], 0.5), ([2.0, 0.0], 101.0)]
    else:
        cases = [([2.0, 0.0], 3.0), ([0.3, 0.4], 0.25)]
    for g, value in cases:
        got = tev(torch.tensor(g))
        np.testing.assert_allclose(got.numpy(), [value], rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jev(
            jnp.asarray(g))), rtol=1e-6)
    assert tcon.DeltaPenality is tcon.DeltaPenalty


@pytest.mark.parametrize("kind", ["delta", "closest"])
@pytest.mark.parametrize("dim", [2, 30, 100])
def test_penalties_under_evaluate_population_match_jax(kind, dim):
    """Inside ``evaluate_population``'s vmap, against the jitted JAX
    evaluation: Delta's penalties bitwise (its distance summed in XLA's
    order), every value within rtol 1e-6 (the port's ``sphere`` sums in
    torch's order)."""
    jev, tev, rtol = _penalties()[kind]
    g = np.random.default_rng(dim).uniform(-1.5, 1.5, (64, dim)).astype(
        np.float32)
    g[:8] *= np.float32(0.5)                     # some feasible rows
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    jtb.register("evaluate", jev)
    ttb.register("evaluate", tev)
    jpop, _ = jax.jit(lambda p: jevaluate(jtb, p))(jbase.Population(
        jnp.asarray(g), jbase.Fitness.empty(64, (-1.0,))))
    tpop, _ = tevaluate(ttb, tbase.Population(
        torch.from_numpy(g), tbase.Fitness.empty(64, (-1.0,), device="cpu")))
    want = np.asarray(jpop.fitness.values)
    got = tpop.fitness.values.numpy()
    if kind == "delta":
        infeasible = ~(np.abs(g) <= 1.0).all(1)
        assert _bits_equal(got[infeasible], want[infeasible])
    np.testing.assert_allclose(got, want, rtol=rtol)
