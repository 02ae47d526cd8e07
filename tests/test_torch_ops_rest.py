"""The rest of the port's GA operators against the jitted JAX ones:
the crossovers (one point, uniform, PMX, UPMX, OX, SBX, messy one
point, the ES blend and two point), the mutations (index shuffle,
uniform integer in int8 / int16 / int32, ES log-normal) and the
selections (worst, roulette, stochastic universal sampling), in the
per-row form (``jax.vmap`` over ``split`` keys; the port's ``rowwise_op``
or one call a row) and the batched one; XLA's cumulative sum; the
registered batched forms against the JAX package's; and a decorated
tool through ``var_and``.

Tolerances: every integer output (cut points, permutations, lengths,
indices) and every draw bit for bit; the float outputs bit for bit
too — SBX against the jitted ``vary_genome`` (``bench.py``'s xla body),
as in ``tests/test_torch_sbx_poly.py``, and alone.  Inputs are made with
numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import algorithms as jalg, base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import _xla_math as xm, algorithms as talg
from deap_tpu_torch import base as tbase, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel

torch.set_num_threads(1)

N, SIZE = 96, 25


def _tk(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    return [np.asarray(x) if not torch.is_tensor(x) else x.numpy()]


def _assert_bitwise(jax_out, torch_out):
    js, ts = _leaves(jax_out), _leaves(torch_out)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def _perms(seed, n=N, size=SIZE):
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.permutation(size) for _ in range(n)]).astype(np.int32)
    p2 = np.stack([rng.permutation(size) for _ in range(n)]).astype(np.int32)
    p2[:8] = p1[:8]                 # equal parents: p1[t2] == i at every step
    return p1, p2


PERM_OPS = [("cx_partialy_matched", {}),
            ("cx_uniform_partialy_matched", {"indpb": 0.4}),
            ("cx_ordered", {})]


@pytest.mark.parametrize("name,kw", PERM_OPS)
@pytest.mark.parametrize("size", [2, 25, 100])
def test_permutation_crossovers_rowwise_and_per_row(name, kw, size):
    p1, p2 = _perms(size, size=size)
    keys = jax.random.split(jax.random.PRNGKey(size), N)
    jf = getattr(jcx, name)
    want = jax.jit(jax.vmap(lambda k, a, b: jf(k, a, b, **kw)))(keys, p1, p2)
    op = getattr(tcx, name)
    assert op.rowwise
    got = op(_tk(keys), torch.from_numpy(p1), torch.from_numpy(p2), **kw)
    _assert_bitwise(want, got)
    for c in got:                           # children stay permutations
        assert (np.sort(c.numpy(), 1) == np.arange(size)).all()
    one = op(_tk(keys[3]), torch.from_numpy(p1[3]), torch.from_numpy(p2[3]),
             **kw)
    _assert_bitwise(jax.jit(lambda k, a, b: jf(k, a, b, **kw))(
        keys[3], p1[3], p2[3]), one)


def test_pmx_second_write_wins():
    """Where ``p1[t2] == i`` at an active step the later write (``t1``)
    must win: equal parents give that at every step and keep the row."""
    p1, _ = _perms(1)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    want = jax.jit(jax.vmap(jcx.cx_partialy_matched))(keys, p1, p1)
    got = tcx.cx_partialy_matched(_tk(keys), torch.from_numpy(p1),
                                  torch.from_numpy(p1))
    _assert_bitwise(want, got)
    np.testing.assert_array_equal(got[0].numpy(), p1)


def test_ox_wrapping_fill_and_drop_slot():
    """OX's fill scans cyclically from ``hi + 1``: rows whose segment
    ends at the last position wrap at once, and every row with ``nfill <
    size`` writes the drop slot; the children equal jax's."""
    p1, p2 = _perms(2, n=512)
    keys = jax.random.split(jax.random.PRNGKey(2), 512)
    k1, k2 = jax.vmap(jax.random.split)(keys).transpose(1, 0, 2)
    a = jax.vmap(lambda k: jax.random.randint(k, (), 0, SIZE))(k1)
    b = jax.vmap(lambda k: jax.random.randint(k, (), 0, SIZE - 1))(k2)
    hi = np.maximum(a, np.where(b >= a, b + 1, b))
    assert (hi == SIZE - 1).sum() > 10
    want = jax.jit(jax.vmap(jcx.cx_ordered))(keys, p1, p2)
    got = tcx.cx_ordered(_tk(keys), torch.from_numpy(p1),
                         torch.from_numpy(p2))
    _assert_bitwise(want, got)


ELEMENTWISE = [("cx_one_point", {}, np.float32),
               ("cx_one_point", {}, np.int32),
               ("cx_uniform", {"indpb": 0.1}, np.float32),
               ("cx_uniform", {"indpb": 0.1}, np.int32),
               ("cx_simulated_binary", {"eta": 20.0}, np.float32)]


@pytest.mark.parametrize("name,kw,dtype", ELEMENTWISE)
def test_elementwise_crossovers_batched_and_per_row(name, kw, dtype):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((N, 100)) * 3).astype(dtype)
    b = (rng.standard_normal((N, 100)) * 3).astype(dtype)
    key = jax.random.PRNGKey(4)
    jf, op = getattr(jcx, name), getattr(tcx, name)
    want = jax.jit(lambda k, x, y: jf.batched(k, x, y, **kw))(key, a, b)
    got = op.batched(_tk(key), torch.from_numpy(a), torch.from_numpy(b),
                     **kw)
    _assert_bitwise(want, got)
    keys = jax.random.split(key, N)
    want = jax.jit(jax.vmap(lambda k, x, y: jf(k, x, y, **kw)))(keys, a, b)
    got = [op(_tk(keys[i]), torch.from_numpy(a[i]), torch.from_numpy(b[i]),
              **kw) for i in range(N)]
    _assert_bitwise(want, tuple(torch.stack([g[j] for g in got])
                                for j in range(2)))


def test_sbx_inside_vary_genome():
    """SBX as ``bench.py``'s xla body runs it: ``vary_genome(pairing=
    "halves")`` with Gaussian mutation, jitted whole."""
    rng = np.random.default_rng(5)
    g = rng.uniform(-5.12, 5.12, (256, 100)).astype(np.float32)
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    for tb, cx, mut in ((jtb, jcx, jmut), (ttb, tcx, tmut)):
        tb.register("mate", cx.cx_simulated_binary, eta=20.0)
        tb.register("mutate", mut.mut_gaussian, mu=0.0, sigma=0.3,
                    indpb=0.05)
    key = jax.random.PRNGKey(6)
    want, wt = jax.jit(lambda k, x: jalg.vary_genome(
        k, x, jtb, 0.9, 0.5, pairing="halves"))(key, g)
    got, gt = talg.vary_genome(_tk(key), torch.from_numpy(g), ttb, 0.9, 0.5,
                               pairing="halves")
    _assert_bitwise((want, wt), (got, gt))


def _es_pairs(seed, n=N, size=30):
    rng = np.random.default_rng(seed)
    x1, x2 = (rng.standard_normal((n, size)).astype(np.float32)
              for _ in range(2))
    s1, s2 = (rng.uniform(0.5, 3, (n, size)).astype(np.float32)
              for _ in range(2))
    return (x1, s1), (x2, s2)


def _t(pair):
    return tuple(torch.as_tensor(np.asarray(v)) for v in pair)


@pytest.mark.parametrize("name,kw", [("cx_es_blend", {"alpha": 0.1}),
                                     ("cx_es_two_point", {})])
def test_es_crossovers(name, kw):
    a, b = _es_pairs(7)
    key = jax.random.PRNGKey(8)
    jf, op = getattr(jcx, name), getattr(tcx, name)
    want = jax.jit(lambda k, a, b: jf.batched(k, a, b, **kw))(key, a, b)
    _assert_bitwise(want, op.batched(_tk(key), _t(a), _t(b), **kw))
    keys = jax.random.split(key, N)
    want = jax.jit(jax.vmap(lambda k, a, b: jf(k, a, b, **kw)))(keys, a, b)
    rows = [op(_tk(keys[i]), tuple(torch.from_numpy(v[i]) for v in a),
               tuple(torch.from_numpy(v[i]) for v in b), **kw)
            for i in range(N)]
    got = tuple(tuple(torch.stack([r[c][j] for r in rows]) for j in range(2))
                for c in range(2))
    _assert_bitwise(want, got)


def test_messy_one_point_pairs_and_plain():
    p1, p2 = _perms(9, size=40)
    rng = np.random.default_rng(9)
    l1 = rng.integers(0, 41, N).astype(np.int32)
    l2 = rng.integers(0, 41, N).astype(np.int32)
    l1[:4] = 0
    l2[4:8] = 40
    keys = jax.random.split(jax.random.PRNGKey(10), N)
    want = jax.jit(jax.vmap(lambda k, a, la, b, lb: jcx.cx_messy_one_point(
        k, (a, la), (b, lb))))(keys, p1, l1, p2, l2)
    got = tcx.cx_messy_one_point(_tk(keys), _t((p1, l1)), _t((p2, l2)))
    _assert_bitwise(want, got)
    for child, length in got:                 # padding is zero
        idx = torch.arange(40)[None, :]
        assert (child[idx >= length[:, None].long()] == 0).all()
    want = jax.jit(jax.vmap(jcx.cx_messy_one_point))(keys, p1, p2)
    _assert_bitwise(want, tcx.cx_messy_one_point(
        _tk(keys), torch.from_numpy(p1), torch.from_numpy(p2)))
    one = tcx.cx_messy_one_point(_tk(keys[2]), _t((p1[2], l1[2])),
                                 _t((p2[2], l2[2])))
    _assert_bitwise(jax.jit(lambda k, a, la, b, lb: jcx.cx_messy_one_point(
        k, (a, la), (b, lb)))(keys[2], p1[2], l1[2], p2[2], l2[2]), one)


@pytest.mark.parametrize("size", [2, 25, 100])
def test_mut_shuffle_indexes(size):
    p1, _ = _perms(11, size=size)
    keys = jax.random.split(jax.random.PRNGKey(size), N)
    want = jax.jit(jax.vmap(lambda k, x: jmut.mut_shuffle_indexes(
        k, x, 0.2)))(keys, p1)
    got = tmut.mut_shuffle_indexes(_tk(keys), torch.from_numpy(p1), 0.2)
    _assert_bitwise(want, got)
    assert (np.sort(got.numpy(), 1) == np.arange(size)).all()
    _assert_bitwise(jax.jit(lambda k, x: jmut.mut_shuffle_indexes(
        k, x, 0.2))(keys[1], p1[1]),
        tmut.mut_shuffle_indexes(_tk(keys[1]), torch.from_numpy(p1[1]), 0.2))


@pytest.mark.parametrize("dtype,low,up", [
    (np.int8, -5, 20), (np.int8, 0, 127), (np.int8, -128, 127),
    (np.int8, 10, 3), (np.int8, -300, 300), (np.int16, -300, 3000),
    (np.int16, -32768, 32767), (np.int32, 0, 9), (np.int32, -7, 1 << 20)])
def test_mut_uniform_int_dtypes(dtype, low, up):
    rng = np.random.default_rng(12)
    g = rng.integers(-5, 5, (N, 50)).astype(dtype)
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda k, x: jmut.mut_uniform_int(k, x, low, up, 0.5))(
        key, g)
    got = tmut.mut_uniform_int(_tk(key), torch.from_numpy(g), low, up, 0.5)
    _assert_bitwise(want, got)
    _assert_bitwise(jax.jit(lambda k, x: jmut.mut_uniform_int(
        k, x, low, up, 0.5))(key, g[0]),
        tmut.mut_uniform_int(_tk(key), torch.from_numpy(g[0]), low, up,
                             0.5))


def test_mut_uniform_int_float_genome_raises():
    with pytest.raises(TypeError):
        jmut.mut_uniform_int(jax.random.PRNGKey(0), jnp.zeros(4), 0, 3, 0.5)
    with pytest.raises(TypeError):
        tmut.mut_uniform_int(tr.PRNGKey(0, device="cpu"), torch.zeros(4), 0,
                             3, 0.5)


def test_mut_es_log_normal_batched_and_per_row():
    (x, s), _ = _es_pairs(14, n=256)
    key = jax.random.PRNGKey(15)
    want = jax.jit(lambda k, x, s: jmut.mut_es_log_normal.batched(
        k, (x, s), c=1.0, indpb=0.3))(key, x, s)
    got = tmut.mut_es_log_normal.batched(_tk(key), _t((x, s)), c=1.0,
                                         indpb=0.3)
    _assert_bitwise(want, got)
    keys = jax.random.split(key, 256)
    want = jax.jit(jax.vmap(lambda k, x, s: jmut.mut_es_log_normal(
        k, (x, s), c=1.0, indpb=0.3)))(keys, x, s)
    rows = [tmut.mut_es_log_normal(_tk(keys[i]), _t((x[i], s[i])), c=1.0,
                                   indpb=0.3) for i in range(256)]
    _assert_bitwise(want, tuple(torch.stack([r[j] for r in rows])
                                for j in range(2)))


@pytest.mark.parametrize("n", [5, 16, 17, 40, 257, 1000, 4097, 100_000])
def test_cumsum_xla_order(n):
    x = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    _assert_bitwise(jax.jit(jnp.cumsum)(x), xm.cumsum(torch.from_numpy(x)))
    _assert_bitwise(jax.jit(jnp.sum)(x), xm.row_sum(torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["sel_worst", "sel_roulette",
                                  "sel_stochastic_universal_sampling"])
@pytest.mark.parametrize("n,k", [(37, 10), (1000, 1000), (100_000, 4096)])
def test_selections_ties_and_invalid_rows(name, n, k):
    rng = np.random.default_rng(n)
    v = rng.uniform(0, 5, (n, 2)).astype(np.float32)
    v[::7] = v[3]                               # ties
    valid = rng.uniform(size=n) > 0.1           # invalid rows read 0
    key = jax.random.PRNGKey(16)
    want = jax.jit(lambda kk, vv, va: getattr(jsel, name)(
        kk, jbase.Fitness(vv, va, (1.0, -1.0)), k))(key, v, valid)
    fit = tbase.Fitness(torch.from_numpy(v), torch.from_numpy(valid),
                        (1.0, -1.0))
    got = getattr(tsel, name)(_tk(key), fit, k)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    raw = jax.jit(lambda kk, vv: getattr(jsel, name)(kk, vv, k))(key, v)
    np.testing.assert_array_equal(np.asarray(raw), getattr(tsel, name)(
        _tk(key), torch.from_numpy(v), k).numpy())


def _exported(module):
    return {n: getattr(module, n) for n in module.__all__}


@pytest.mark.parametrize("jmod,tmod", [(jcx, tcx), (jmut, tmut),
                                       (jsel, tsel)])
def test_names_and_registered_batched_forms(jmod, tmod):
    """Every name of the JAX module's ``__all__`` is in the port's, and
    an operator has a batched form exactly where JAX's has one (its own
    function where JAX's is its own); the rest are rowwise or plain."""
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name, jf in _exported(jmod).items():
        tf = getattr(tmod, name)
        jb, tb = getattr(jf, "batched", None), getattr(tf, "batched", None)
        assert (jb is None) == (tb is None), name
        if jb is not None:
            assert (jb is jf) == (tb is tf), name
            assert tb.base_op is tf, name
    rowwise = {n for n, f in _exported(tmod).items()
               if getattr(f, "rowwise", False)}
    expected = {"cx_partialy_matched", "cx_uniform_partialy_matched",
                "cx_ordered", "cx_messy_one_point", "mut_shuffle_indexes"}
    assert rowwise == expected & set(tmod.__all__)


def test_decorated_tool_takes_the_per_row_path():
    """A decorated ``cx_blend`` / ``mut_gaussian`` (kursawefct.py's
    check_bounds) loses the batched form: ``var_and`` calls it one row
    at a time under ``split`` keys, as jax's vmap over the wrapper."""
    def check_bounds_j(op):
        def wrapped(key, *args, **kw):
            out = op(key, *args, **kw)
            return tuple(jnp.clip(o, -5.0, 5.0) for o in out) \
                if isinstance(out, tuple) else jnp.clip(out, -5.0, 5.0)
        return wrapped

    def check_bounds_t(op):
        def wrapped(key, *args, **kw):
            out = op(key, *args, **kw)
            return tuple(torch.clamp(o, -5.0, 5.0) for o in out) \
                if isinstance(out, tuple) else torch.clamp(out, -5.0, 5.0)
        return wrapped

    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    for tb, cx, mut, dec in ((jtb, jcx, jmut, check_bounds_j),
                             (ttb, tcx, tmut, check_bounds_t)):
        tb.register("mate", cx.cx_blend, alpha=1.5)
        tb.register("mutate", mut.mut_gaussian, mu=0.0, sigma=3.0,
                    indpb=0.3)
        tb.decorate("mate", dec)
        tb.decorate("mutate", dec)
    assert talg._batched_form(ttb.mate) is None
    assert talg._batched_form(ttb.mutate) is None
    g = np.random.default_rng(17).uniform(-5, 5, (64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(18)
    want = jax.jit(lambda k, x: jalg.vary_genome(k, x, jtb, 0.5, 0.3))(key, g)
    got = talg.vary_genome(_tk(key), torch.from_numpy(g), ttb, 0.5, 0.3)
    _assert_bitwise(want, got)
