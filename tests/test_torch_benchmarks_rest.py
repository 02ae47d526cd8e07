"""The rest of the port's benchmark functions against the jitted JAX
ones: the 28 continuous functions, ``binary.py``, ``movingpeaks.py``
and the evaluation decorators of ``benchmarks/tools.py``.

Tolerances.  Each function is compared with ``jax.jit(jax.vmap(f))``
on 2048 individuals made with numpy from a seed, bit for bit except the
cases in ``ULP_BOUND``: there each objective is held to the largest gap
measured on these inputs, in float32 units in the last place.  Those
are the loops whose transcendental calls XLA's CPU backend scalarizes
inside a vectorized row loop, where its contractions and
reassociation around the calls were not reproduced (the machine code
of the other forms was read and is matched: rosenbrock, schwefel,
DTLZ1 / DTLZ3's ``1 + g``, the subnormal flush of DTLZ4's integer
power), and 2 of 2048 rows of DTLZ7's last objective.  ``rotate``'s
inverse is a LAPACK call on both sides and its product an XLA dot
against ``torch.matmul``: ``ROTATE_ULP``.  Integer outputs (binary
functions, the moving peaks' active masks) and every draw are bit for
bit; the moving peaks (all three scenarios and the fluctuating mode)
bit for bit over 20 ``change_peaks_state`` calls.
"""

import math

import numpy as np
import pytest
import torch

import jax

from deap_tpu import benchmarks as jb
from deap_tpu.benchmarks import binary as jbin, movingpeaks as jmp
from deap_tpu.benchmarks import tools as jtools
from deap_tpu_torch import benchmarks as tb, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.benchmarks import binary as tbin, movingpeaks as tmp
from deap_tpu_torch.benchmarks import tools as ttools

torch.set_num_threads(1)

N = 2048
ROTATE_ULP = 5

ANY_DIM = ["plane", "cigar", "rosenbrock", "bohachevsky", "griewank",
           "rastrigin_scaled", "rastrigin_skew", "schaffer", "schwefel",
           "kursawe"]
# name: (keywords, shape, low, high)
CASES = {f"{f} d{d}": (f, {}, (N, d), -5.0, 5.0)
         for f in ANY_DIM for d in (2, 5, 30, 100)}
CASES.update({
    "h1": ("h1", {}, (N, 2), -5.0, 10.0),
    "himmelblau": ("himmelblau", {}, (N, 2), -5.0, 10.0),
    "schaffer_mo": ("schaffer_mo", {}, (N, 1), -5.0, 10.0),
    "poloni": ("poloni", {}, (N, 2), -math.pi, math.pi),
    "dent": ("dent", {}, (N, 2), -1.5, 1.5),
    "fonseca": ("fonseca", {}, (N, 3), -4.0, 4.0),
    "zdt2": ("zdt2", {}, (N, 30), 0.0, 1.0),
    "zdt3": ("zdt3", {}, (N, 30), 0.0, 1.0),
    "zdt4": ("zdt4", {}, (N, 10), 0.0, 1.0),
    "zdt6": ("zdt6", {}, (N, 10), 0.0, 1.0),
    "dtlz1": ("dtlz1", {"obj": 3}, (N, 7), 0.0, 1.0),
    "dtlz3": ("dtlz3", {"obj": 3}, (N, 12), 0.0, 1.0),
    "dtlz4": ("dtlz4", {"obj": 3, "alpha": 100.0}, (N, 12), 0.0, 1.0),
    "dtlz4 int alpha": ("dtlz4", {"obj": 3, "alpha": 100}, (N, 12), 0.0,
                        1.0),
    "dtlz5": ("dtlz5", {"n_objs": 3}, (N, 12), 0.0, 1.0),
    "dtlz6": ("dtlz6", {"n_objs": 3}, (N, 12), 0.0, 1.0),
    "dtlz7": ("dtlz7", {"n_objs": 3}, (N, 22), 0.0, 1.0),
})
# the largest gap to jax of each objective, in float32 ulps, measured on
# these inputs (every other case bit for bit)
ULP_BOUND = {
    "bohachevsky d5": [2], "bohachevsky d30": [4],
    "rastrigin_scaled d30": [5], "rastrigin_scaled d100": [3],
    "rastrigin_skew d30": [4], "schaffer d5": [25], "schaffer d30": [5],
    "kursawe d30": [3, 16], "poloni": [4, 0], "zdt4": [0, 2],
    "dtlz7": [0, 0, 1],
}


def _inputs(cid, shape, lo, hi):
    rng = np.random.default_rng(sum(map(ord, cid)))
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    if cid == "zdt4":
        x[:, 1:] = x[:, 1:] * 10.0 - 5.0        # x_2.. in [-5, 5]
    return x


def _tk(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


def _outs(v):
    return [np.asarray(o) for o in (v if isinstance(v, (tuple, list))
                                    else (v,))]


def _ulps(a, b):
    """Distance in float32 units in the last place, elementwise."""
    a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64)
            for v in (a, b))
    a, b = (np.where(v < 0, -(v & 0x7FFFFFFF), v) for v in (a, b))
    return np.abs(a - b)


def _check(cid, want, got):
    want, got = _outs(want), [g.numpy() for g in (
        got if isinstance(got, (tuple, list)) else (got,))]
    assert len(want) == len(got)
    for j, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape and b.dtype == a.dtype
        bound = ULP_BOUND.get(cid, [0] * len(want))[j]
        gap = int(_ulps(a, b).max())
        assert gap <= bound, f"{cid} objective {j}: {gap} ulps"


@pytest.mark.parametrize("cid", sorted(CASES))
def test_function_against_jax(cid):
    name, kw, shape, lo, hi = CASES[cid]
    x = _inputs(cid, shape, lo, hi)
    want = jax.jit(jax.vmap(lambda v: getattr(jb, name)(v, **kw)))(x)
    fn = getattr(tb, name)
    assert fn.batched is fn                   # the loops call it once
    _check(cid, want, fn(torch.from_numpy(x), **kw))
    one = fn(torch.from_numpy(x[0]), **kw)    # one individual
    _check(cid, jax.tree_util.tree_map(lambda o: o[:1], want),
           tuple(o[None] for o in one))


def test_names_match_the_jax_package():
    for jmod, tmod in ((jb, tb), (jbin, tbin), (jmp, tmp),
                       (jtools, ttools)):
        assert set(jmod.__all__) <= set(tmod.__all__)
        for name in jmod.__all__:
            assert hasattr(tmod, name), name


def test_rand_and_shekel():
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(3).uniform(0, 10, (64, 4)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda v: jb.rand(v, key)))(x)
    got = torch.func.vmap(lambda v: tb.rand(v, _tk(key))[0])(
        torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(want[0]), got.numpy())
    a = np.random.default_rng(4).uniform(0, 10, (10, 4)).astype(np.float32)
    c = np.random.default_rng(5).uniform(0.1, 1, 10).astype(np.float32)
    want = jax.jit(jax.vmap(lambda v: jb.shekel(v, a, c)))(x)
    _check("shekel", want, tb.shekel(torch.from_numpy(x), a, c))


BINARY = [("trap", {}, 5), ("inv_trap", {}, 5), ("chuang_f1", {}, 41),
          ("chuang_f2", {}, 42), ("chuang_f3", {}, 41),
          ("royal_road1", {"order": 8}, 64),
          ("royal_road2", {"order": 4}, 64)]


@pytest.mark.parametrize("name,kw,n", BINARY)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_binary_functions(name, kw, n, dtype):
    rng = np.random.default_rng(n)
    bits = (rng.uniform(size=(512, n)) < 0.8).astype(dtype)
    bits[:20] = 1
    bits[20:40] = 0
    want = jax.jit(jax.vmap(lambda v: getattr(jbin, name)(v, **kw)))(bits)
    got = getattr(tbin, name)(torch.from_numpy(bits), **kw)
    for a, b in zip(_outs(want), got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(a, b.numpy())
        assert a.dtype == b.numpy().dtype


@pytest.mark.parametrize("nbits", [8, 16, 30])
def test_bin2float_decoding(nbits):
    """Past 24 bits the float32 sum of powers of two rounds: XLA's order
    decides the value."""
    bits = (np.random.default_rng(nbits).uniform(size=(256, 3 * nbits))
            < 0.5).astype(np.int32)
    want = jax.jit(jax.vmap(jbin.bin2float(-5.12, 5.12, nbits)(
        lambda v: v)))(bits)
    got = tbin.bin2float(-5.12, 5.12, nbits)(lambda v: v)(
        torch.from_numpy(bits))
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


SCENARIOS = [("1", {}), ("2", {}), ("3", {}),
             ("2", {"npeaks": [3, 10, 20], "number_severity": 0.4})]


@pytest.mark.parametrize("scenario,extra", SCENARIOS)
def test_moving_peaks_twenty_changes(scenario, extra):
    jsc = getattr(jmp, f"SCENARIO_{scenario}")
    tsc = getattr(tmp, f"SCENARIO_{scenario}")
    key = jax.random.PRNGKey(11)
    J = jmp.MovingPeaks(5, key, **{**jsc, **extra})
    T = tmp.MovingPeaks(5, _tk(key), **{**tsc, **extra})
    x = np.random.default_rng(0).uniform(0, 100, (256, 5)).astype(np.float32)
    change = jax.jit(J.change_peaks_state)
    for it in range(20):
        want = jax.jit(jax.vmap(lambda v: J.evaluate(v)[0]))(x)
        np.testing.assert_array_equal(
            np.asarray(want), T.evaluate(torch.from_numpy(x))[0].numpy())
        for f in ("position", "height", "width", "last_change", "active"):
            np.testing.assert_array_equal(np.asarray(getattr(J.state, f)),
                                          getattr(T.state, f).numpy(),
                                          err_msg=f"{f} after {it}")
        k = jax.random.fold_in(key, it)
        J.state = change(k, J.state)
        T.state = T.change_peaks_state(_tk(k), T.state)
    jm, tm = J.globalMaximum(), T.globalMaximum()
    assert jm[0] == tm[0]
    np.testing.assert_array_equal(jm[1], tm[1])
    assert [v for v, _ in J.maximums()] == [v for v, _ in T.maximums()]


def test_moving_peaks_offline_error_and_period():
    """The stateful call: offline and current errors as the JAX
    package's, and ``changePeaks`` every ``period`` evaluations."""
    key = jax.random.PRNGKey(2)
    J = jmp.MovingPeaks(2, key, **{**jmp.SCENARIO_2, "period": 7})
    T = tmp.MovingPeaks(2, _tk(key), **{**tmp.SCENARIO_2, "period": 7})
    xs = np.random.default_rng(1).uniform(0, 100, (20, 2)).astype(np.float32)
    for x in xs:
        assert J(x) == T(x)
    assert J.offlineError() == T.offlineError()
    assert J.currentError() == T.currentError()
    np.testing.assert_array_equal(np.asarray(J.state.position),
                                  T.state.position.numpy())


def _decorated(mod, dec):
    return dec(mod.rastrigin)


@pytest.mark.parametrize("kind", ["translate", "scale", "bound clip",
                                  "bound wrap", "bound mirror", "noise",
                                  "rotate"])
def test_decorators(kind):
    rng = np.random.default_rng(6)
    x = rng.uniform(-20, 20, (512, 4)).astype(np.float32)
    vec = rng.uniform(-3, 3, 4).astype(np.float32)
    mat = np.linalg.qr(rng.standard_normal((4, 4)))[0].astype(np.float32)
    if kind == "translate":
        jd, td = jtools.translate(vec), ttools.translate(vec)
    elif kind == "scale":
        jd, td = jtools.scale(vec + 5.0), ttools.scale(vec + 5.0)
    elif kind == "rotate":
        jd, td = jtools.rotate(mat), ttools.rotate(mat)
    elif kind == "noise":
        jd = jtools.noise(lambda k: jax.random.uniform(k))
        td = ttools.noise(lambda k: tr.uniform(k, ()))
    else:
        mode = kind.split()[1]
        bounds = ([-5.0, -1.0, 0.0, 2.0], [5.0, 1.0, 3.0, 2.5])
        jd = jtools.bound(bounds, mode)
        td = ttools.bound(bounds, mode)
        want = jax.jit(jax.vmap(jd(lambda v: (v, -v))))(x)
        got = td(lambda v: (v, -v))(torch.from_numpy(x))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        return
    jf, tf = jd(jb.cigar), td(tb.cigar)
    if kind == "noise":
        key = jax.random.PRNGKey(7)
        want = jax.jit(jax.vmap(lambda v: jf(v, key=key)))(x)
        got = torch.func.vmap(lambda v: tf(v, key=_tk(key))[0])(
            torch.from_numpy(x))
        np.testing.assert_array_equal(np.asarray(want[0]), got.numpy())
        assert tf(torch.from_numpy(x[0]))[0] == tb.cigar(
            torch.from_numpy(x[0]))[0]
        return
    want = jax.jit(jax.vmap(lambda v: jf(v)[0]))(x)
    got = tf(torch.from_numpy(x))[0]
    assert int(_ulps(np.asarray(want), got.numpy()).max()) <= (
        ROTATE_ULP if kind == "rotate" else 0)
    if kind == "translate":
        np.testing.assert_array_equal(
            (torch.from_numpy(x) - torch.from_numpy(vec)).numpy(),
            np.asarray(jax.jit(jax.vmap(jd(lambda v: v)))(x)))
    if kind == "scale":
        np.testing.assert_array_equal(
            td(lambda v: v)(torch.from_numpy(x)).numpy(),
            np.asarray(jax.jit(jax.vmap(jd(lambda v: v)))(x)))
