"""The port's CMA-ES against the JAX package's ``deap_tpu/cma.py``.

* ``Strategy``'s parameters are the same Python floats, and its float32
  weights are bitwise equal.
* ``generate`` and ``update`` are held teacher-forced: JAX's state at
  generation t goes into both packages with the same key and the same
  evaluated population, and the port's output is compared with JAX's
  generation t + 1, for 20 generations at N = 10, lambda = 32.  The
  matrix products and ``eigh`` of the two libraries round differently,
  so each field must agree within ``RTOL`` of its largest magnitude
  (measured at most 4.3e-7); ``B`` is compared up to the sign of each
  column, as ``|B_portᵀ B_jax| = I`` within ``B_ATOL`` (measured
  2.0e-5), since eigenvectors have no canonical sign.  ``hsig`` is a
  threshold: where its margin is under ``HSIG_MARGIN``, ``pc`` and ``C``
  are not compared that generation.
* The (1+lambda) update is held the same way.
* ``ackley`` is bitwise to jitted JAX at dims 5 and 100 (and, measured,
  6, 33 and 1000); at dim 10 (and 3, 20, 32) XLA fuses the squares into
  its sum as FMAs and the value may differ by at most ``ACKLEY_ULP``
  units in the last place of 20.0 (measured 1).
* MO-CMA: ``generate`` (both parent-pick laws) and whole runs are
  bitwise to JAX's; ``_select``'s device route, its host route and
  JAX's host route choose the same individuals.
* The quality anchors of ``tests/test_algorithms.py`` on the port alone.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, benchmarks as jbench, cma as jcma
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu_torch import base as tbase, benchmarks as tbench, cma as tcma
from deap_tpu_torch import interop, random as tr
from deap_tpu_torch.algorithms import ea_generate_update
from deap_tpu_torch.ops.hv import hypervolume
from deap_tpu_torch.utils.support import HallOfFame, Statistics

torch.set_num_threads(1)

RTOL = 1e-5
B_ATOL = 1e-3
HSIG_MARGIN = 1e-4
ACKLEY_ULP = 2
HV_THRESHOLD = 116.0


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _to_torch_pop(pop, weights):
    return interop.population_to_torch(
        np.asarray(pop.genome), np.asarray(pop.fitness.values),
        np.asarray(pop.fitness.valid), weights, device="cpu")


@pytest.mark.parametrize("dim,lam,kind", [(5, 20, "superlinear"),
                                          (10, 32, "linear"),
                                          (100, 4096, "equal")])
def test_strategy_parameters_equal_jax(dim, lam, kind):
    j = jcma.Strategy(centroid=[5.0] * dim, sigma=5.0, lambda_=lam,
                      weights=kind)
    t = tcma.Strategy(centroid=[5.0] * dim, sigma=5.0, lambda_=lam,
                      weights=kind, device="cpu")
    for name in ("dim", "lambda_", "mu", "mueff", "cc", "cs", "ccov1",
                 "ccovmu", "damps", "chiN", "sigma0"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    jd, td = jcma.Strategy([1.0] * 7, 1.0), tcma.Strategy([1.0] * 7, 1.0,
                                                          device="cpu")
    assert td.lambda_ == jd.lambda_ and td.mu == jd.mu


def test_init_equals_jax():
    j = jcma.Strategy(centroid=[5.0] * 10, sigma=5.0, lambda_=32).init()
    t = tcma.Strategy(centroid=[5.0] * 10, sigma=5.0, lambda_=32,
                      device="cpu").init()
    for name in ("centroid", "sigma", "C", "ps", "pc", "B", "diagD",
                 "update_count"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert t.update_count.dtype == torch.int32


def _hsig_margin(js, state) -> float:
    """How far JAX's new state lies from the ``hsig`` threshold."""
    ps = np.asarray(state.ps, np.float64)
    t = int(state.update_count)
    lhs = (np.linalg.norm(ps) / math.sqrt(1 - (1 - js.cs) ** (2 * t))
           / js.chiN)
    return abs(lhs - (1.4 + 2.0 / (js.dim + 1.0)))


def test_strategy_teacher_forced_against_jax():
    n, lam, ngen = 10, 32, 20
    js = jcma.Strategy(centroid=[5.0] * n, sigma=5.0, lambda_=lam)
    ts = tcma.Strategy(centroid=[5.0] * n, sigma=5.0, lambda_=lam,
                       device="cpu")
    jtb = jbase.Toolbox()
    jtb.register("evaluate", jbench.sphere)
    gen, upd = jax.jit(js.generate), jax.jit(js.update)
    state, key = js.init(), jax.random.PRNGKey(0)
    compared = 0
    for _ in range(ngen):
        key, k_gen = jax.random.split(key)
        jg = gen(state, k_gen)
        tstate = interop.cma_state_to_torch(state, device="cpu")
        tg = ts.generate(tstate, interop.key_to_torch(k_gen, device="cpu"))
        assert _rel_err(tg, jg) <= RTOL
        pop, _ = j_eval(jtb, jbase.Population(
            jg, jbase.Fitness.empty(lam, (-1.0,))))
        nxt = upd(state, pop)
        tnext = ts.update(tstate, _to_torch_pop(pop, (-1.0,)))
        assert int(tnext.update_count) == int(nxt.update_count)
        np.testing.assert_array_equal(tnext.centroid.numpy(),
                                      np.asarray(nxt.centroid))
        fields = ["sigma", "ps", "diagD"]
        if _hsig_margin(js, nxt) > HSIG_MARGIN:
            fields += ["pc", "C"]
            compared += 1
        for name in fields:
            assert _rel_err(getattr(tnext, name),
                            getattr(nxt, name)) <= RTOL, name
        cross = np.abs(tnext.B.numpy().T @ np.asarray(nxt.B))
        np.testing.assert_allclose(cross, np.eye(n), rtol=0, atol=B_ATOL)
        state = nxt
    assert compared >= ngen - 2
    assert float(state.sigma) < 5.0


def test_one_plus_lambda_teacher_forced_against_jax():
    n, lam, ngen = 5, 8, 15
    js = jcma.StrategyOnePlusLambda(parent=[3.0] * n, sigma=1.0,
                                    weights=(-1.0,), lambda_=lam)
    ts = tcma.StrategyOnePlusLambda(parent=[3.0] * n, sigma=1.0,
                                    weights=(-1.0,), lambda_=lam,
                                    device="cpu")
    for name in ("lambda_", "d", "ptarg", "cp", "cc", "ccov", "pthresh"):
        assert getattr(ts, name) == getattr(js, name), name
    jtb = jbase.Toolbox()
    jtb.register("evaluate", jbench.sphere)
    gen, upd = jax.jit(js.generate), jax.jit(js.update)
    state, key = js.init(), jax.random.PRNGKey(10)
    tinit = ts.init()
    for name in ("parent", "parent_wvalues", "parent_valid", "sigma", "C",
                 "A", "pc", "psucc"):
        np.testing.assert_array_equal(getattr(tinit, name).numpy(),
                                      np.asarray(getattr(state, name)))
    for _ in range(ngen):
        key, k_gen = jax.random.split(key)
        jg = gen(state, k_gen)
        tstate = interop.one_plus_lambda_state_to_torch(state, device="cpu")
        tg = ts.generate(tstate, interop.key_to_torch(k_gen, device="cpu"))
        assert _rel_err(tg, jg) <= RTOL
        pop, _ = j_eval(jtb, jbase.Population(
            jg, jbase.Fitness.empty(lam, (-1.0,))))
        nxt = upd(state, pop)
        tnext = ts.update(tstate, _to_torch_pop(pop, (-1.0,)))
        for name in ("parent", "parent_wvalues", "parent_valid"):
            np.testing.assert_array_equal(getattr(tnext, name).numpy(),
                                          np.asarray(getattr(nxt, name)))
        for name in ("sigma", "psucc", "pc", "C", "A"):
            assert _rel_err(getattr(tnext, name),
                            getattr(nxt, name)) <= RTOL, name
        state = nxt


def test_cholesky_of_an_indefinite_matrix_is_nan():
    a = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(a.numpy())))
    got = tcma._cholesky_or_nan(a).numpy()
    np.testing.assert_array_equal(got, want)          # NaN below, 0 above
    assert np.isnan(got[np.tril_indices(2)]).all()
    ok = torch.tensor([[4.0, 2.0], [2.0, 3.0]])
    np.testing.assert_allclose(tcma._cholesky_or_nan(ok).numpy(),
                               np.linalg.cholesky(ok.numpy()), rtol=1e-6)


def _ulps_of_20(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max() / np.spacing(np.float32(20.0)))


@pytest.mark.parametrize("dim,scale", [(5, 5.0), (5, 1e-3), (10, 30.0),
                                       (10, 1e-2), (100, 5.0), (100, 1e-2),
                                       (100, 30.0)])
def test_ackley_against_jitted_jax(dim, scale):
    x = (np.random.default_rng(dim).standard_normal((512, dim))
         * scale).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda g: jbench.ackley(g)[0]))(
        jnp.asarray(x)))
    got = torch.func.vmap(lambda g: tbench.ackley(g)[0])(
        torch.from_numpy(x)).numpy()
    # the population-level form the loops call gives the same numbers
    np.testing.assert_array_equal(tbench.ackley(torch.from_numpy(x))[0],
                                  got)
    if dim == 10:
        assert _ulps_of_20(got, want) <= ACKLEY_ULP
    else:
        np.testing.assert_array_equal(got, want)


# -- MO-CMA-ES --------------------------------------------------------------

def _zdt1(genomes: np.ndarray) -> np.ndarray:
    """ZDT1 in float64 numpy, with the anchor's distance penalty outside
    [0, 1] (one function for both packages)."""
    g = np.asarray(genomes, np.float64)
    f = np.clip(g, 0.0, 1.0)
    pen = 1e7 * np.sum((f - g) ** 2, axis=1)
    gg = 1.0 + 9.0 * np.sum(f[:, 1:], axis=1) / (f.shape[1] - 1)
    f1 = f[:, 0]
    return np.stack([f1, gg * (1.0 - np.sqrt(f1 / gg))], 1) + pen[:, None]


def _mo_pair(mu, lam, **kw):
    pop = np.random.RandomState(128).rand(mu, 5)
    vals = _zdt1(pop)
    j = jcma.StrategyMultiObjective(pop, (-1.0, -1.0), sigma=1.0,
                                    values=vals, mu=mu, lambda_=lam, **kw)
    t = tcma.StrategyMultiObjective(pop, (-1.0, -1.0), sigma=1.0,
                                    values=vals, mu=mu, lambda_=lam,
                                    device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("mu,lam", [(10, 10), (10, 6)])
def test_mo_cma_runs_are_bitwise_to_jax(mu, lam):
    j, t = _mo_pair(mu, lam)
    key = jax.random.PRNGKey(128)
    for _ in range(15):
        key, k = jax.random.split(key)
        jo = j.generate(k)
        to = t.generate(interop.key_to_torch(k, device="cpu"))
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(t._last_offspring_parent,
                                      j._last_offspring_parent)
        j.update(jo, _zdt1(jo))
        t.update(to, _zdt1(to))
        for name in ("parents", "parent_values", "sigmas", "A",
                     "invCholesky", "pc", "psucc"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.generate(7).shape == (lam, 5)      # a Python integer key


def _candidates(seed, n=20):
    """Two-objective candidate values with exact ties and duplicates."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 6, (n, 2)).astype(np.float64)
    v[n // 2:] = rng.random((n - n // 2, 2)) * 5
    v[-2] = v[-1]
    return rng.random((n, 5)), v


def test_mo_select_routes_agree_with_jax():
    j, t = _mo_pair(10, 10, select_backend="host")
    cases = [_candidates(s) for s in range(12)]
    key = jax.random.PRNGKey(5)
    for _ in range(8):                          # a real run's candidates
        key, k = jax.random.split(key)
        off = j.generate(k)
        vals = _zdt1(off)
        cases.append((np.concatenate([off, j.parents]),
                      np.concatenate([vals, j.parent_values])))
        j.update(off, vals)
    for genomes, values in cases:
        want = j._select(genomes, values, None)
        t.select_backend = "host"
        host = t._select(genomes, values, None)
        t.select_backend = "auto"
        device = t._select(genomes, values, None)
        assert host[0] == want[0] == device[0]
        assert set(host[1]) == set(want[1]) == set(device[1])
        assert len(device[0]) == 10


def test_hypervolume_contributions_2d_matches_jax():
    from deap_tpu.ops import indicator as jind
    from deap_tpu_torch.ops import indicator as tind
    rng = np.random.default_rng(1)
    f1 = np.sort(rng.random(16)).astype(np.float32)
    obj = np.stack([f1, 1 - f1], 1)
    obj[5] = obj[4]
    mask = rng.random(16) > 0.3
    ref = np.array([1.1, 1.1], np.float32)
    want = np.asarray(jax.jit(jind.hypervolume_contributions_2d)(
        jnp.asarray(obj), jnp.asarray(mask), jnp.asarray(ref)))
    got = tind.hypervolume_contributions_2d(
        torch.from_numpy(obj), torch.from_numpy(mask), torch.from_numpy(ref))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tind.hypervolume(-obj[mask]) == jind.hypervolume(-obj[mask])
    np.testing.assert_allclose(
        tind.hypervolume_contributions(-obj.astype(np.float64)),
        jind.hypervolume_contributions(-obj.astype(np.float64)),
        rtol=1e-12)


# -- quality anchors (tests/test_algorithms.py) on the port alone -------------

def _cma_toolbox(strategy, evaluate):
    tb = tbase.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def test_cma_sphere_anchor():
    s = tcma.Strategy(centroid=[5.0] * 5, sigma=5.0, lambda_=20,
                      device="cpu")
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    hof = HallOfFame(3)
    pop, state, log = ea_generate_update(
        tr.PRNGKey(0, device="cpu"), _cma_toolbox(s, tbench.sphere),
        s.init(), ngen=100, weights=(-1.0,), stats=stats, halloffame=hof)
    assert float(pop.fitness.values.min()) < 1e-8
    assert log.select("gen") == list(range(1, 101))
    assert int(state.update_count) == 100
    # the archive holds the run's best three, best first
    assert hof.keys[0][0] == min(log.select("min"))
    assert list(hof.keys[:, 0]) == sorted(hof.keys[:, 0])


def test_one_plus_lambda_anchor():
    s = tcma.StrategyOnePlusLambda(parent=[3.0] * 5, sigma=1.0,
                                   weights=(-1.0,), lambda_=8, device="cpu")
    _, state, _ = ea_generate_update(
        tr.PRNGKey(10, device="cpu"), _cma_toolbox(s, tbench.sphere),
        s.init(), ngen=300, weights=(-1.0,))
    assert -float(state.parent_wvalues[0]) < 1e-3


def test_mo_cma_zdt1_anchor():
    pop = np.random.RandomState(128).rand(10, 5)
    s = tcma.StrategyMultiObjective(pop, (-1.0, -1.0), sigma=1.0,
                                    values=_zdt1(pop), mu=10, lambda_=10,
                                    device="cpu")
    key = tr.PRNGKey(128, device="cpu")
    for _ in range(500):
        key, k = tr.split(key)
        off = s.generate(k)
        s.update(off, _zdt1(off))
    assert np.all(s.parents >= -1e-5) and np.all(s.parents <= 1 + 1e-5)
    assert hypervolume(s.parent_values, [11.0, 11.0]) > HV_THRESHOLD


def test_strategy_under_rbg_matches_jax():
    """``bench_cma.py``'s default key implementation: generations of
    ``Strategy`` from typed rbg keys, held as the threefry run is."""
    n, lam = 10, 32
    js = jcma.Strategy(centroid=[5.0] * n, sigma=5.0, lambda_=lam)
    ts = tcma.Strategy(centroid=[5.0] * n, sigma=5.0, lambda_=lam,
                       device="cpu")
    jtb = jbase.Toolbox()
    jtb.register("evaluate", jbench.sphere)
    gen, upd = jax.jit(js.generate), jax.jit(js.update)
    words = np.asarray([0, 0, 0, 0], np.uint32)
    state = js.init()
    key = jax.random.wrap_key_data(jnp.asarray(words), impl="rbg")
    for _ in range(3):
        key, k_gen = jax.random.split(key)
        jg = gen(state, k_gen)
        tstate = interop.cma_state_to_torch(state, device="cpu")
        tk = interop.key_to_torch(jax.random.key_data(k_gen), device="cpu")
        assert tr.impl_of(tk) == "rbg"
        tg = ts.generate(tstate, tk)
        assert _rel_err(tg, jg) <= RTOL
        pop, _ = j_eval(jtb, jbase.Population(
            jg, jbase.Fitness.empty(lam, (-1.0,))))
        nxt = upd(state, pop)
        tnext = ts.update(tstate, _to_torch_pop(pop, (-1.0,)))
        np.testing.assert_array_equal(tnext.centroid.numpy(),
                                      np.asarray(nxt.centroid))
        for name in ("sigma", "ps", "diagD"):
            assert _rel_err(getattr(tnext, name),
                            getattr(nxt, name)) <= RTOL, name
        state = nxt


@pytest.fixture
def jax_rbg_default():
    """``jax_default_prng_impl`` set to rbg for a JAX function that makes
    its own key from an integer; restored whatever happens."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", prev)


def test_mo_cma_integer_key_follows_the_default_impl(jax_rbg_default):
    """MO-CMA's ``generate(int)`` makes ``PRNGKey(int)`` of the default
    implementation in both packages (``deap_tpu/cma.py:387``)."""
    j, t = _mo_pair(10, 6)
    jo = j.generate(7)
    with tr.default_impl("rbg"):
        to = t.generate(7)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(t._last_offspring_parent,
                                  j._last_offspring_parent)
