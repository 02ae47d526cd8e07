"""The port's thirteenth slice end to end against the JAX package:
``bench_nsga2.py``'s generation with ``BENCH_SELECT=nsga3``, ``spea2``
and ``BENCH_STAGED=1`` spea2, the NSGA-II and NSGA-III examples, and
the reference anchors ``tests/test_algorithms.py::test_nsga3`` and
``::test_spea2_selection`` run through the port.

The JAX side is each program as published (the bench's generation
scanned and jitted, its staged form as two jitted dispatches a
generation; the examples' ``gen_step`` scanned and jitted), here at
POP 256 (bench) and at the examples' small sizes, for two to four
generations, under the keys the scripts use (the bench under rbg, its
default, and threefry).  Teacher-forced: the JAX population of
generation g goes into the port under the same key.  Offspring must be
bitwise equal, mating pools and selections equal exactly (the port
selects on the JAX pool's values); the objective values agree within
``VALUE_RTOL`` = 1e-6 (inside a jitted generation XLA may fuse an
objective's sums into the variation and reorder them; alone, the port's
``zdt1`` and ``dtlz2`` are bitwise, ``tests/test_torch_mo_select.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from deap_tpu import algorithms as jalg, base as jbase
from deap_tpu import benchmarks as jbench
from deap_tpu.ops import crossover as jcx, emo as jemo, mutation as jmut
from deap_tpu_torch import algorithms as talg, base as tbase, interop
from deap_tpu_torch import benchmarks as tbench
from deap_tpu_torch import random as tr
from deap_tpu_torch.benchmarks import tools as ttools
from deap_tpu_torch.examples.ga import nsga2 as tnsga2, nsga3 as tnsga3
from deap_tpu_torch.ops import crossover as tcx, emo as temo
from deap_tpu_torch.ops import mutation as tmut

torch.set_num_threads(1)

VALUE_RTOL = 1e-6
BENCH_POP = 256
BENCH = {"zdt1": (2, 30), "dtlz2": (3, 12)}          # nobj, variables
_P = {2: 99, 3: 12}


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _tfit(values, weights):
    v = torch.from_numpy(np.array(values))
    return tbase.Fitness(v, torch.ones(v.shape[0], dtype=torch.bool), weights)


# ---------------------------------------------------------------------------
# bench_nsga2.py with BENCH_SELECT=nsga3 | spea2, BENCH_STAGED=1
# ---------------------------------------------------------------------------


def _bench_toolboxes(problem):
    nobj, ndim = BENCH[problem]
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    for tb, bench, cx, mut in ((jtb, jbench, jcx, jmut),
                               (ttb, tbench, tcx, tmut)):
        if problem == "zdt1":
            tb.register("evaluate", bench.zdt1)
        else:
            tb.register("evaluate", bench.dtlz2, obj=nobj)
        tb.register("mate", cx.cx_simulated_binary_bounded,
                    low=0.0, up=1.0, eta=20.0)
        tb.register("mutate", mut.mut_polynomial_bounded,
                    low=0.0, up=1.0, eta=20.0, indpb=1.0 / ndim)
    return jtb, ttb


def _bench_chunk(pop):
    return max(64, min(1024, 10 ** 8 // (2 * pop)))


def _jax_bench(problem, select, staged, impl, ngen=2):
    """bench_nsga2.py's program: ``(key, pop0, per-generation outputs)``
    where each generation gives (offspring genome, pool values,
    selection, new genome)."""
    nobj, ndim = BENCH[problem]
    n, weights, chunk = BENCH_POP, (-1.0,) * nobj, _bench_chunk(BENCH_POP)
    jtb, _ = _bench_toolboxes(problem)
    ref_points = jnp.asarray(jemo.uniform_reference_points(nobj, _P[nobj]))

    def vary_eval(key, pop):
        key, k_var, k_sel = jax.random.split(key, 3)
        genome, _ = jalg.vary_genome(k_var, pop.genome, jtb, 0.9, 1.0,
                                     pairing="halves")
        off = jbase.Population(genome, jbase.Fitness.empty(n, weights))
        off, _ = jalg.evaluate_population(jtb, off)
        return key, k_sel, genome, pop.concat(off)

    def generation(carry, _):
        key, pop = carry
        key, k_sel, genome, pool = vary_eval(key, pop)
        if select == "spea2":
            sel = jemo.sel_spea2(k_sel, pool.fitness, n, chunk=chunk)
        else:
            sel = jemo.sel_nsga3(k_sel, pool.fitness, n, ref_points)
        new = pool.take(sel)
        return (key, new), (genome, pool.fitness.values, sel, new.genome)

    key = jax.random.PRNGKey(0)
    if impl == "rbg":
        key = jax.random.wrap_key_data(jnp.array([0, 0, 0, 0], jnp.uint32),
                                       impl="rbg")
    genome = jax.random.uniform(key, (n, ndim), jnp.float32)
    pop = jbase.Population(genome, jbase.Fitness.empty(n, weights))
    pop, _ = jalg.evaluate_population(jtb, pop)
    if not staged:
        _, ys = jax.jit(lambda k, p: lax.scan(generation, (k, p), None,
                                              length=ngen))(key, pop)
        return key, pop, [tuple(y[g] for y in ys) for g in range(ngen)]

    @jax.jit
    def stage_a(key, pop):
        key, k_sel, genome, pool = vary_eval(key, pop)
        w = pool.fitness.masked_wvalues()
        fit, nondom = jemo._spea2_fitness_stage(w, chunk, "bisect")
        return key, genome, pool, w, fit, nondom

    @jax.jit
    def stage_b(pool, w, fit, nondom):
        sel = jemo._spea2_select_stage(w, fit, nondom, n, chunk)
        return sel, pool.take(sel)

    outs, k, p = [], key, pop
    for _ in range(ngen):
        k, genome, pool, w, fit, nondom = stage_a(k, p)
        sel, p = stage_b(pool, w, fit, nondom)
        outs.append((genome, pool.fitness.values, sel, p.genome))
    return key, pop, outs


def _port_select(select, staged, key, fitness, n):
    chunk = _bench_chunk(n)
    if select == "nsga3":
        rp = temo.uniform_reference_points(fitness.nobj, _P[fitness.nobj])
        return temo.sel_nsga3(key, fitness, n, rp)
    if staged:
        w = fitness.masked_wvalues()
        fit, nondom = temo._spea2_fitness_stage(w, chunk, "bisect")
        return temo._spea2_select_stage(w, fit, nondom, n, chunk)
    return temo.sel_spea2(key, fitness, n, chunk=chunk)


@pytest.mark.parametrize("impl", ["rbg", "threefry2x32"])
@pytest.mark.parametrize("problem", list(BENCH))
@pytest.mark.parametrize("select,staged", [("nsga3", False),
                                           ("spea2", False),
                                           ("spea2", True)],
                         ids=["nsga3", "spea2", "spea2-staged"])
def test_bench_generation_matches_jax(impl, problem, select, staged):
    nobj, _ = BENCH[problem]
    n, weights = BENCH_POP, (-1.0,) * nobj
    _, ttb = _bench_toolboxes(problem)
    jkey, pop0, outs = _jax_bench(problem, select, staged, impl)
    words = jax.random.key_data(jkey) if impl == "rbg" else jkey
    k = interop.key_to_torch(np.asarray(words), device="cpu")
    genome = np.array(pop0.genome)
    for off, pool_vals, sel, new in outs:
        k, k_var, k_sel = tr.split(k, 3)
        tg, _ = talg.vary_genome(k_var, torch.from_numpy(genome), ttb, 0.9,
                                 1.0, pairing="halves")
        assert _bitwise(tg.numpy(), off)
        toff, _ = talg.evaluate_population(ttb, tbase.Population(
            tg, tbase.Fitness.empty(n, weights, device="cpu")))
        np.testing.assert_allclose(toff.fitness.values.numpy(),
                                   np.asarray(pool_vals)[n:],
                                   rtol=VALUE_RTOL)
        tsel = _port_select(select, staged, k_sel, _tfit(pool_vals, weights),
                            n)
        assert np.array_equal(tsel.numpy(), np.asarray(sel))
        genome = np.array(new)


def test_staged_spea2_equals_the_single_program():
    """The two stage calls select what ``sel_spea2`` selects (the bisect
    kth takes the same values as the blocked one)."""
    rng = np.random.default_rng(1)
    vals = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    fit = _tfit(vals, (-1.0,) * 3)
    for chunk in (64, 1024):
        assert torch.equal(temo.sel_spea2_staged(None, fit, 300, chunk),
                           temo.sel_spea2(None, fit, 300, chunk=chunk))


# ---------------------------------------------------------------------------
# the examples: examples/ga/nsga2.py and examples/ga/nsga3.py
# ---------------------------------------------------------------------------


def _jax_example(which, mu, ngen, seed=1):
    """The JAX example's ``gen_step`` scanned and jitted, returning per
    generation (mating indices, children, pool values, selection)."""
    if which == "nsga2":
        nobj, ndim, eta_cx = 2, tnsga2.NDIM, 20.0
        evaluate = jbench.zdt1
        ref_points = None
    else:
        nobj, ndim, eta_cx = 3, tnsga3.NDIM, 30.0
        evaluate = lambda g: jbench.dtlz2(g, nobj)
        ref_points = jemo.uniform_reference_points(nobj, tnsga3.P)
    weights = (-1.0,) * nobj
    tb = jbase.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("mate", jcx.cx_simulated_binary_bounded, eta=eta_cx,
                low=0.0, up=1.0)
    tb.register("mutate", jmut.mut_polynomial_bounded, eta=20.0, low=0.0,
                up=1.0, indpb=1.0 / ndim)

    def gen_step(carry, _):
        key, pop = carry
        key, k_a, k_cx, k_mut, k_b = jax.random.split(key, 5)
        if which == "nsga2":
            idx = jemo.sel_tournament_dcd(k_a, pop.fitness, mu)
        else:
            idx = jax.random.permutation(k_a, mu)
        off = pop.take(idx)
        keys = jax.random.split(k_cx, mu // 2)
        ca, cb = jax.vmap(tb.mate)(keys, off.genome[0::2], off.genome[1::2])
        child = jnp.stack([ca, cb], 1).reshape(mu, ndim)
        child = jax.vmap(tb.mutate)(jax.random.split(k_mut, mu), child)
        off = jbase.Population(child, jbase.Fitness.empty(mu, weights))
        off, _ = jalg.evaluate_population(tb, off)
        pool = pop.concat(off)
        if which == "nsga2":
            sel = jemo.sel_nsga2(k_b, pool.fitness, mu)
        else:
            sel = jemo.sel_nsga3(k_b, pool.fitness, mu, ref_points)
        return (key, pool.take(sel)), (idx, child, pool.fitness.values, sel)

    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    genome = jax.random.uniform(k_init, (mu, ndim), jnp.float32, 0.0, 1.0)
    pop = jbase.Population(genome, jbase.Fitness.empty(mu, weights))

    @jax.jit
    def run(key, pop):
        pop, _ = jalg.evaluate_population(tb, pop)
        return pop, lax.scan(gen_step, (key, pop), None, length=ngen)

    pop0, (_, ys) = run(key, pop)
    return pop0, [tuple(y[g] for y in ys) for g in range(ngen)]


@pytest.mark.parametrize("which,mu,ngen", [("nsga2", 16, 4),
                                           ("nsga3", 92, 3)])
def test_example_generations_match_jax(which, mu, ngen):
    mod = tnsga2 if which == "nsga2" else tnsga3
    ttb = mod.toolbox()
    pop0, outs = _jax_example(which, mu, ngen)
    key, tpop = mod.initial(ttb, tr.PRNGKey(1, device="cpu"), mu)
    assert _bitwise(tpop.genome.numpy(), pop0.genome)
    np.testing.assert_allclose(tpop.fitness.values.numpy(),
                               np.asarray(pop0.fitness.values),
                               rtol=VALUE_RTOL)
    weights = tpop.fitness.weights
    genome, values = np.array(pop0.genome), np.array(pop0.fitness.values)
    ref_points = (temo.uniform_reference_points(3, tnsga3.P)
                  if which == "nsga3" else None)
    for idx, child, pool_vals, sel in outs:
        key, k_a, k_cx, k_mut, k_b = tr.split(key, 5)
        if which == "nsga2":
            tidx = temo.sel_tournament_dcd(k_a, _tfit(values, weights), mu)
        else:
            tidx = tr.permutation(k_a, mu)
        assert np.array_equal(tidx.numpy(), np.asarray(idx))
        tchild = mod.vary(ttb, k_cx, k_mut,
                          torch.from_numpy(genome)[tidx.long()])
        assert _bitwise(tchild.numpy(), child)
        toff, _ = talg.evaluate_population(ttb, tbase.Population(
            tchild, tbase.Fitness.empty(mu, weights, device="cpu")))
        np.testing.assert_allclose(toff.fitness.values.numpy(),
                                   np.asarray(pool_vals)[mu:],
                                   rtol=VALUE_RTOL)
        pool = _tfit(pool_vals, weights)
        if which == "nsga2":
            tsel = temo.sel_nsga2(k_b, pool, mu)
        else:
            tsel = temo.sel_nsga3(k_b, pool, mu, ref_points)
        assert np.array_equal(tsel.numpy(), np.asarray(sel))
        sel = np.asarray(sel)
        genome = np.concatenate([genome, np.asarray(child)])[sel]
        values = np.asarray(pool_vals)[sel]


def test_example_mains_run_and_improve():
    """Both examples' ``main`` on the CPU, cut short: the NSGA-II
    hypervolume at (11, 11) rises, the NSGA-III front error falls."""
    pop, hv = tnsga2.main(seed=1, mu=16, ngen=8, verbose=False,
                          device="cpu")
    assert pop.size == 16 and bool(pop.fitness.valid.all())
    _, pop0 = tnsga2.initial(tnsga2.toolbox(), tr.PRNGKey(1, device="cpu"),
                             16)
    assert hv > ttools.hypervolume(pop0.fitness, ref=np.array([11.0, 11.0]))
    pop3, err = tnsga3.main(seed=1, ngen=3, verbose=False, device="cpu")
    assert pop3.size == 92
    _, p0 = tnsga3.initial(tnsga3.toolbox(), tr.PRNGKey(1, device="cpu"), 92)
    assert err < tnsga3.front_error(p0.fitness.values)


# ---------------------------------------------------------------------------
# the reference anchors, through the port
# ---------------------------------------------------------------------------


def test_nsga3_anchor_through_the_port():
    """``tests/test_algorithms.py::test_nsga3``: NSGA-III on ZDT1 (5
    variables, MU 16, ``ea_mu_plus_lambda``, cxpb 0.7, mutpb 0.2, 100
    generations): hypervolume at (11, 11) > 116."""
    mu, ndim = 16, 5
    ref_points = temo.uniform_reference_points(2, 12)
    tb = tbase.Toolbox()
    tb.register("evaluate", tbench.zdt1)
    tb.register("mate", tcx.cx_simulated_binary_bounded, eta=20.0, low=0.0,
                up=1.0)
    tb.register("mutate", tmut.mut_polynomial_bounded, eta=20.0, low=0.0,
                up=1.0, indpb=1.0 / ndim)
    tb.register("select", lambda key, fit, k: temo.sel_nsga3(
        key, fit, k, ref_points))
    genome = tr.uniform(tr.PRNGKey(3, device="cpu"), (mu, ndim))
    pop = tbase.Population(genome, tbase.Fitness.empty(mu, (-1.0, -1.0),
                                                       device="cpu"))
    pop, _ = talg.ea_mu_plus_lambda(tr.PRNGKey(4, device="cpu"), pop, tb,
                                    mu=mu, lambda_=mu, cxpb=0.7, mutpb=0.2,
                                    ngen=100)
    hv = ttools.hypervolume(pop.fitness, ref=[11.0, 11.0])
    assert hv > 116.0


def test_spea2_anchor_through_the_port():
    """``tests/test_algorithms.py::test_spea2_selection``: SPEA2 keeps 16
    distinct points of a 64-point biobjective cloud, the first front
    among them when it fits; the same indices as JAX's."""
    jvals = jax.random.uniform(jax.random.PRNGKey(11), (64, 2))
    vals = torch.from_numpy(np.array(jvals))
    fit = tbase.Fitness(vals, torch.ones(64, dtype=torch.bool), (-1.0, -1.0))
    idx = temo.sel_spea2(None, fit, 16)
    assert len(np.unique(idx.numpy())) == 16
    ranks, _ = temo.nondominated_ranks(fit.masked_wvalues())
    first = set(np.nonzero(ranks.numpy() == 0)[0].tolist())
    if len(first) <= 16:
        assert first <= set(idx.numpy().tolist())
    want = jemo.sel_spea2(None, jbase.Fitness(
        jvals, jnp.ones(64, bool), (-1.0, -1.0)), 16)
    assert np.array_equal(idx.numpy(), np.asarray(want))
