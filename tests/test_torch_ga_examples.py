"""The port's GA / ES examples and the new benchmark suites against the
JAX package, on the CPU at a reduced depth.

Each example runs on both sides from the same seed: the JAX example as
published (its loop jitted, depth lowered through its own parameter or
module constant) and the port's counterpart (``device="cpu"``).  Held
bit for bit: the final genomes and fitness of tsp, nqueens, evoknn,
evoknn_jmlr, kursawefct and fctmin, and knn's accuracies (the port's
examples take the float32 forms XLA compiles for the JAX examples'
first evaluation and for their scanned generations, which differ for
tsp's leg sum and evoknn's feature share).  bbob: CMA-ES trajectories part within a few
generations (``eigh`` rounds differently under LAPACK and XLA),
so its first generation is held bit for bit on the functions whose XLA
form the port follows at that width and within ``VALUE_RTOL`` on the
others, and the whole table must be finite.

Then one generation of ``bench_nsga2.py``'s loop (bounded SBX,
polynomial mutation, ``sel_nsga2`` at its default) at pool 512 on DTLZ1
(3 objectives, k = 5) and on ZDT4 (x1 in [0, 1], the rest in [-5, 5],
per-gene bounds for both operators), teacher-forced from the JAX
population: offspring bitwise, values within ``VALUE_RTOL``, and the
selected indices equal on JAX's pool values.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import algorithms as jalg, base as jbase
from deap_tpu import benchmarks as jbench
from deap_tpu.ops import crossover as jcx, emo as jemo, mutation as jmut
from deap_tpu_torch import algorithms as talg, base as tbase, interop
from deap_tpu_torch import benchmarks as tbench
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import crossover as tcx, emo as temo
from deap_tpu_torch.ops import mutation as tmut

torch.set_num_threads(1)

VALUE_RTOL = 1e-6


def _leaves(g):
    if isinstance(g, dict):
        return [x for k in sorted(g) for x in _leaves(g[k])]
    return [g.numpy() if torch.is_tensor(g) else np.asarray(g)]


def _same(a, b):
    return all(np.array_equal(x.view(np.uint8), y.view(np.uint8))
               for x, y in zip(_leaves(a), _leaves(b)))


def _mods(name):
    return (importlib.import_module(f"examples.{name}"),
            importlib.import_module(f"deap_tpu_torch.examples.{name}"))


# name: (JAX call, port call, values bitwise)
EXAMPLES = {
    "ga.tsp": (lambda m: m.main(verbose=False, ngen=5)[0],
               lambda m: m.main(verbose=False, ngen=5, device="cpu")[0],
               True),
    "ga.nqueens": (lambda m: m.main(verbose=False)[0],
                   lambda m: m.main(verbose=False, ngen=5, device="cpu")[0],
                   True),
    "ga.evoknn": (lambda m: m.main(ngen=1, verbose=False)[0],
                  lambda m: m.main(ngen=1, verbose=False, device="cpu")[0],
                  True),
    "ga.evoknn_jmlr": (lambda m: m.main(ngen=2, verbose=False)[0],
                       lambda m: m.main(ngen=2, verbose=False,
                                        device="cpu")[0], True),
    "ga.kursawefct": (lambda m: m.main(verbose=False),
                      lambda m: m.main(verbose=False, ngen=5, device="cpu"),
                      True),
    "es.fctmin": (lambda m: m.main(verbose=False)[0],
                  lambda m: m.main(verbose=False, ngen=10, device="cpu")[0],
                  True),
}
JAX_DEPTH = {"ga.nqueens": 5, "ga.kursawefct": 5, "es.fctmin": 10}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_against_jax(name, monkeypatch):
    jm, tm = _mods(name)
    if name in JAX_DEPTH:
        monkeypatch.setattr(jm, "NGEN", JAX_DEPTH[name])
    jcall, tcall, values_bitwise = EXAMPLES[name]
    want, got = jcall(jm), tcall(tm)
    assert _same(want.genome, got.genome)
    jv, tv = np.asarray(want.fitness.values), got.fitness.values.numpy()
    if values_bitwise:
        np.testing.assert_array_equal(jv, tv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=VALUE_RTOL)
    assert bool(got.fitness.valid.all())


def test_example_quality_checks():
    """Each example's own check, on the port alone: tours stay
    permutations, the Kursawe front stays in bounds, the sphere falls."""
    from deap_tpu_torch.examples.es import fctmin
    from deap_tpu_torch.examples.ga import kursawefct, tsp
    pop, best = tsp.main(verbose=False, ngen=3, device="cpu")
    assert (np.sort(pop.genome.numpy(), 1) == np.arange(tsp.N_CITIES)).all()
    pop = kursawefct.main(verbose=False, ngen=3, device="cpu")
    assert bool((pop.genome.abs() <= kursawefct.BOUND).all())
    _, b0 = fctmin.main(verbose=False, ngen=1, device="cpu")
    _, b1 = fctmin.main(verbose=False, ngen=15, device="cpu")
    assert b1 < b0


def test_knn_accuracy_batched():
    jknn, tknn = _mods("ga.knn")
    X, y = jknn.make_dataset()
    tX, ty = tknn.make_dataset(device="cpu")
    np.testing.assert_array_equal(np.asarray(X), tX.numpy())
    masks = (np.random.default_rng(0).uniform(size=(64, 13)) < 0.5).astype(
        np.float32)
    masks[0] = 0.0                   # every distance 0: the first neighbour
    n = jknn.N_TRAIN
    want = jax.jit(jax.vmap(lambda f: jknn.knn_accuracy(
        f, X[:n], y[:n], X[n:], y[n:])))(masks)
    got = tknn.knn_accuracy(torch.from_numpy(masks), tX[:n], ty[:n], tX[n:],
                            ty[n:])
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for k in (3, 4):                 # a vote over several, ties to class 1
        want = jax.jit(jax.vmap(lambda f: jknn.knn_accuracy(
            f, X[:n], y[:n], X[n:], y[n:], k=k)))(masks)
        got = tknn.knn_accuracy(torch.from_numpy(masks), tX[:n], ty[:n],
                                tX[n:], ty[n:], k=k)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


# (name, dim): the first generation's best is bit for bit
BBOB_BITWISE_FIRST = {("bohachevsky", 5): False}


def test_bbob_first_generation_and_table(monkeypatch):
    jm, tm = _mods("bbob")
    monkeypatch.setattr(jm, "BUDGET_GENS", 1)
    for name in jm.SUITE:
        for dim in jm.DIMS:
            want = jm.run_problem(getattr(jbench, name), dim, 31)
            got = tm.run_problem(getattr(tbench, name), dim, 31, "cpu", 1)[1]
            if BBOB_BITWISE_FIRST.get((name, dim), True):
                assert got == want, (name, dim)
            else:
                assert got == pytest.approx(want, rel=VALUE_RTOL)
    table = tm.main(verbose=False, device="cpu", ngen=2)
    assert len(table) == len(tm.SUITE) * len(tm.DIMS)
    assert all(np.isfinite(v) for v in table.values())


# problem: (evaluate keywords, nobj, ndim, low, up)
SUITE_GENS = {
    "dtlz1": ({"obj": 3}, 3, 7, 0.0, 1.0),
    "zdt4": ({}, 2, 10, [0.0] + [-5.0] * 9, [1.0] + [5.0] * 9),
}
POOL = 512


@pytest.mark.parametrize("problem", sorted(SUITE_GENS))
def test_suite_generation_teacher_forced(problem):
    kw, nobj, ndim, low, up = SUITE_GENS[problem]
    n = POOL // 2
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    for tb, bench, cx, mut in ((jtb, jbench, jcx, jmut),
                               (ttb, tbench, tcx, tmut)):
        tb.register("evaluate", getattr(bench, problem), **kw)
        tb.register("mate", cx.cx_simulated_binary_bounded, low=low, up=up,
                    eta=20.0)
        tb.register("mutate", mut.mut_polynomial_bounded, low=low, up=up,
                    eta=20.0, indpb=1.0 / ndim)
    weights = (-1.0,) * nobj
    rng = np.random.default_rng(ndim)
    lo, hi = np.broadcast_to(low, ndim), np.broadcast_to(up, ndim)
    genome = (lo + (hi - lo) * rng.uniform(size=(n, ndim))).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    pop = jbase.Population(jnp.asarray(genome),
                           jbase.Fitness.empty(n, weights))
    pop, _ = jax.jit(lambda p: jalg.evaluate_population(jtb, p))(pop)

    def generation(key, pop):
        key, k_var, k_sel = jax.random.split(key, 3)
        g, _ = jalg.vary_genome(k_var, pop.genome, jtb, 0.9, 1.0,
                                pairing="halves")
        off = jbase.Population(g, jbase.Fitness.empty(n, weights))
        off, _ = jalg.evaluate_population(jtb, off)
        pool = pop.concat(off)
        return g, pool.fitness.values, jemo.sel_nsga2(k_sel, pool.fitness, n)

    off, pool_vals, sel = jax.jit(generation)(key, pop)
    k, k_var, k_sel = tr.split(interop.key_to_torch(np.asarray(key),
                                                    device="cpu"), 3)
    tg, _ = talg.vary_genome(k_var, torch.from_numpy(np.asarray(pop.genome)),
                             ttb, 0.9, 1.0, pairing="halves")
    assert _same(np.asarray(off), tg)
    assert bool(((tg >= torch.tensor(lo, dtype=torch.float32))
                 & (tg <= torch.tensor(hi, dtype=torch.float32))).all())
    toff = talg.evaluate_population(ttb, tbase.Population(
        tg, tbase.Fitness.empty(n, weights, device="cpu")))[0]
    np.testing.assert_allclose(toff.fitness.values.numpy(),
                               np.asarray(pool_vals)[n:], rtol=VALUE_RTOL,
                               atol=1e-6)
    fit = tbase.Fitness(torch.from_numpy(np.array(pool_vals)),
                        torch.ones(POOL, dtype=torch.bool), weights)
    np.testing.assert_array_equal(temo.sel_nsga2(k_sel, fit, n).numpy(),
                                  np.asarray(sel))
