"""The port's fourth slice end to end against the JAX package:
``bench_nsga2.py`` as published, and the hypervolume of its population.

The JAX side is the bench's own program under threefry keys: the
generation of ``bench_nsga2.py`` (``vary_genome(cxpb 0.9, mutpb 1.0,
pairing="halves")`` over bounded SBX and the polynomial bounded mutation,
evaluation, the (mu + lambda) pool, ``sel_nsga2(nd="auto",
front_chunk=1024)``) scanned and jitted as a whole, here at POP 128-200
for three generations, for both of its problems: DTLZ2 with 3 objectives
and 12 variables (A) and ZDT1 with 2 and 30 (B).

Teacher-forced: the JAX population of generation g goes into both
packages under the same key.  The offspring genomes must be bitwise
equal; the objective values agree within ``VALUE_RTOL`` = 1e-6 (torch's
``cos``/``sin`` and its sums differ from XLA's in the last bits); and
the port's selection, given the JAX pool's values, must return JAX's
indices exactly.  The hypervolume of the final population by the port's
toolbox slot equals the JAX package's host value within 1e-12.  Then
the port's own loop, alone: it follows its pieces, stays in bounds and
moves towards the front.
"""

import importlib

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
from deap_tpu_torch.ops import crossover as tcx, emo as temo
from deap_tpu_torch.ops import mutation as tmut

jhost = importlib.import_module("deap_tpu.ops.hv")

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

CONFIGS = {"A-dtlz2": ("dtlz2", 3, 12, 128, (1.1, 1.1, 1.1)),
           "B-zdt1": ("zdt1", 2, 30, 200, (11.0, 11.0))}
NGEN = 3
VALUE_RTOL = 1e-6


def _toolboxes(problem, nobj, ndim):
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


def _jax_run(jtb, pop_n, nobj, ndim, outputs: bool):
    """bench_nsga2.py's ``generation`` scanned NGEN times under ``jit``;
    with ``outputs`` every generation also returns its offspring, its
    selection, its pool's values and its new population."""
    weights = (-1.0,) * nobj

    def generation(carry, _):
        key, pop = carry
        key, k_var, k_sel = jax.random.split(key, 3)
        genome, _ = jalg.vary_genome(k_var, pop.genome, jtb, 0.9, 1.0,
                                     pairing="halves")
        off = jbase.Population(genome, jbase.Fitness.empty(pop_n, weights))
        off, _ = jalg.evaluate_population(jtb, off)
        pool = pop.concat(off)
        sel = jemo.sel_nsga2(k_sel, pool.fitness, pop_n, nd="auto",
                             front_chunk=1024)
        new = pool.take(sel)
        if outputs:
            return (key, new), (genome, sel, pool.fitness.values, new.genome,
                                new.fitness.values)
        return (key, new), jnp.min(new.fitness.values[:, 0])

    key = jax.random.PRNGKey(0)
    genome = jax.random.uniform(key, (pop_n, ndim), jnp.float32)
    pop = jbase.Population(genome, jbase.Fitness.empty(pop_n, weights))
    pop, _ = jalg.evaluate_population(jtb, pop)
    (_, final), ys = jax.jit(lambda k, p: lax.scan(
        generation, (k, p), None, length=NGEN))(key, pop)
    return key, pop, final, ys


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    problem, nobj, ndim, pop_n, ref = CONFIGS[request.param]
    jtb, ttb = _toolboxes(problem, nobj, ndim)
    key, pop0, final, ys = _jax_run(jtb, pop_n, nobj, ndim, outputs=True)
    _, _, published, _ = _jax_run(jtb, pop_n, nobj, ndim, outputs=False)
    return dict(problem=problem, nobj=nobj, ndim=ndim, n=pop_n, ref=ref,
                ttb=ttb, key=key, pop0=pop0, final=final, ys=ys,
                published=published)


def _bitwise(a, b):
    return np.array_equal(np.asarray(a).view(np.uint32),
                          np.asarray(b).view(np.uint32))


def test_extra_scan_outputs_leave_the_published_program_alone(runs):
    """The scan that also returns its intermediates ends where the
    bench's own scan (one scalar a generation) ends."""
    assert _bitwise(runs["final"].genome, runs["published"].genome)
    assert _bitwise(runs["final"].fitness.values,
                    runs["published"].fitness.values)


def test_teacher_forced_generations_match_jax(runs):
    n, nobj = runs["n"], runs["nobj"]
    ttb, weights = runs["ttb"], (-1.0,) * nobj
    offs, sels, pool_vals, pops, pop_vals = runs["ys"]
    k = interop.key_to_torch(runs["key"], device="cpu")
    genome = np.array(runs["pop0"].genome)
    for g in range(NGEN):
        k, k_var, k_sel = tr.split(k, 3)
        tg, touched = talg.vary_genome(k_var, torch.from_numpy(genome), ttb,
                                       0.9, 1.0, pairing="halves")
        assert _bitwise(tg.numpy(), offs[g])
        assert bool(touched.all())                       # mutpb = 1.0
        toff, nevals = talg.evaluate_population(ttb, tbase.Population(
            tg, tbase.Fitness.empty(n, weights, device="cpu")))
        assert int(nevals) == n
        np.testing.assert_allclose(toff.fitness.values.numpy(),
                                   np.asarray(pool_vals[g])[n:],
                                   rtol=VALUE_RTOL)
        fit = tbase.Fitness(torch.from_numpy(np.array(pool_vals[g])),
                            torch.ones(2 * n, dtype=torch.bool), weights)
        tsel = temo.sel_nsga2(k_sel, fit, n, nd="auto", front_chunk=1024)
        assert np.array_equal(tsel.numpy(), np.asarray(sels[g]))
        genome = np.array(pops[g])
    assert _bitwise(genome, runs["final"].genome)


def test_final_hypervolume_equals_jax_host_value(runs):
    """``tb.hypervolume(-wvalues, ref)`` of the final population, as the
    examples read it: the JAX package's host value within 1e-12."""
    final, ref = runs["final"], runs["ref"]
    wobj = -np.asarray(final.fitness.wvalues, np.float64)
    want = jhost.hypervolume(wobj, np.asarray(ref))
    fit = tbase.Fitness(torch.from_numpy(np.array(final.fitness.values)),
                        torch.ones(runs["n"], dtype=torch.bool),
                        (-1.0,) * runs["nobj"])
    got = runs["ttb"].hypervolume(-fit.wvalues, ref, device="cpu")
    assert got == pytest.approx(want, abs=1e-12)
    assert want > 0


def test_port_loop_alone_follows_its_pieces_and_improves(runs):
    """The port's own loop (no forcing), as ``chip_smoke.py`` drives it:
    each generation equals its pieces under the key law, the genome
    stays in [0, 1], every row is valid, and the hypervolume rises."""
    n, nobj, ndim, ref = runs["n"], runs["nobj"], runs["ndim"], runs["ref"]
    ttb, weights = runs["ttb"], (-1.0,) * nobj
    key = tr.PRNGKey(7, device="cpu")
    pop = talg.evaluate_population(ttb, tbase.Population(
        tr.uniform(key, (n, ndim)),
        tbase.Fitness.empty(n, weights, device="cpu")))[0]
    hv0 = ttb.hypervolume(-pop.fitness.wvalues, ref, device="cpu")
    for _ in range(8):
        key, k_var, k_sel = tr.split(key, 3)
        genome, _ = talg.vary_genome(k_var, pop.genome, ttb, 0.9, 1.0,
                                     pairing="halves")
        off = talg.evaluate_population(ttb, tbase.Population(
            genome, tbase.Fitness.empty(n, weights, device="cpu")))[0]
        pool = pop.concat(off)
        sel = temo.sel_nsga2(k_sel, pool.fitness, n, nd="auto",
                             front_chunk=1024)
        # nd="auto" is what the default nd="standard" means: the
        # staircase at two objectives, the count peel at three this
        # small; both select what the count peel selects
        assert torch.equal(sel, temo.sel_nsga2(k_sel, pool.fitness, n))
        assert torch.equal(sel, temo.sel_nsga2(k_sel, pool.fitness, n,
                                               nd="peel"))
        pop = pool.take(sel)
    assert bool(pop.fitness.valid.all())
    assert bool(((pop.genome >= 0) & (pop.genome <= 1)).all())
    hv1 = ttb.hypervolume(-pop.fitness.wvalues, ref, device="cpu")
    assert hv1 > hv0


@pytest.mark.parametrize("n", [64, 257])
def test_zdt1_matches_jax_within_rtol(n):
    x = np.random.default_rng(n).uniform(0, 1, (n, 30)).astype(np.float32)
    x[0] = 0.0
    x[1, 0] = 1.0
    want = np.asarray(jax.jit(jax.vmap(
        lambda g: jnp.stack(jbench.zdt1(g))))(jnp.asarray(x)))
    got = torch.func.vmap(lambda g: torch.stack(tbench.zdt1(g)))(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL, atol=1e-7)
    assert np.array_equal(got.numpy()[:, 0], x[:, 0])      # f1 is x0
