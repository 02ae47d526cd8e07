"""The port's GP slice end to end against the JAX package: ``bench_gp.py``'s
configuration (symbolic regression of x^4 + x^3 + x^2 + x) at a small size.

Teacher-forced: the JAX population at generation g goes into both
packages' bench generation (``sel_tournament(3)`` with random tie-break,
``var_and(0.5, 0.1, pairing="halves")`` with ``cx_one_point`` and
``mut_uniform`` over ``full`` subtrees of depth 0-2, then
``evaluate_population`` through a registered
``toolbox.evaluate_population(genome, skip=...)``) under the same key.
Selection indices are equal, the varied trees are bitwise, and the MSE
fitness agrees within ``FITNESS_RTOL``: the tree values are bitwise (see
``tests/test_torch_gp.py``), but the user's ``mean`` reduces in another
order than ``jnp.mean`` (XLA sums in windows of 32).  Also: the
``ea_simple`` loop on the CPU with the best MSE falling.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, gp as jgp
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu.algorithms import var_and as j_var_and
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import base as tbase, gp as tgp, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.algorithms import ea_simple
from deap_tpu_torch.algorithms import evaluate_population as t_eval
from deap_tpu_torch.algorithms import var_and as t_var_and
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.utils.support import Statistics

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

POP, CAP, NPOINTS = 64, 32, 128
CXPB, MUTPB = 0.5, 0.1
FITNESS_RTOL = 1e-5


def _jax_toolbox():
    ps = jgp.PrimitiveSet("MAIN", 1)
    for f, a, n in ((jnp.add, 2, "add"), (jnp.subtract, 2, "sub"),
                    (jnp.multiply, 2, "mul"), (jgp.protected_div, 2, "div"),
                    (jnp.negative, 1, "neg"), (jnp.cos, 1, "cos"),
                    (jnp.sin, 1, "sin")):
        ps.add_primitive(f, a, name=n)
    ps.add_ephemeral_constant(
        "rand101",
        lambda key: jax.random.randint(key, (), -1, 2).astype(jnp.float32))
    X = jnp.linspace(-1, 1, NPOINTS, dtype=jnp.float32)[None, :]
    target = X[0] ** 4 + X[0] ** 3 + X[0] ** 2 + X[0]
    pop_ev = jgp.make_population_evaluator(ps, CAP, backend="xla")
    gen_mut = jgp.make_generator(ps, CAP, "full")

    def evaluate_all(genome, skip=None):
        codes, consts, lengths = genome
        if skip is not None:
            lengths = jnp.where(skip, 0, lengths)
        out = pop_ev(codes, consts, lengths, X)
        mse = jnp.mean((out - target[None, :]) ** 2, axis=1)
        return jnp.where(jnp.isfinite(mse), mse, 1e6)[:, None]

    tb = jbase.Toolbox()
    tb.register("evaluate_population", evaluate_all)
    tb.register("mate", lambda k, a, b: jgp.cx_one_point(k, a, b, ps))
    tb.register("mutate", lambda k, t: jgp.mut_uniform(
        k, t, lambda kk: gen_mut(kk, 0, 2), ps))
    tb.register("select", jsel.sel_tournament, tournsize=3)
    return ps, tb


def _torch_toolbox():
    """The bench's toolbox in the port: the GP operators are registered
    with their ``rowwise_op`` mark intact (no lambda around them)."""
    ps = tgp.PrimitiveSet("MAIN", 1)
    for f, a, n in ((torch.add, 2, "add"), (torch.subtract, 2, "sub"),
                    (torch.multiply, 2, "mul"), (tgp.protected_div, 2, "div"),
                    (torch.negative, 1, "neg"), (tgp.cos, 1, "cos"),
                    (tgp.sin, 1, "sin")):
        ps.add_primitive(f, a, name=n)
    ps.add_ephemeral_constant(
        "rand101", lambda keys: tr.randint(keys, (), -1, 2).float())
    X = torch.linspace(-1, 1, NPOINTS, dtype=torch.float32)[None, :]
    x = X[0]
    target = x ** 4 + x ** 3 + x ** 2 + x
    pop_ev = tgp.make_population_evaluator(ps, CAP)
    gen_mut = tgp.make_generator(ps, CAP, "full")

    def evaluate_all(genome, skip=None):
        codes, consts, lengths = genome
        if skip is not None:
            lengths = torch.where(skip, 0, lengths)
        out = pop_ev(codes, consts, lengths, X.to(codes.device))
        mse = ((out - target.to(out.device)[None, :]) ** 2).mean(dim=1)
        return torch.where(torch.isfinite(mse), mse, 1e6)[:, None]

    tb = tbase.Toolbox()
    tb.register("evaluate_population", evaluate_all)
    tb.register("mate", tgp.cx_one_point, pset=ps)
    tb.register("mutate", tgp.mut_uniform,
                expr=lambda kk: gen_mut(kk, 0, 2), pset=ps)
    tb.register("select", tsel.sel_tournament, tournsize=3)
    return ps, tb, pop_ev


def _jax_initial():
    ps, tb = _jax_toolbox()
    gen_init = jgp.make_generator(ps, CAP, "half_and_half")
    key, k_init = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(k_init, POP)
    genome = jax.jit(jax.vmap(lambda k: gen_init(k, 1, 3)))(keys)
    pop = jbase.Population(genome, jbase.Fitness.empty(POP, (-1.0,)))
    pop, _ = j_eval(tb, pop)
    return tb, key, pop


def _to_torch(pop):
    return interop.population_to_torch(
        tuple(np.asarray(x) for x in pop.genome),
        np.asarray(pop.fitness.values), np.asarray(pop.fitness.valid),
        pop.fitness.weights, device="cpu")


def _jax_generation(tb):
    @jax.jit
    def generation(key, pop):
        key, k_sel, k_var = jax.random.split(key, 3)
        idx = tb.select(k_sel, pop.fitness, POP)
        off = j_var_and(k_var, pop.take(idx), tb, CXPB, MUTPB,
                        pairing="halves")
        off, _ = j_eval(tb, off)
        return key, off, idx
    return generation


def _torch_generation(tb, key, pop):
    key, k_sel, k_var = tr.split(key, 3)
    idx = tb.select(k_sel, pop.fitness, POP)
    off = t_var_and(k_var, pop.take(idx), tb, CXPB, MUTPB, pairing="halves")
    off, _ = t_eval(tb, off)
    return key, off, idx


def test_initial_population_matches_jax():
    jtb, jkey, jpop = _jax_initial()
    ps, ttb, pop_ev = _torch_toolbox()
    gen_init = tgp.make_generator(ps, CAP, "half_and_half")
    key, k_init = tr.split(tr.PRNGKey(0, device="cpu"))
    genome = gen_init(tr.split(k_init, POP), 1, 3)
    assert all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(jpop.genome, genome))
    pop, nevals = t_eval(ttb, tbase.Population(
        genome, tbase.Fitness.empty(POP, (-1.0,), device="cpu")))
    assert int(nevals) == POP and pop_ev.last_backend == "plain"
    np.testing.assert_allclose(pop.fitness.values.numpy(),
                               np.asarray(jpop.fitness.values),
                               rtol=FITNESS_RTOL)
    assert np.array_equal(np.asarray(jkey), interop.key_to_numpy(key))


@pytest.mark.parametrize("ngen", [1, 3])
def test_teacher_forced_bench_generations_match_jax(ngen):
    jtb, key, jpop = _jax_initial()
    _, ttb, _ = _torch_toolbox()
    generation = _jax_generation(jtb)
    skipped = []
    inner = ttb.evaluate_population

    def spy(genome, skip=None):
        skipped.append(float(skip.float().mean()))
        return inner(genome, skip=skip)

    ttb.register("evaluate_population", spy)
    for _ in range(ngen):
        tpop = _to_torch(jpop)
        tkey = interop.key_to_torch(key, device="cpu")
        jkey, jnext, jidx = generation(key, jpop)
        tkey2, tnext, tidx = _torch_generation(ttb, tkey, tpop)
        assert np.array_equal(np.asarray(jkey), interop.key_to_numpy(tkey2))
        assert np.array_equal(np.asarray(jidx), tidx.numpy())
        for a, b in zip(jnext.genome, tnext.genome):
            assert np.array_equal(np.asarray(a), b.numpy())
        np.testing.assert_allclose(tnext.fitness.values.numpy(),
                                   np.asarray(jnext.fitness.values),
                                   rtol=FITNESS_RTOL)
        assert tnext.fitness.valid.all()
        key, jpop = jkey, jnext
    assert len(skipped) == ngen and min(skipped) > 0.2   # rows skipped


def test_evaluate_population_skips_valid_rows():
    """``skip=fitness.valid`` reaches the registered evaluator, whose
    skipped rows run no stack-machine step and keep their fitness."""
    _, tb, pop_ev = _torch_toolbox()
    seen = {}
    inner = tb.evaluate_population

    def spy(genome, skip=None):
        seen["skip"] = skip.clone()
        return inner(genome, skip=skip)[:, 0]          # a 1-D result

    tb.register("evaluate_population", spy)
    jtb, key, jpop = _jax_initial()
    pop = _to_torch(jpop)
    valid = torch.arange(POP) % 2 == 0
    pop = tbase.Population(pop.genome, tbase.Fitness(
        values=torch.full((POP, 1), 7.0), valid=valid, weights=(-1.0,)))
    out, nevals = t_eval(tb, pop)
    assert torch.equal(seen["skip"], valid) and int(nevals) == POP // 2
    assert (out.fitness.values[valid] == 7.0).all()
    assert out.fitness.values.shape == (POP, 1) and out.fitness.valid.all()


def test_ea_simple_on_cpu_lowers_best_mse():
    ps, tb, pop_ev = _torch_toolbox()
    gen_init = tgp.make_generator(ps, CAP, "half_and_half")
    key, k_init = tr.split(tr.PRNGKey(5, device="cpu"))
    pop = tbase.Population(gen_init(tr.split(k_init, POP), 1, 3),
                           tbase.Fitness.empty(POP, (-1.0,), device="cpu"))
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    final, log = ea_simple(key, pop, tb, CXPB, MUTPB, 6, stats=stats)
    best = log.select("min")
    assert best[-1] < best[0]
    assert final.fitness.valid.all() and pop_ev.last_backend == "plain"
    assert [x.shape for x in final.genome] == [(POP, CAP), (POP, CAP),
                                               (POP,)]
