"""The port's NSGA-II slice end to end against the JAX package.

The slice is DEAP's NSGA-II loop: ``ea_mu_plus_lambda`` with
``sel_nsga2(nd="peel")`` on DTLZ2 (3 objectives, 12 variables), the
megakernel engine (``var_or`` through K3's path), here at mu = lambda =
256 with ``front_chunk=32``.

Teacher-forced: the JAX population of generation g goes into both
packages under the same key, for three generations.  The offspring
genomes must be bitwise equal; the DTLZ2 values agree within
``VALUE_RTOL`` = 1e-6 (torch's ``cos``/``sin`` differ from XLA's by up to
5 ulp, 3.5e-7 relative); and the port's selection, given the JAX pool's
values, must return JAX's indices exactly.  (On the port's own values the
selected set can come out in another order, which is why the values are
forced.)  Also: the port's loop equals its own pieces under the JAX key
law, the JAX loop equals the same pieces, port-only runs of both loops
move towards the front, the ``ea_ask`` NSGA-II head, and the 3-objective
interop round trip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import algorithms as jalg, base as jbase
from deap_tpu import benchmarks as jbench
from deap_tpu.ops import crossover as jcx, emo as jemo, mutation as jmut
from deap_tpu.ops import generation_pallas as gp
from deap_tpu_torch import algorithms as talg, base as tbase, interop
from deap_tpu_torch import benchmarks as tbench, kernels
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import crossover as tcx, emo as temo
from deap_tpu_torch.ops import mutation as tmut
from deap_tpu_torch.utils.support import Statistics

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

MU = LAMBDA = 256
NOBJ, NDIM = 3, 12
CXPB, MUTPB = 0.6, 0.3
FRONT_CHUNK = 32
VALUE_RTOL = 1e-6
WEIGHTS = (-1.0,) * NOBJ


def _jax_toolbox(engine="megakernel"):
    tb = jbase.Toolbox()
    tb.register("evaluate", jbench.dtlz2, obj=NOBJ)
    tb.register("mate", jcx.cx_two_point)
    tb.register("mutate", jmut.mut_gaussian, mu=0.0, sigma=0.1,
                indpb=1.0 / NDIM)
    tb.register("select", jemo.sel_nsga2, nd="peel",
                front_chunk=FRONT_CHUNK)
    tb.generation_engine = engine
    return tb


def _torch_toolbox(engine="megakernel"):
    tb = tbase.Toolbox()
    tb.register("evaluate", tbench.dtlz2, obj=NOBJ)
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_gaussian, mu=0.0, sigma=0.1,
                indpb=1.0 / NDIM)
    tb.register("select", temo.sel_nsga2, nd="peel",
                front_chunk=FRONT_CHUNK)
    tb.generation_engine = engine
    return tb


def _to_torch(pop):
    return interop.population_to_torch(
        np.asarray(pop.genome), np.asarray(pop.fitness.values),
        np.asarray(pop.fitness.valid), pop.fitness.weights, device="cpu")


def _jax_pop(n=MU, seed=0):
    g = np.random.default_rng(seed).uniform(0, 1, (n, NDIM)).astype(
        np.float32)
    pop = jbase.Population(jnp.asarray(g), jbase.Fitness.empty(n, WEIGHTS))
    return jalg.evaluate_population(_jax_toolbox(), pop)[0]


def _bitwise(a, b):
    return np.array_equal(np.asarray(a).view(np.uint32),
                          b.numpy().view(np.uint32))


def _distance(values) -> float:
    """DTLZ2's distance to its front: mean of ``|f|_2 - 1``."""
    v = torch.as_tensor(np.asarray(values), dtype=torch.float64)
    return float((v.norm(dim=1) - 1.0).mean())


def test_dtlz2_matches_jax_within_rtol():
    x = np.random.default_rng(3).uniform(0, 1, (512, NDIM)).astype(
        np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda g: jnp.stack(jbench.dtlz2(g, NOBJ))))(jnp.asarray(x)))
    got = torch.func.vmap(lambda g: torch.stack(tbench.dtlz2(g, NOBJ)))(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL)


def test_teacher_forced_generations_match_jax():
    jtb, ttb = _jax_toolbox(), _torch_toolbox()
    jpop = _jax_pop()
    key = jax.random.PRNGKey(123)
    for gen in range(3):
        tpop = _to_torch(jpop)
        tkey = interop.key_to_torch(key, device="cpu")
        # the loop's key law: one split before the loop, three per gen
        k = jax.random.split(key)[0]
        k, k_var, k_sel = jax.random.split(k, 3)
        tk = tr.split(tkey)[0]
        tk, tk_var, tk_sel = tr.split(tk, 3)
        assert np.array_equal(np.asarray(k_var),
                              interop.key_to_numpy(tk_var))

        joff = jalg.var_or(k_var, jpop, jtb, LAMBDA, CXPB, MUTPB)
        kernels.reset_launches()
        toff = talg.var_or(tk_var, tpop, ttb, LAMBDA, CXPB, MUTPB)
        assert _bitwise(joff.genome, toff.genome)

        joff, jn = jalg.evaluate_population(jtb, joff)
        toff, tn = talg.evaluate_population(ttb, toff)
        assert int(jn) == int(tn) == LAMBDA
        np.testing.assert_allclose(toff.fitness.values.numpy(),
                                   np.asarray(joff.fitness.values),
                                   rtol=VALUE_RTOL)

        jpool = jpop.concat(joff)
        jidx = np.asarray(jtb.select(k_sel, jpool.fitness, MU))
        tidx = ttb.select(tk_sel, _to_torch(jpool).fitness, MU)
        assert np.array_equal(tidx.numpy(), jidx)
        jpop = jpool.take(jnp.asarray(jidx))
        key = jax.random.fold_in(key, gen)


def test_loops_follow_the_key_law():
    """One generation of each package's ``ea_mu_plus_lambda`` follows
    the key law above.  The port's loop equals its own pieces.  The JAX
    loop jits its generation, whose DTLZ2 values (and so the order of
    selection) differ in the last bits from the eager pieces', so there
    the check is that every row it selects is a row of the pieces' pool:
    its offspring are the pieces' offspring."""
    jtb, ttb = _jax_toolbox(), _torch_toolbox()
    jpop = _jax_pop(seed=1)
    tpop = talg.evaluate_population(ttb, tbase.Population(
        _to_torch(jpop).genome,
        tbase.Fitness.empty(MU, WEIGHTS, device="cpu")))[0]
    key = jax.random.PRNGKey(9)
    jnext, _ = jalg.ea_mu_plus_lambda(key, jpop, jtb, MU, LAMBDA, CXPB,
                                      MUTPB, ngen=1)
    k = jax.random.split(key)[0]
    _, k_var, k_sel = jax.random.split(k, 3)
    joff = jalg.evaluate_population(
        jtb, jalg.var_or(k_var, jpop, jtb, LAMBDA, CXPB, MUTPB))[0]
    jpool = jpop.concat(joff)
    pool, nxt = np.asarray(jpool.genome), np.asarray(jnext.genome)
    nearest = pool[np.abs(nxt[:, None] - pool[None]).max(-1).argmin(1)]
    np.testing.assert_allclose(nxt, nearest, rtol=2.0 ** -22, atol=0)
    assert (nxt == nearest).all(1).mean() >= 0.95

    tkey = interop.key_to_torch(key, device="cpu")
    tnext, log = talg.ea_mu_plus_lambda(tkey, tpop, ttb, MU, LAMBDA, CXPB,
                                        MUTPB, ngen=1)
    tk = tr.split(tkey)[0]
    _, tk_var, tk_sel = tr.split(tk, 3)
    toff = talg.evaluate_population(
        ttb, talg.var_or(tk_var, tpop, ttb, LAMBDA, CXPB, MUTPB))[0]
    tpool = tpop.concat(toff)
    twant = tpool.take(ttb.select(tk_sel, tpool.fitness, MU))
    assert torch.equal(tnext.genome, twant.genome)
    assert torch.equal(tnext.fitness.values, twant.fitness.values)
    assert log.select("nevals") == [0, LAMBDA]


@pytest.mark.parametrize("plus", [True, False])
def test_port_loops_approach_the_front(plus):
    tb = _torch_toolbox()
    mu, lam = (128, 128) if plus else (128, 256)
    g = tr.uniform(tr.PRNGKey(4, device="cpu"), (mu, NDIM))
    pop = tbase.Population(g, tbase.Fitness.empty(mu, WEIGHTS, device="cpu"))
    stats = Statistics(lambda p: p.fitness.values)
    stats.register("dist", lambda v: (v.norm(dim=1) - 1.0).mean())
    loop = talg.ea_mu_plus_lambda if plus else talg.ea_mu_comma_lambda
    out, log = loop(tr.PRNGKey(5, device="cpu"), pop, tb, mu, lam, CXPB,
                    MUTPB, 8, stats=stats)
    dist = log.select("dist")
    assert len(dist) == 9 and dist[-1] < 0.7 * dist[0]
    assert tuple(out.genome.shape) == (mu, NDIM)
    assert out.fitness.valid.all()
    assert _distance(out.fitness.values) == pytest.approx(dist[-1],
                                                          rel=1e-5)


def test_mu_comma_lambda_needs_enough_offspring():
    tb = _torch_toolbox()
    pop = tbase.Population(torch.zeros(64, NDIM),
                           tbase.Fitness.empty(64, WEIGHTS, device="cpu"))
    with pytest.raises(AssertionError, match="lambda must be greater"):
        talg.ea_mu_comma_lambda(tr.PRNGKey(0, device="cpu"), pop, tb, 64,
                                32, CXPB, MUTPB, 1)


def test_ea_ask_nsga2_head_is_selection_then_k1():
    """The megakernel NSGA-II head keeps the registered selection: with
    no-op variation it is ``genome[sel_nsga2(...)]`` under ``ea_ask``'s
    key split; with variation it equals the JAX package's head bit for
    bit on the same values."""
    jtb, ttb = _jax_toolbox(), _torch_toolbox()
    jpop = _jax_pop(n=64, seed=2)
    tpop = _to_torch(jpop)
    key = jax.random.PRNGKey(21)
    tkey = interop.key_to_torch(key, device="cpu")
    _, off = talg.ea_ask(tkey, tpop, ttb, 0.0, 0.0)
    idx = temo.sel_nsga2(tr.split(tkey, 3)[1], tpop.fitness, 64,
                         nd="peel", front_chunk=FRONT_CHUNK)
    assert torch.equal(off.genome, tpop.genome[idx])
    assert not off.fitness.valid.any()

    jkey2, joff = jalg.ea_ask(key, jpop, jtb, 0.9, 0.5)
    tkey2, toff = talg.ea_ask(tkey, tpop, ttb, 0.9, 0.5)
    assert np.array_equal(np.asarray(jkey2), interop.key_to_numpy(tkey2))
    assert _bitwise(joff.genome, toff.genome)

    live = np.arange(64) < 40
    _, jlv = gp.fused_nsga2_step(key, jpop, jtb, 0.9, 0.5,
                                 live=jnp.asarray(live))
    _, tlv = talg.ea_ask(tkey, tpop, ttb, 0.9, 0.5,
                         live=torch.from_numpy(live))
    assert _bitwise(jlv.genome, tlv.genome)
    assert torch.equal(tlv.genome[40:], tpop.genome[40:])


def test_interop_round_trips_three_objectives():
    jpop = _jax_pop(n=32)
    values = np.asarray(jpop.fitness.values)
    assert values.shape == (32, 3)
    tpop = _to_torch(jpop)
    assert tpop.fitness.weights == WEIGHTS and tpop.fitness.nobj == 3
    g, v, ok, w = interop.population_to_numpy(tpop)
    assert np.array_equal(g, np.asarray(jpop.genome))
    assert np.array_equal(v, values) and ok.all() and w == WEIGHTS
    np.testing.assert_array_equal(
        tpop.fitness.masked_wvalues().numpy(),
        np.asarray(jpop.fitness.masked_wvalues()))
