"""The OneMax slice (BASELINE config 1) against the JAX package.

``mut_flip_bit`` must be bitwise to jitted JAX on float32, int8 and bool
genomes (a bool genome comes back int32 in both).  Then BASELINE config
1 as the canonical flow runs it — pop 300 x 100 bits, ``cx_two_point``,
``mut_flip_bit(indpb=0.05)``, ``sel_tournament(tournsize=3)``, cxpb 0.5,
mutpb 0.2, ``ea_simple`` with ``HallOfFame(1)`` and ``Statistics``
(max, avg) — for 10 generations in both packages from one key: the
population, every logbook column and the archive must be equal bit for
bit (tolerance 0: every fitness is an exact integer sum, and the average
is jax's sum times the float32 reciprocal of the count, which
``_xla_math.row_mean`` computes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.algorithms import ea_simple as j_ea_simple
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.utils import support as jsup
from deap_tpu_torch import base as tbase, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch._xla_math import row_mean
from deap_tpu_torch.algorithms import ea_simple
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.utils import support as tsup

torch.set_num_threads(1)

POP, BITS, NGEN = 300, 100, 10
CXPB, MUTPB = 0.5, 0.2


@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.bool_])
@pytest.mark.parametrize("indpb", [0.05, 0.5])
def test_mut_flip_bit_is_bitwise_to_jax(dtype, indpb):
    rng = np.random.default_rng(3)
    ind = (rng.random((POP, BITS)) < 0.5).astype(dtype)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jmut.mut_flip_bit, static_argnums=2)(
        key, jnp.asarray(ind), indpb))
    got = tmut.mut_flip_bit(interop.key_to_torch(key, device="cpu"),
                            torch.from_numpy(ind), indpb).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0 < np.mean(got != ind) < 1
    assert tmut.mut_flip_bit.batched is tmut.mut_flip_bit


def test_onemax_ea_simple_with_hall_of_fame_is_bitwise_to_jax():
    jtb = jbase.Toolbox()
    jtb.register("evaluate", lambda g: (jnp.sum(g),))
    jtb.register("mate", jcx.cx_two_point)
    jtb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
    jtb.register("select", jsel.sel_tournament, tournsize=3)
    ttb = tbase.Toolbox()
    ttb.register("evaluate", lambda g: (torch.sum(g),))
    ttb.register("mate", tcx.cx_two_point)
    ttb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    ttb.register("select", tsel.sel_tournament, tournsize=3)

    key = jax.random.PRNGKey(0)
    genome = np.asarray(jax.random.bernoulli(key, 0.5, (POP, BITS)),
                        np.float32)
    jstats = jsup.Statistics(lambda p: p.fitness.values[:, 0])
    jstats.register("max", jnp.max)
    jstats.register("avg", jnp.mean)
    tstats = tsup.Statistics(lambda p: p.fitness.values[:, 0])
    tstats.register("max", torch.max)
    tstats.register("avg", row_mean)
    jhof, thof = jsup.HallOfFame(1), tsup.HallOfFame(1)

    jpop, jlog = j_ea_simple(
        key, jbase.Population(jnp.asarray(genome),
                              jbase.Fitness.empty(POP, (1.0,))),
        jtb, CXPB, MUTPB, NGEN, stats=jstats, halloffame=jhof)
    tpop, tlog = ea_simple(
        interop.key_to_torch(key, device="cpu"),
        tbase.Population(torch.from_numpy(genome),
                         tbase.Fitness.empty(POP, (1.0,), device="cpu")),
        ttb, CXPB, MUTPB, NGEN, stats=tstats, halloffame=thof)

    np.testing.assert_array_equal(tpop.genome.numpy(),
                                  np.asarray(jpop.genome))
    np.testing.assert_array_equal(tpop.fitness.values.numpy(),
                                  np.asarray(jpop.fitness.values))
    for col in ("gen", "nevals", "max", "avg"):
        assert tlog.select(col) == jlog.select(col), col
    np.testing.assert_array_equal(thof.state.genome.numpy(),
                                  np.asarray(jhof.state.genome))
    np.testing.assert_array_equal(thof.state.values.numpy(),
                                  np.asarray(jhof.state.values))
    assert thof.state.filled.tolist() == [True]
    assert thof[0][1][0] == max(tlog.select("max"))
    assert tlog.select("max")[-1] > tlog.select("max")[0]


def test_onemax_under_rbg_is_bitwise_to_jax():
    """``bench_onemax.py``'s default key implementation: three generations
    of BASELINE config 1 from a typed rbg key, population and logbook
    bitwise."""
    jtb = jbase.Toolbox()
    jtb.register("evaluate", lambda g: (jnp.sum(g),))
    jtb.register("mate", jcx.cx_two_point)
    jtb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
    jtb.register("select", jsel.sel_tournament, tournsize=3)
    ttb = tbase.Toolbox()
    ttb.register("evaluate", lambda g: (torch.sum(g),))
    ttb.register("mate", tcx.cx_two_point)
    ttb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    ttb.register("select", tsel.sel_tournament, tournsize=3)

    words = np.asarray([0, 0, 0, 0], np.uint32)      # PRNGKey(0) under rbg
    jkey = jax.random.wrap_key_data(jnp.asarray(words), impl="rbg")
    tkey = interop.key_to_torch(words, device="cpu")
    genome = np.asarray(jax.random.bernoulli(jkey, 0.5, (POP, BITS)),
                        np.float32)
    np.testing.assert_array_equal(
        tr.bernoulli(tkey, 0.5, (POP, BITS)).numpy(), genome.astype(bool))
    jstats = jsup.Statistics(lambda p: p.fitness.values[:, 0])
    jstats.register("max", jnp.max)
    tstats = tsup.Statistics(lambda p: p.fitness.values[:, 0])
    tstats.register("max", torch.max)
    jpop, jlog = j_ea_simple(
        jkey, jbase.Population(jnp.asarray(genome),
                               jbase.Fitness.empty(POP, (1.0,))),
        jtb, CXPB, MUTPB, 3, stats=jstats)
    tpop, tlog = ea_simple(
        tkey, tbase.Population(torch.from_numpy(genome),
                               tbase.Fitness.empty(POP, (1.0,),
                                                   device="cpu")),
        ttb, CXPB, MUTPB, 3, stats=tstats)
    np.testing.assert_array_equal(tpop.genome.numpy(),
                                  np.asarray(jpop.genome))
    np.testing.assert_array_equal(tpop.fitness.values.numpy(),
                                  np.asarray(jpop.fitness.values))
    for col in ("nevals", "max"):
        assert tlog.select(col) == jlog.select(col), col
