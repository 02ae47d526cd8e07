"""BASELINE config 5 (neuroevolution) as the JAX example runs it, against
``examples/ga/evopole.py``.

Two generations of ``ea_simple`` at pop 16 from a typed rbg key (the
default of ``bench_evopole.py``): ``init_population``, the episode keys,
``sel_tournament(tournsize=3)``, the leaf-wise blend and Gaussian weight
mutation inside the generation loop, the 500-step rollouts, the
``Statistics`` columns and the ``HallOfFame(1)`` must all equal JAX's
bit for bit (tolerance 0).  Inside XLA's compiled generation the blend
fuses each child's product with its first parent into the add and the
mutation's add is fused under threefry2x32 keys but not under rbg keys;
``deap_tpu_torch.examples.ga.evopole`` follows both.  Also: the per-row
operator loop refuses rbg keys, which it cannot draw as jax's ``vmap``
does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.algorithms import ea_simple as j_ea_simple
from deap_tpu.ops import selection as jsel
from deap_tpu.utils import support as jsup
from deap_tpu_torch import base as tbase, interop, random as tr
from deap_tpu_torch._xla_math import row_mean
from deap_tpu_torch.algorithms import ea_simple, vary_genome
from deap_tpu_torch.examples.ga import evopole as T
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.utils import support as tsup
from examples.ga import evopole as E

torch.set_num_threads(1)

POP, NGEN = 16, 2


def _run_jax(key):
    key, k_init, k_eps = jax.random.split(key, 3)
    tb = jbase.Toolbox()
    tb.register("evaluate", E.make_evaluate(
        jax.random.split(k_eps, E.N_EPISODES)))
    tb.register("mate", E.mate_blend)
    tb.register("mutate", E.mut_gaussian_tree)
    tb.register("select", jsel.sel_tournament, tournsize=3)
    pop = jbase.Population(E.init_population(k_init, POP),
                           jbase.Fitness.empty(POP, (1.0,)))
    stats = jsup.Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", jnp.max)
    stats.register("avg", jnp.mean)
    hof = jsup.HallOfFame(1)
    pop, log = j_ea_simple(key, pop, tb, cxpb=E.CXPB, mutpb=E.MUTPB,
                           ngen=NGEN, stats=stats, halloffame=hof)
    return pop, log, hof


def _run_torch(key):
    key, k_init, k_eps = tr.split(key, 3)
    tb = tbase.Toolbox()
    tb.register("evaluate", T.make_evaluate(tr.split(k_eps, T.N_EPISODES)))
    tb.register("mate", T.mate_blend)
    tb.register("mutate", T.mut_gaussian_tree)
    tb.register("select", tsel.sel_tournament, tournsize=3)
    pop = tbase.Population(T.init_population(k_init, POP),
                           tbase.Fitness.empty(POP, (1.0,), device="cpu"))
    stats = tsup.Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("avg", row_mean)
    hof = tsup.HallOfFame(1)
    pop, log = ea_simple(key, pop, tb, cxpb=T.CXPB, mutpb=T.MUTPB,
                         ngen=NGEN, stats=stats, halloffame=hof)
    return pop, log, hof


def test_ea_simple_under_rbg_is_bitwise_to_jax():
    words = np.asarray([0, 42, 0, 42], np.uint32)       # PRNGKey(42), rbg
    jpop, jlog, jhof = _run_jax(
        jax.random.wrap_key_data(jnp.asarray(words), impl="rbg"))
    tpop, tlog, thof = _run_torch(interop.key_to_torch(words, device="cpu"))
    for k in ("b1", "b2", "w1", "w2"):
        np.testing.assert_array_equal(tpop.genome[k].numpy(),
                                      np.asarray(jpop.genome[k]), err_msg=k)
        np.testing.assert_array_equal(thof.state.genome[k].numpy(),
                                      np.asarray(jhof.state.genome[k]))
    np.testing.assert_array_equal(tpop.fitness.values.numpy(),
                                  np.asarray(jpop.fitness.values))
    for col in ("gen", "nevals", "max", "avg"):
        assert tlog.select(col) == jlog.select(col), col
    np.testing.assert_array_equal(thof.state.values.numpy(),
                                  np.asarray(jhof.state.values))
    assert thof[0][1][0] == max(tlog.select("max"))
    # the weights moved, and some episodes outlived the random start
    assert max(tlog.select("max")) > 50


def test_per_row_operator_loop_refuses_rbg_keys():
    tb = tbase.Toolbox()
    tb.register("mate", lambda k, a, b: T.mate_blend(k, a, b))
    tb.register("mutate", T.mut_gaussian_tree)
    g = T.init_population(tr.PRNGKey(0, impl="rbg", device="cpu"), 4)
    with pytest.raises(NotImplementedError, match="rbg"):
        vary_genome(tr.PRNGKey(1, impl="rbg", device="cpu"), g, tb, 1.0,
                    0.0)
    # threefry keys take the per-row loop, one call a row, as before
    out, _ = vary_genome(tr.PRNGKey(1, device="cpu"), g, tb, 1.0, 0.0)
    assert sorted(out) == ["b1", "b2", "w1", "w2"]
