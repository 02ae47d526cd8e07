"""The port's archives against the JAX package's.

``hof_update`` and ``pareto_update`` carry an archive through several
updates in both packages on the same seeded populations — integer
fitness values (ties are the rule), exact duplicate genomes and invalid
rows — and must stay bit for bit equal: genome, values and fill mask
(tolerance 0; every operation is a sort, a compare or a gather, and the
crowding distance is bitwise, ``tests/test_torch_emo.py``).  Also: an
archive carried across two ``ea_simple`` calls against the JAX
package's, one re-initialised on a change of genome shape, and
``MultiStatistics`` chapters in the logbook.
"""

from functools import partial

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
from deap_tpu_torch import base as tbase, interop, random as tr
from deap_tpu_torch.algorithms import ea_simple
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.utils import support as tsup

torch.set_num_threads(1)

UPDATES = 4


def _population(seed, n, dim, weights):
    """Genes from {0, 1, 2} (exact duplicate rows), integer fitness values
    from a small range (ties), about a fifth of the rows invalid."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 3, (n, dim)).astype(np.float32)
    genome[n // 2: n // 2 + 4] = genome[:4]
    values = rng.integers(0, 5, (n, len(weights))).astype(np.float32)
    valid = rng.random(n) > 0.2
    return genome, values, valid


def _jpop(genome, values, valid, weights):
    return jbase.Population(jnp.asarray(genome), jbase.Fitness(
        jnp.asarray(values), jnp.asarray(valid), tuple(weights)))


def _assert_archive_equal(jstate, tstate):
    np.testing.assert_array_equal(np.asarray(jstate.genome),
                                  tstate.genome.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.values),
                                  tstate.values.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.filled),
                                  tstate.filled.numpy())
    assert tuple(jstate.weights) == tstate.weights


def _run_both(j_update, t_update, j_init, t_init, maxsize, weights, n, dim):
    jstate = tstate = None
    for step in range(UPDATES):
        g, v, ok = _population(100 * maxsize + step, n, dim, weights)
        jp = _jpop(g, v, ok, weights)
        tp = interop.population_to_torch(g, v, ok, weights, device="cpu")
        if jstate is None:
            jstate, tstate = j_init(maxsize, jp), t_init(maxsize, tp)
            _assert_archive_equal(
                jstate, interop.archive_state_to_torch(jstate, device="cpu"))
        jstate = j_update(jstate, jp)
        tstate = t_update(tstate, tp)
        _assert_archive_equal(jstate, tstate)
    return tstate


@pytest.mark.parametrize("weights", [(1.0,), (-1.0, 1.0)])
@pytest.mark.parametrize("maxsize", [1, 7, 32])
@pytest.mark.parametrize("dedup", [True, False])
def test_hof_update_is_bitwise_to_jax(maxsize, weights, dedup):
    j_upd = jax.jit(partial(jsup.hof_update, dedup=dedup))
    t_upd = partial(tsup.hof_update, dedup=dedup)
    state = _run_both(j_upd, t_upd, jsup.hof_init, tsup.hof_init, maxsize,
                      weights, n=48, dim=3)
    assert bool(state.filled[0])
    if dedup:
        kept = state.genome[state.filled]
        assert len(torch.unique(kept, dim=0)) == len(kept)


@pytest.mark.parametrize("weights", [(-1.0, -1.0), (1.0, -1.0)])
@pytest.mark.parametrize("maxsize", [8, 32])
def test_pareto_update_is_bitwise_to_jax(maxsize, weights):
    state = _run_both(jax.jit(jsup.pareto_update), tsup.pareto_update,
                      jsup.pareto_init, tsup.pareto_init, maxsize, weights,
                      n=40, dim=3)
    assert bool(state.filled.any())


def test_hall_of_fame_wrappers():
    g, v, ok = _population(5, 30, 4, (1.0,))
    hof = tsup.HallOfFame(3)
    hof.update(interop.population_to_torch(g, v, ok, (1.0,), device="cpu"))
    assert len(hof) == 3
    genome, values = hof[0]
    assert genome.shape == (4,) and values.shape == (1,)
    assert values[0] == v[ok].max()
    assert [tuple(k) for k in hof.keys] == [tuple(x[1]) for x in hof]
    hof.clear()
    assert len(hof) == 0
    pf = tsup.ParetoFront(16)
    pf.update(interop.population_to_torch(g, np.c_[v, -v], ok, (1.0, 1.0),
                                          device="cpu"))
    assert len(pf) >= 1


def _onemax_toolboxes():
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
    return jtb, ttb


def _onemax_pops(seed, n, bits):
    g = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5,
                                        (n, bits)), np.float32)
    jp = jbase.Population(jnp.asarray(g), jbase.Fitness.empty(n, (1.0,)))
    tp = tbase.Population(torch.from_numpy(g),
                          tbase.Fitness.empty(n, (1.0,), device="cpu"))
    return jp, tp


def test_archive_carries_across_ea_simple_calls_as_in_jax():
    jtb, ttb = _onemax_toolboxes()
    jhof, thof = jsup.HallOfFame(5), tsup.HallOfFame(5)
    for call, seed in enumerate((1, 2)):
        jp, tp = _onemax_pops(seed, 32, 20)
        key = jax.random.PRNGKey(10 + call)
        j_ea_simple(key, jp, jtb, 0.5, 0.2, 3, halloffame=jhof)
        ea_simple(interop.key_to_torch(key, device="cpu"), tp, ttb, 0.5, 0.2,
                  3, halloffame=thof)
        _assert_archive_equal(jhof.state, thof.state)
    carried = thof.state

    # another genome width: the carried state is dropped, not mixed in
    jp, tp = _onemax_pops(3, 32, 12)
    key = tr.PRNGKey(4, device="cpu")
    ea_simple(key, tp, ttb, 0.5, 0.2, 3, halloffame=thof)
    fresh = tsup.HallOfFame(5)
    ea_simple(key, tp, ttb, 0.5, 0.2, 3, halloffame=fresh)
    assert thof.state.genome.shape == (5, 12)
    for a, b in ((thof.state.genome, fresh.state.genome),
                 (thof.state.values, fresh.state.values),
                 (thof.state.filled, fresh.state.filled)):
        assert torch.equal(a, b)
    assert carried.genome.shape == (5, 20)


def test_multistatistics_chapters_match_jax():
    jtb, ttb = _onemax_toolboxes()
    jstats = jsup.MultiStatistics(
        fitness=jsup.Statistics(lambda p: p.fitness.values[:, 0]),
        size=jsup.Statistics(lambda p: jnp.sum(p.genome, 1)))
    jstats.register("max", jnp.max)
    jstats.register("min", jnp.min)
    tstats = tsup.MultiStatistics(
        fitness=tsup.Statistics(lambda p: p.fitness.values[:, 0]),
        size=tsup.Statistics(lambda p: torch.sum(p.genome, 1)))
    tstats.register("max", torch.max)
    tstats.register("min", torch.min)
    assert tstats.fields == jstats.fields == ["fitness", "size"]
    jp, tp = _onemax_pops(7, 32, 16)
    key = jax.random.PRNGKey(8)
    _, jlog = j_ea_simple(key, jp, jtb, 0.5, 0.2, 4, stats=jstats)
    _, tlog = ea_simple(interop.key_to_torch(key, device="cpu"), tp, ttb,
                        0.5, 0.2, 4, stats=tstats)
    assert tlog.select("gen", "nevals") == jlog.select("gen", "nevals")
    for chapter in ("fitness", "size"):
        for field in ("max", "min"):
            assert (tlog.chapters[chapter].select(field)
                    == jlog.chapters[chapter].select(field))
    # the text differs only in generation 0's chapter cells, which the JAX
    # package leaves as arrays ("11.0") and the port as numbers ("11")
    assert "fitness" in str(tlog) and "size" in str(tlog)


def test_history_records_genealogy():
    hist = tsup.History()
    hist.update(torch.arange(6).reshape(3, 2))
    hist.update(np.arange(6).reshape(3, 2) + 10, parent_slots=[[0, 1], [2, 2],
                                                               [1, 0]])
    assert hist.genealogy_tree[4] == (1, 2)
    assert hist.genealogy_tree[5] == (3, 3)
    np.testing.assert_array_equal(hist.genealogy_history[6], [14, 15])
    assert hist.getGenealogy(6) == {6: [2, 1], 2: [], 1: []}
