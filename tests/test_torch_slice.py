"""The port's GA slice end to end against the JAX package.

Teacher-forced: the JAX population at generation g goes into both
packages' ``ea_step`` under the same key, for three generations of the
megakernel engine.  Rows whose own tournament winner and whose partner's
winner agree in both packages must match within ``GENOME_ABS_TOL`` (they
match bit for bit: 0), such rows must be at least 95% of the population
(the positions are bitwise, so they are all of it), and the fitness
agrees within rtol 1e-5 (``torch.cos`` and XLA's ``cos`` differ in the
last bits).  Also: the live-mask (serving) step, a short ``ea_simple`` of
the port alone, the engine registry and the device rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, benchmarks as jbench
from deap_tpu.algorithms import ea_step as j_ea_step
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import generation_pallas as gp
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import NoCudaDevice, interop
from deap_tpu_torch import base as tbase, benchmarks as tbench
from deap_tpu_torch import random as tr
from deap_tpu_torch.algorithms import (ea_ask, ea_simple, ea_step,
                                       evaluate_population)
from deap_tpu_torch.engines import (EngineError, EngineNotPorted,
                                    resolve_engine)
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import generation as tg
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.probes import ga as probes_ga, gp as probes_gp
from deap_tpu_torch.utils.support import Statistics

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

POP, DIM = 1024, 100
GENOME_ABS_TOL = 0.0
CXPB, MUTPB = 0.9, 0.5


def _jax_toolbox(storage=None):
    tb = jbase.Toolbox()
    tb.register("evaluate", jbench.rastrigin)
    tb.register("mate", jcx.cx_two_point)
    tb.register("mutate", jmut.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.05)
    tb.register("select", jsel.sel_tournament, tournsize=3, tie_break="rank")
    tb.generation_engine = "megakernel"
    if storage is not None:
        tb.genome_storage = storage
    return tb


def _torch_toolbox(storage=None, engine="megakernel"):
    tb = tbase.Toolbox()
    tb.register("evaluate", tbench.rastrigin)
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3, tie_break="rank")
    tb.generation_engine = engine
    if storage is not None:
        tb.genome_storage = storage
    return tb


def _jax_pop(dtype="float32", bound=0.0, seed=0):
    key = jax.random.PRNGKey(seed)
    g = jax.random.uniform(key, (POP, DIM), jnp.float32, -5.12, 5.12)
    storage = None
    if dtype != "float32":
        storage = gp.GenomeStorage(dtype, bound)
        g = storage.to_storage(g)
    tb = _jax_toolbox(storage)
    pop = jbase.Population(g, jbase.Fitness.empty(POP, (-1.0,)))
    pop, _ = j_eval(tb, pop)
    return tb, pop


def _to_torch(pop):
    return interop.population_to_torch(np.asarray(pop.genome),
                                       np.asarray(pop.fitness.values),
                                       np.asarray(pop.fitness.valid),
                                       pop.fitness.weights, device="cpu")


@pytest.mark.parametrize("dtype,bound", [("float32", 0.0),
                                         ("bfloat16", 0.0), ("int8", 5.12)])
def test_teacher_forced_generations_match_jax(dtype, bound):
    jtb, jpop = _jax_pop(dtype, bound)
    ttb = _torch_toolbox(None if dtype == "float32"
                         else tg.GenomeStorage(dtype, bound))
    key = jax.random.PRNGKey(123)
    for gen in range(3):
        tpop = _to_torch(jpop)
        tkey = interop.key_to_torch(key, device="cpu")
        # winners of both packages under this generation's selection key
        k_sel = jax.random.split(key, 3)[1]
        jw = np.asarray(jsel.sel_tournament(k_sel, jpop.fitness, POP, 3,
                                            tie_break="rank"))
        tw = tsel.sel_tournament(tr.split(tkey, 3)[1], tpop.fitness, POP, 3,
                                 tie_break="rank").numpy()
        same = jw == tw
        rows_ok = same & same[np.arange(POP) ^ 16]
        assert rows_ok.mean() >= 0.95
        assert rows_ok.all()                  # positions are bitwise

        jkey, jnext, jn = j_ea_step(key, jpop, jtb, CXPB, MUTPB)
        tkey2, tnext, tn = ea_step(tkey, tpop, ttb, CXPB, MUTPB)
        assert np.array_equal(np.asarray(jkey),
                              interop.key_to_numpy(tkey2))
        assert int(jn) == int(tn) == POP
        jg = np.asarray(jtb.genome_storage.to_compute(jnext.genome)
                        if dtype != "float32" else jnext.genome)
        tgen = (ttb.genome_storage.to_compute(tnext.genome)
                if dtype != "float32" else tnext.genome).numpy()
        assert np.abs(jg[rows_ok] - tgen[rows_ok]).max() <= GENOME_ABS_TOL
        np.testing.assert_allclose(tnext.fitness.values.numpy(),
                                   np.asarray(jnext.fitness.values),
                                   rtol=1e-5)
        assert tnext.fitness.valid.all()
        key, jpop = jkey, jnext


def test_live_mask_step_matches_jax():
    """The serving step: a live prefix routes through K1's path (host
    gather), pads stay frozen, and the live rows equal the JAX package's."""
    jtb, jpop = _jax_pop(seed=4)
    ttb = _torch_toolbox()
    live_n = POP - 96
    jlive = jnp.arange(POP) < live_n
    tlive = torch.arange(POP) < live_n
    key = jax.random.PRNGKey(9)
    _, jnext, jn = j_ea_step(key, jpop, jtb, CXPB, MUTPB, live=jlive)
    tpop = _to_torch(jpop)
    _, tnext, tn = ea_step(interop.key_to_torch(key, device="cpu"), tpop,
                           ttb, CXPB, MUTPB, live=tlive)
    assert int(jn) == int(tn) == live_n
    assert np.array_equal(np.asarray(jnext.genome),
                          tnext.genome.numpy())
    assert torch.equal(tnext.genome[live_n:], tpop.genome[live_n:])
    assert not tnext.fitness.valid[live_n:].any()
    assert np.array_equal(np.asarray(jnext.fitness.valid),
                          tnext.fitness.valid.numpy())


@pytest.mark.parametrize("engine", ["megakernel", "xla"])
def test_ea_simple_converges(engine):
    tb = _torch_toolbox(engine=engine)
    key = tr.PRNGKey(1, device="cpu")
    n = 256
    g = tr.uniform(key, (n, DIM), minval=-5.12, maxval=5.12)
    pop = tbase.Population(g, tbase.Fitness.empty(n, (-1.0,), device="cpu"))
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    stats.register("avg", torch.mean)
    out, log = ea_simple(key, pop, tb, CXPB, MUTPB, 15, stats=stats)
    mins = log.select("min")
    assert len(log) == 16 and mins[-1] < 0.8 * mins[0]
    assert log.select("gen") == list(range(16))
    assert tuple(out.genome.shape) == (n, DIM)
    assert torch.isfinite(out.fitness.values).all()
    assert "min" in log.stream


def test_engine_registry_rejections(tmp_path):
    tb = _torch_toolbox()
    assert resolve_engine(tb) == "megakernel"
    tb.generation_engine = "scan"
    assert resolve_engine(tb) == "xla"
    tb.generation_engine = "warp"
    with pytest.raises(EngineError, match="generation_engine"):
        resolve_engine(tb)
    tb.generation_engine = "megakernel_sharded"
    with pytest.raises(EngineError, match="generation_mesh"):
        resolve_engine(tb)
    key = tr.PRNGKey(0, device="cpu")
    pop = tbase.Population(torch.zeros(64, DIM),
                           tbase.Fitness.empty(64, (-1.0,), device="cpu"))
    tb.generation_engine = "megakernel"
    # megakernel + a mesh is the sharded engine, which now runs: on a
    # one-rank mesh it equals the single-device generation
    import _torch_dist_cases
    with _torch_dist_cases.one_rank_mesh(tmp_path) as mesh:
        tb.generation_mesh = mesh
        assert resolve_engine(tb) == "megakernel_sharded"
        g = tr.uniform(key, (64, DIM), minval=-5.12, maxval=5.12)
        pop = tbase.Population(g, tbase.Fitness.empty(64, (-1.0,),
                                                      device="cpu"))
        _, got = ea_ask(key, pop, tb, CXPB, MUTPB)
        del tb.generation_mesh
        _, want = ea_ask(key, pop, tb, CXPB, MUTPB)
        assert torch.equal(got.genome, want.genome)
        tb.generation_mesh = mesh
    tb.generation_engine = "streamed"
    with pytest.raises(EngineError, match="generation_mesh"):
        resolve_engine(tb)
    del tb.generation_mesh
    # the streamed engine (deap_tpu_torch.bigpop) runs ea_simple's
    # trajectory: equal to the xla engine's
    got, got_log = ea_simple(key, pop, tb, CXPB, MUTPB, 2)
    tb.generation_engine = "xla"
    want, want_log = ea_simple(key, pop, tb, CXPB, MUTPB, 2)
    assert torch.equal(got.genome, want.genome)
    assert torch.equal(got.fitness.values, want.fitness.values)
    assert got_log.select("nevals") == want_log.select("nevals")
    assert issubclass(EngineNotPorted, ValueError)
    assert issubclass(EngineNotPorted, NotImplementedError)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tr.PRNGKey(0)
    with pytest.raises(NoCudaDevice):
        tbase.Fitness.empty(4, (1.0,))
    key = np.asarray(jax.random.PRNGKey(3))
    genome = np.zeros((4, 2), np.float32)
    with pytest.raises(NoCudaDevice):
        interop.key_to_torch(key)
    with pytest.raises(NoCudaDevice):
        interop.genome_to_torch(genome)
    with pytest.raises(NoCudaDevice):
        interop.population_to_torch(genome, np.zeros((4, 1)), np.ones(4, bool),
                                    (1.0,))
    # the probe tools default to the card as well: --device cpu is asked
    with pytest.raises(NoCudaDevice):
        probes_ga.main(["stream", "--pop", "64"])
    with pytest.raises(NoCudaDevice):
        probes_gp.main(["noswitch"])
    assert tr.PRNGKey(0, device="cpu").device.type == "cpu"


def test_evaluate_population_assigns_only_invalid_rows():
    tb = _torch_toolbox()
    g = tr.uniform(tr.PRNGKey(2, device="cpu"), (64, DIM), minval=-1,
                   maxval=1)
    fit = tbase.Fitness(values=torch.full((64, 1), 7.0),
                        valid=torch.arange(64) < 10, weights=(-1.0,))
    pop, nevals = evaluate_population(tb, tbase.Population(g, fit))
    assert int(nevals) == 54
    assert torch.equal(pop.fitness.values[:10], torch.full((10, 1), 7.0))
    ref = np.asarray(jax.vmap(lambda x: jbench.rastrigin(x)[0])(
        jnp.asarray(g[10:].numpy())))
    np.testing.assert_allclose(pop.fitness.values[10:, 0].numpy(), ref,
                               rtol=1e-5)
    assert pop.fitness.valid.all()


def test_interop_round_trips_every_storage_dtype():
    """numpy state from the JAX package → the port → numpy, unchanged;
    bfloat16 travels as its bit pattern."""
    for dtype, bound in (("float32", 0.0), ("bfloat16", 0.0), ("int8", 5.12)):
        js = gp.GenomeStorage(dtype, bound)
        g = js.to_storage(jax.random.uniform(jax.random.PRNGKey(1), (64, 8),
                                             jnp.float32, -5, 5))
        vals = np.arange(64, dtype=np.float32)[:, None]
        valid = np.arange(64) % 3 == 0
        tpop = interop.population_to_torch(np.asarray(g), vals, valid,
                                           (-1.0,), device="cpu")
        assert tpop.genome.dtype == interop.storage_to_torch(js).torch_dtype
        g2, v2, ok2, w2 = interop.population_to_numpy(tpop)
        want = np.asarray(g).view(np.uint16) if dtype == "bfloat16" \
            else np.asarray(g)
        assert np.array_equal(g2, want) and np.array_equal(v2, vals)
        assert np.array_equal(ok2, valid) and w2 == (-1.0,)
    key = jax.random.PRNGKey(77)
    assert np.array_equal(
        interop.key_to_numpy(interop.key_to_torch(key, device="cpu")),
        np.asarray(key))



def test_megakernel_generation_under_rbg_matches_jax():
    """One megakernel generation from an rbg key (``bench.py``'s default):
    the selection's uniforms come from ``rng_bit_generator`` and K1/K2's
    seed from the rbg key's words; the offspring are bitwise to JAX's
    and the fitness within rtol 1e-5, as under threefry."""
    jtb, jpop = _jax_pop()
    ttb = _torch_toolbox()
    words = np.asarray([0xDEADBEEF, 0x12345678, 0xFFFFFFFF, 0xFFFFFFFE],
                       np.uint32)
    jkey = jax.random.wrap_key_data(jnp.asarray(words), impl="rbg")
    tkey = interop.key_to_torch(words, device="cpu")
    assert tr.impl_of(tkey) == "rbg"
    jkey2, jnext, jn = j_ea_step(jkey, jpop, jtb, CXPB, MUTPB)
    tkey2, tnext, tn = ea_step(tkey, _to_torch(jpop), ttb, CXPB, MUTPB)
    assert np.array_equal(np.asarray(jax.random.key_data(jkey2)),
                          interop.key_to_numpy(tkey2))
    assert int(jn) == int(tn) == POP
    np.testing.assert_array_equal(tnext.genome.numpy(),
                                  np.asarray(jnext.genome))
    np.testing.assert_allclose(tnext.fitness.values.numpy(),
                               np.asarray(jnext.fitness.values), rtol=1e-5)
