"""deap_tpu_torch.bigpop (the streamed, out-of-core engine) against the
JAX package, on the CPU at ``tests/test_bigpop.py``'s sizes (n = 48, dim
= 12, slices of 16).

The oracle is JAX's *jitted resident* step (``jax.jit(ea_step)``) and its
resident ``ea_simple``, not the JAX streamed engine: that engine
regenerates jax's non-partitionable counter layout and refuses to run
under jax's default, partitionable one, the only layout the port's keys
implement.  Its contract, a streamed generation equal to the resident
one at the same pop and key, is what the port is held to: genome,
values, validity, key and ``nevals`` bit for bit, tolerance 0, for
float32, bfloat16 and int8 storage.  The evaluator sums the genes
rounded to eighths, whole numbers that both packages add exactly in
any order, so a difference in a value can only come from a genome.

Also: the sliced draws against whole ``jax.random`` draws (tails of 1–7
rows and a slice of ``dim`` rows included), the chunked host store
against JAX's, a mid-generation preemption and resume, the fault
injector's checkpoint failures and poisoned evaluation, and the engine's
refusals.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.algorithms import ea_ask as j_ea_ask, ea_step as j_ea_step
from deap_tpu.algorithms import ea_simple as j_ea_simple
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu.bigpop.host import HostPopulation as JHostPopulation
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.ops.generation_pallas import GenomeStorage as JStorage
from deap_tpu.resilience.faultinject import FaultInjector as JFaultInjector
from deap_tpu.resilience.faultinject import FaultPlan as JFaultPlan
from deap_tpu.utils import support as jsup
from deap_tpu_torch import NoCudaDevice, interop
from deap_tpu_torch import base as tbase, random as tr
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch.bigpop import (HostPopulation, StreamedEngine,
                                   check_prng_compat, run_streamed_resumable,
                                   sliced_bernoulli, sliced_bits,
                                   sliced_normal, sliced_uniform,
                                   streamed_ea_ask, streamed_ea_simple,
                                   streamed_ea_step, streamed_params)
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.resilience import (FaultInjector, FaultPlan, Preempted,
                                       RetriesExhausted, VirtualClock,
                                       with_retries)
from deap_tpu_torch.utils import support as tsup
from deap_tpu_torch.utils.checkpoint import load_checkpoint

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

N, DIM, SLICE = 48, 12, 16
CXPB, MUTPB = 0.7, 0.4


def _toolboxes(mate="two_point", mutate="gauss", tie_break="random",
               storage=None):
    """The same toolbox in both packages (``test_bigpop.py``'s operators
    and knobs); ``storage`` is ``(dtype, bound)`` or None."""
    pair = []
    for B, CX, MUT, SEL, lib in ((jbase, jcx, jmut, jsel, jnp),
                                 (tbase, tcx, tmut, tsel, torch)):
        tb = B.Toolbox()
        tb.register("evaluate",
                    lambda g, lib=lib: (lib.sum(lib.round(g * 8.0)),))
        if mate == "two_point":
            tb.register("mate", CX.cx_two_point)
        elif mate == "one_point":
            tb.register("mate", CX.cx_one_point)
        else:
            tb.register("mate", CX.cx_uniform, indpb=0.4)
        if mutate == "gauss":
            tb.register("mutate", MUT.mut_gaussian, mu=0.0, sigma=0.3,
                        indpb=0.1)
        else:
            tb.register("mutate", MUT.mut_flip_bit, indpb=0.08)
        tb.register("select", SEL.sel_tournament, tournsize=3,
                    tie_break=tie_break)
        pair.append(tb)
    if storage is not None:
        js = JStorage(*storage)
        pair[0].genome_storage = js
        pair[1].genome_storage = interop.storage_to_torch(js)
    return pair


def _populations(jtb, n=N, dim=DIM, seed=3):
    """An evaluated JAX population in the toolbox's storage dtype and the
    port's copy of the same arrays."""
    g = jax.random.uniform(jax.random.PRNGKey(seed), (n, dim), jnp.float32,
                           -1.0, 1.0)
    storage = getattr(jtb, "genome_storage", None)
    if storage is not None:
        g = storage.to_storage(g)
    pop = jbase.Population(genome=g, fitness=jbase.Fitness.empty(n, (1.0,)))
    pop, _ = jax.jit(lambda p: j_eval(jtb, p))(pop)
    tpop = interop.population_to_torch(
        pop.genome, pop.fitness.values, pop.fitness.valid,
        pop.fitness.weights, device="cpu")
    return pop, tpop


def _bits(a) -> np.ndarray:
    """An array as its raw bits (bfloat16 already is: ``uint16``)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.dtype(f"u{a.dtype.itemsize}"))
    return a


def _assert_pop_equal(tpop, jpop):
    t = interop.population_to_numpy(tpop)
    j = (interop.genome_to_numpy(interop.genome_to_torch(
            jpop.genome, device="cpu")),
         np.asarray(jpop.fitness.values), np.asarray(jpop.fitness.valid))
    for name, got, want in zip(("genome", "values", "valid"), t, j):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


def _tkey(seed):
    key = jax.random.PRNGKey(seed)
    return key, interop.key_to_torch(key, device="cpu")


# ---------------------------------------------------------------------------
# slicedprng: rows of whole draws
# ---------------------------------------------------------------------------

# (total rows, width, first row, rows): odd totals, tails of 1-7 rows,
# a slice of `width` rows (which a draw matched by its leading size
# alone would take for a row's own draw), a whole draw
_SLICES = [(40, 12, 0, 16), (40, 12, 16, 16), (40, 12, 32, 8),
           (37, 7, 36, 1), (37, 7, 31, 6), (47, 9, 40, 7), (47, 9, 20, 9),
           (24, 12, 5, 12), (64, 1, 59, 5), (33, 3, 0, 33), (48, 12, 45, 3),
           (25, 12, 23, 2)]


@pytest.mark.parametrize("total,width,row0,rows", _SLICES)
def test_sliced_draws_are_rows_of_whole_jax_draws(total, width, row0, rows):
    key, tkey = _tkey(5)
    shape = (total, width)
    sl = slice(row0, row0 + rows)
    cases = {
        "bits": (sliced_bits(tkey, shape, row0, rows).numpy()
                 .astype(np.uint32), jax.random.bits(key, shape)),
        "uniform": (sliced_uniform(tkey, shape, row0, rows).numpy(),
                    jax.random.uniform(key, shape)),
        "uniform(-1, 1)": (
            sliced_uniform(tkey, shape, row0, rows, -1.0, 1.0).numpy(),
            jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)),
        # sliced_normal is normal_erf_inv's rows; random.normal scales it
        "normal": ((sliced_normal(tkey, shape, row0, rows)
                    * tr.SQRT2).numpy(), jax.random.normal(key, shape)),
        "bernoulli": (sliced_bernoulli(tkey, 0.3, shape, row0, rows).numpy(),
                      jax.random.bernoulli(key, 0.3, shape)),
    }
    for name, (got, whole) in cases.items():
        want = np.asarray(whole)[sl]
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


def test_sliced_draws_refuse_rbg_keys_and_rows_outside():
    rbg = tr.PRNGKey(0, impl="rbg", device="cpu")
    with pytest.raises(RuntimeError, match="threefry2x32"):
        check_prng_compat(rbg)
    with pytest.raises(RuntimeError, match="threefry2x32"):
        sliced_uniform(rbg, (8, 4), 0, 2)
    with pytest.raises(ValueError, match="outside"):
        sliced_bits(tr.PRNGKey(0, device="cpu"), (8, 4), 6, 3)
    with pytest.raises(ValueError, match="one key"):
        check_prng_compat(tr.split(tr.PRNGKey(0, device="cpu"), 2))


# ---------------------------------------------------------------------------
# the acceptance oracle: streamed == jitted resident, bit for bit
# ---------------------------------------------------------------------------

_CONFIGS = [
    ("two_point", "gauss", "rank", None),
    ("two_point", "gauss", "rank", ("int8", 1.0)),
    ("one_point", "gauss", "random", None),
    ("uniform", "gauss", "random", ("int8", 1.0)),
    ("uniform", "flip", "rank", None),
    ("two_point", "flip", "random", None),
    ("one_point", "gauss", "rank", ("bfloat16", 0.0)),
]


@pytest.mark.parametrize("mate,mutate,tie_break,storage", _CONFIGS)
def test_streamed_step_is_bitwise_to_jitted_jax_ea_step(mate, mutate,
                                                        tie_break, storage):
    jtb, ttb = _toolboxes(mate, mutate, tie_break, storage)
    jpop, tpop = _populations(jtb)
    key, tkey = _tkey(21)
    k_ref, ref, nev_ref = jax.jit(
        lambda k, p: j_ea_step(k, p, jtb, CXPB, MUTPB))(key, jpop)
    k_got, got, nev_got = streamed_ea_step(tkey, tpop, ttb, CXPB, MUTPB,
                                           slice_rows=SLICE)
    np.testing.assert_array_equal(interop.key_to_numpy(k_got),
                                  np.asarray(k_ref))
    assert nev_got == int(nev_ref)
    _assert_pop_equal(got, ref)
    # the input population is the caller's: the host store copied it
    _assert_pop_equal(tpop, jpop)


@pytest.mark.parametrize("form", ["odd pop, tail slice", "1-row tail",
                                  "live mask", "ask"])
def test_streamed_forms_are_bitwise_to_jitted_jax(form):
    jtb, ttb = _toolboxes()
    if form in ("odd pop, tail slice", "1-row tail"):
        # slices of 16 / 16 / 15, or 16 / 16 / 1: the unpaired row alone
        n = 47 if form == "odd pop, tail slice" else 33
        jpop, tpop = _populations(jtb, n=n, dim=9)
        key, tkey = _tkey(8)
        _, ref, nev_ref = jax.jit(
            lambda k, p: j_ea_step(k, p, jtb, 0.8, 0.5))(key, jpop)
        _, got, nev_got = streamed_ea_step(tkey, tpop, ttb, 0.8, 0.5,
                                           slice_rows=SLICE)
    elif form == "live mask":              # 21 live rows of 32, slices of 8
        jpop, tpop = _populations(jtb, n=32, dim=10)
        key, tkey = _tkey(13)
        live = np.arange(32) < 21
        _, ref, nev_ref = jax.jit(
            lambda k, p, lv: j_ea_step(k, p, jtb, CXPB, MUTPB, live=lv))(
            key, jpop, jnp.asarray(live))
        _, got, nev_got = streamed_ea_step(tkey, tpop, ttb, CXPB, MUTPB,
                                           live=torch.from_numpy(live),
                                           slice_rows=8)
    else:
        jpop, tpop = _populations(jtb, n=40, dim=8)
        key, tkey = _tkey(4)
        k_ref, ref = jax.jit(
            lambda k, p: j_ea_ask(k, p, jtb, CXPB, MUTPB))(key, jpop)
        k_got, got = streamed_ea_ask(tkey, tpop, ttb, CXPB, MUTPB,
                                     slice_rows=8)
        np.testing.assert_array_equal(interop.key_to_numpy(k_got),
                                      np.asarray(k_ref))
        nev_ref = nev_got = None
    assert nev_got == (None if nev_ref is None else int(nev_ref))
    _assert_pop_equal(got, ref)


def test_ask_then_tell_equals_the_step():
    """The engine's ask / tell halves, the tell evaluating a slice at a
    time and then with external values, against one fused step."""
    _, ttb = _toolboxes(mutate="flip")
    jtb = _toolboxes(mutate="flip")[0]
    _, tpop = _populations(jtb)
    _, tkey = _tkey(6)
    stepped = HostPopulation.from_population(tpop, ttb)
    StreamedEngine(ttb, stepped, slice_rows=SLICE, device="cpu").step(
        tkey, CXPB, MUTPB)
    for external in (False, True):
        host = HostPopulation.from_population(tpop, ttb)
        eng = StreamedEngine(ttb, host, slice_rows=SLICE, device="cpu")
        _, pending = eng.ask(tkey, CXPB, MUTPB)
        values = torch.round(pending["rows"] * 8.0).sum(1) if external \
            else None
        eng.tell(pending, values)
        assert torch.equal(host.to_population("cpu").genome,
                           stepped.to_population("cpu").genome)
        for a, b in zip(host.fitness_arrays(), stepped.fitness_arrays()):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def resident_run():
    """JAX's resident ``ea_simple``, 3 generations with ``Statistics``
    (max, min) and ``HallOfFame(3)``, and the port's inputs."""
    jtb, _ = _toolboxes()
    jpop, tpop = _populations(jtb)
    key, tkey = _tkey(33)
    jstats = jsup.Statistics(key=lambda p: p.fitness.values[:, 0])
    jstats.register("max", jnp.max)
    jstats.register("min", jnp.min)
    jhof = jsup.HallOfFame(3)
    ref, log = j_ea_simple(key, jpop, jtb, 0.6, 0.3, 3, stats=jstats,
                           halloffame=jhof)
    return tkey, tpop, ref, log, jhof


def _port_stats():
    stats = tsup.Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("min", torch.min)
    return stats


@pytest.mark.parametrize("route", ["streamed_ea_simple", "ea_simple"])
def test_streamed_ea_simple_is_bitwise_to_jax_resident(resident_run, route):
    tkey, tpop, ref, jlog, jhof = resident_run
    _, ttb = _toolboxes()
    stats, hof = _port_stats(), tsup.HallOfFame(3)
    if route == "ea_simple":                # routed by the registry
        ttb.generation_engine = "streamed"
        got, log = talg.ea_simple(tkey, tpop, ttb, 0.6, 0.3, 3, stats=stats,
                                  halloffame=hof)
    else:
        got, log = streamed_ea_simple(tkey, tpop, ttb, 0.6, 0.3, 3,
                                      stats=stats, halloffame=hof,
                                      slice_rows=SLICE)
    _assert_pop_equal(got, ref)
    for col in ("gen", "nevals", "max", "min"):
        assert log.select(col) == jlog.select(col), col
    np.testing.assert_array_equal(_bits(hof.state.genome.numpy()),
                                  _bits(np.asarray(jhof.state.genome)))
    np.testing.assert_array_equal(_bits(hof.state.values.numpy()),
                                  _bits(np.asarray(jhof.state.values)))


def test_streamed_ea_simple_verbose_prints_each_generation(capsys):
    _, ttb = _toolboxes()
    _, tpop = _populations(_toolboxes()[0], n=16, dim=4)
    streamed_ea_simple(tr.PRNGKey(1, device="cpu"), tpop, ttb, 0.6, 0.3, 2,
                       stats=_port_stats(), verbose=True, slice_rows=8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["gen", "nevals", "max", "min"]
    assert [ln.split()[0] for ln in lines[1:]] == ["0", "1", "2"]


# ---------------------------------------------------------------------------
# preemption: mid-generation checkpoint and bit-exact resume
# ---------------------------------------------------------------------------


def test_preempted_and_resumed_run_is_bitwise_to_jax_resident(resident_run,
                                                              tmp_path):
    """Preempt at the first between-slice boundary of generation 2,
    resume, finish: the population equals JAX's resident ``ea_simple``,
    and the fault really fired (a drill whose fault never triggered
    proves nothing)."""
    tkey, tpop, ref, jlog, _ = resident_run
    _, ttb = _toolboxes()
    inj = FaultInjector(FaultPlan(preempt_at_gen=2))
    ck = tmp_path / "ooc.ckpt"
    with pytest.raises(Preempted) as ei:
        run_streamed_resumable(tkey, tpop, ttb, 3, ckpt_path=ck, cxpb=0.6,
                               mutpb=0.3, checkpoint_every=2,
                               slice_rows=SLICE, faults=inj)
    assert inj.preempts_delivered == 1
    assert ei.value.gen == 1                 # cut inside generation 2
    state = load_checkpoint(ck, device="cpu")
    assert state["kind"] == "bigpop-streamed" and state["format"] == 1
    assert state["cursor"]["slice"] == 1     # the first boundary
    assert state["cursor"]["staged_rows"].shape == (SLICE, DIM)
    host, log = run_streamed_resumable(tkey, tpop, ttb, 3, ckpt_path=ck,
                                       cxpb=0.6, mutpb=0.3,
                                       checkpoint_every=2, slice_rows=SLICE)
    _assert_pop_equal(host.to_population("cpu"), ref)
    assert log.select("gen") == jlog.select("gen")
    assert log.select("nevals") == jlog.select("nevals")
    assert load_checkpoint(ck, device="cpu")["gen"] == 3


def test_checkpoint_write_failures_are_retried(resident_run, tmp_path):
    """Two failed saves (a flaky filesystem) are retried on the virtual
    clock with the backoff sequence, and the run is unchanged; a third
    retry budget of zero gives up typed."""
    tkey, tpop, ref, _, _ = resident_run
    _, ttb = _toolboxes()
    clock = VirtualClock()
    inj = FaultInjector(FaultPlan(ckpt_fail_times=2), clock)
    host, _ = run_streamed_resumable(
        tkey, tpop, ttb, 3, ckpt_path=tmp_path / "a.ckpt", cxpb=0.6,
        mutpb=0.3, checkpoint_every=2, slice_rows=SLICE, faults=inj,
        io_sleep=clock.sleep, io_clock=clock.time)
    assert inj.saves_failed == 2 and clock.sleeps == [0.5, 1.0]
    _assert_pop_equal(host.to_population("cpu"), ref)
    inj = FaultInjector(FaultPlan(ckpt_fail_times=1), clock)
    with pytest.raises(RetriesExhausted):
        run_streamed_resumable(
            tkey, tpop, ttb, 2, ckpt_path=tmp_path / "b.ckpt", cxpb=0.6,
            mutpb=0.3, slice_rows=SLICE, faults=inj, io_retries=0)


def test_with_retries_backoff_matches_jax():
    from deap_tpu.resilience.retry import with_retries as j_with_retries
    seqs = []
    for wrap in (with_retries, j_with_retries):
        clock = VirtualClock()
        calls = []

        def flaky():
            calls.append(clock.time())
            if len(calls) < 4:
                raise OSError("flaky")
            return len(calls)

        assert wrap(flaky, retries=5, backoff=0.25, factor=3.0,
                    max_backoff=1.0, sleep=clock.sleep,
                    clock=clock.time)() == 4
        seqs.append((calls, clock.sleeps))
    assert seqs[0] == seqs[1]


def test_poisoned_evaluation_matches_jax():
    jtb, ttb = _toolboxes()
    jpop, tpop = _populations(jtb, n=16, dim=4)
    skip = np.arange(16) % 3 == 0
    plan = dict(nan_at_gen=1, nan_rows=(0, 1, 2))
    got = FaultInjector(FaultPlan(**plan)).poison_toolbox(ttb, 1) \
        .evaluate_population(tpop.genome, skip=torch.from_numpy(skip))
    want = JFaultInjector(JFaultPlan(**plan)).poison_toolbox(jtb, 1) \
        .evaluate_population(jpop.genome, skip=jnp.asarray(skip))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))
    assert int(torch.isnan(got).sum()) == 3


# ---------------------------------------------------------------------------
# HostPopulation against the JAX package's store
# ---------------------------------------------------------------------------


def test_host_population_matches_jax_store():
    jtb, ttb = _toolboxes()
    jpop, tpop = _populations(jtb, n=40, dim=6)
    jh = JHostPopulation.from_population(jpop, jtb, chunk_rows=16)
    th = HostPopulation.from_population(tpop, ttb, chunk_rows=16)
    assert (th.size, th.dim, len(th.clone_chunks())) == (40, 6, 3)
    assert th.genome_nbytes == jh.genome_nbytes
    np.testing.assert_array_equal(th.rows(10, 35).numpy(), jh.rows(10, 35))
    idx = np.array([39, 0, 17, 17, 31, 2])
    np.testing.assert_array_equal(th.gather(torch.from_numpy(idx)).numpy(),
                                  jh.gather(idx))
    out = torch.empty((len(idx), 6))
    assert th.gather(torch.from_numpy(idx), out=out) is out
    rows = np.full((10, 6), 7.0, np.float32)
    jh.set_rows(12, rows)                        # crosses a chunk
    th.set_rows(12, torch.from_numpy(rows))
    _assert_pop_equal(th.to_population("cpu"), jh.to_population())
    with pytest.raises(ValueError, match="row count"):
        th.swap_genome([torch.zeros((8, 6))])
    # the caller's population is not the store's memory
    th.set_rows(0, torch.zeros((1, 6)))
    assert not torch.equal(tpop.genome[0], torch.zeros(6))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change,match", [
    (lambda tb: tb.register("mate", tcx.cx_blend, alpha=0.5), "supports mate"),
    (lambda tb: tb.register("mutate", tmut.mut_polynomial_bounded, eta=20.0,
                            low=-1.0, up=1.0, indpb=0.1), "supports mutate"),
    (lambda tb: tb.register("mate", tcx.cx_uniform, 0.4), "batched form"),
    (lambda tb: setattr(tb, "quarantine", object()), "quarantine"),
    (lambda tb: tb.register("evaluate_population", lambda p: p),
     "evaluate_population"),
])
def test_streamed_params_rejections(change, match):
    _, ttb = _toolboxes()
    change(ttb)
    with pytest.raises(ValueError, match=match):
        streamed_params(ttb)


def test_engine_refusals(monkeypatch):
    jtb, ttb = _toolboxes()
    _, tpop = _populations(jtb, n=32, dim=8)
    host = HostPopulation.from_population(tpop, ttb)
    with pytest.raises(ValueError, match="even"):
        StreamedEngine(ttb, host, slice_rows=7, device="cpu")
    _, tb8 = _toolboxes(storage=("int8", 1.0))
    with pytest.raises(ValueError, match="storage"):
        StreamedEngine(tb8, host, device="cpu")     # float32 store
    eng = StreamedEngine(ttb, host, slice_rows=8, device="cpu")
    with pytest.raises(RuntimeError, match="threefry2x32"):
        eng.step(tr.PRNGKey(0, impl="rbg", device="cpu"), CXPB, MUTPB)
    ttb.generation_engine = "streamed"
    for kw in ({"reevaluate_all": True}, {"stream_every": 1}):
        with pytest.raises(ValueError, match="streamed engine"):
            talg.ea_simple(tr.PRNGKey(0, device="cpu"), tpop, ttb, CXPB,
                           MUTPB, 2, **kw)
    # no card and none asked for: the engine refuses to run on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        StreamedEngine(ttb, host)
    with pytest.raises(NoCudaDevice):
        streamed_ea_simple(tr.PRNGKey(0, device="cpu"), host, ttb, CXPB,
                           MUTPB, 1)
