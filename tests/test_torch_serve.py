"""deap_tpu_torch.serve (the in-process ``EvolutionService``) against the
JAX package's service, on the CPU at ``tests/test_serve.py``'s sizes.

The oracle is JAX's *served* trajectory — a slot of JAX's vmapped
program — on the same numpy inputs and keys: the mixed OneMax fleet
(``FLEET``, two buckets) bit for bit, its compile counts, the fitness
cache's hits and values, ask / tell equal to step, a JAX session's
snapshot adopted by the port and continued, and a rebucket's
continuation.  OneMax sums are exact in float32 in any order, so the
served slot and ``jax.jit(ea_step)`` agree and the comparison is bitwise
(tolerance 0).  Also, port only: the state machine, admission,
deadlines, cancellation and retries, checkpoint / restore, a megakernel
session against ``ea_step`` / ``ea_ask`` / ``ea_tell`` called directly
on the padded state (K1's plain version here), a streamed session
against a resident one, the digests and dedup of the cache tiers
against JAX's, and the refusals of what the next slice ports.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.serve import EvolutionService as JService
from deap_tpu.serve import rep_indices as j_rep_indices
from deap_tpu.serve import row_digests as j_row_digests
from deap_tpu_torch import NoCudaDevice, interop
from deap_tpu_torch import base as tbase, random as tr
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch.observability import events
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.resilience import Quarantine
from deap_tpu_torch.serve import (BucketOverflow, BucketPolicy,
                                  DeadlineExceeded, EvolutionService,
                                  FitnessCache, RequestCancelled, ServeError,
                                  ServeMetrics, ServiceClosed,
                                  ServiceDraining, ServiceOverloaded,
                                  genome_signature, prometheus_text,
                                  rep_indices, row_digests)
from deap_tpu_torch.serve.buckets import pad_rows, unpad_rows

torch.set_num_threads(1)

#: mixed (pop, dim) fleet — two buckets under the default policy:
#: 40→64 and 48→64 share (64, 8); 100→128 and 90→128 share (128, 12)
FLEET = [(40, 8), (100, 12), (48, 8), (90, 12)]
N_BUCKETS = 2
NGEN = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _final(pop):
    return (_np(pop.genome), _np(pop.fitness.values), _np(pop.fitness.valid))


def _same_final(a, b):
    return all(_same(x, y) for x, y in zip(a, b))


def j_onemax_toolbox():
    tb = jbase.Toolbox()
    tb.register("evaluate", lambda g: (jnp.sum(g),))
    tb.register("mate", jcx.cx_two_point)
    tb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
    tb.register("select", jsel.sel_tournament, tournsize=3)
    return tb


def onemax_toolbox(evaluate=None):
    tb = tbase.Toolbox()
    tb.register("evaluate", evaluate or (lambda g: (torch.sum(g),)))
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3)
    return tb


def onemax_genome(key, n, d) -> np.ndarray:
    return np.asarray(jax.random.bernoulli(key, 0.5, (n, d)), np.float32)


def j_pop(g):
    return jbase.Population(jnp.asarray(g),
                            jbase.Fitness.empty(g.shape[0], (1.0,)))


def t_pop(g):
    return tbase.Population(torch.from_numpy(np.array(g)),
                            tbase.Fitness.empty(g.shape[0], (1.0,),
                                                device="cpu"))


def fleet_inputs(shapes=FLEET, seed=42):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    return [(np.asarray(k), onemax_genome(k, n, d))
            for k, (n, d) in zip(keys, shapes)]


@pytest.fixture(scope="module")
def jax_fleet():
    """JAX's served fleet: the populations after NGEN and NGEN + 2 steps,
    its counters, and an evaluate probe's values."""
    tb = j_onemax_toolbox()
    out = {}
    with JService(max_batch=4) as svc:
        ss = [svc.open_session(jnp.asarray(k), j_pop(g), tb, cxpb=0.6,
                               mutpb=0.3) for k, g in fleet_inputs()]
        for fs in [s.step(NGEN) for s in ss]:
            for f in fs:
                f.result(timeout=120)
        out["after"] = [_final(s.population()) for s in ss]
        out["steady"] = dict(svc.stats().counters)
        for fs in [s.step(2) for s in ss]:
            for f in fs:
                f.result(timeout=120)
        out["again"] = [_final(s.population()) for s in ss]
        probe = onemax_genome(jax.random.PRNGKey(9), 10, 8)
        out["probe"] = probe
        out["v_probe"] = np.asarray(ss[0].evaluate(probe).result(60))
        out["snap"] = svc.snapshot_sessions()
    return out


def _port_fleet(svc, tb, inputs=None):
    return [svc.open_session(k, t_pop(g), tb, cxpb=0.6, mutpb=0.3)
            for k, g in (inputs or fleet_inputs())]


def test_concurrent_sessions_bitwise_to_jax_compiles_and_cache(jax_fleet):
    tb = onemax_toolbox()
    with EvolutionService(max_batch=4, device="cpu") as svc:
        ss = _port_fleet(svc, tb)
        for fs in [s.step(NGEN) for s in ss]:
            for f in fs:
                f.result(timeout=120)
        for s, want in zip(ss, jax_fleet["after"]):
            assert _same_final(_final(s.population()), want)
        steady = svc.stats().counters
        for k in ("compiles_step", "compiles_init", "steps", "compiles"):
            assert steady[k] == jax_fleet["steady"][k], k
        assert steady["compiles_step"] == N_BUCKETS
        for fs in [s.step(2) for s in ss]:
            for f in fs:
                f.result(timeout=120)
        again = svc.stats().counters
        assert again["compiles"] == steady["compiles"], "per-request build"
        assert again["steps"] == len(FLEET) * (NGEN + 2)
        multiplexed = [_final(s.population()) for s in ss]
        for got, want in zip(multiplexed, jax_fleet["again"]):
            assert _same_final(got, want)
        # duplicate genomes across sessions hit the cache, same bits
        probe = jax_fleet["probe"]
        v_first = ss[0].evaluate(probe).result(timeout=60)
        v_dup = ss[2].evaluate(torch.from_numpy(probe)).result(timeout=60)
        assert isinstance(v_first, torch.Tensor) and v_first.device.type \
            == "cpu"
        assert _same(v_first, v_dup) and _same(v_first, jax_fleet["v_probe"])
        assert svc.stats().counters["cache_hits"] >= 10
        assert svc.cache.hit_rate() > 0
        assert 0 < svc.stats().gauges["slot_occupancy"] <= 1.0
    # each session served alone reproduces the multiplexed run
    with EvolutionService(max_batch=4, device="cpu") as alone:
        for (k, g), want in zip(fleet_inputs(), multiplexed):
            s = alone.open_session(k, t_pop(g), tb, cxpb=0.6, mutpb=0.3)
            for f in s.step(NGEN + 2):
                f.result(timeout=120)
            assert _same_final(_final(s.population()), want)
            s.close()


def test_jax_snapshot_adopted_and_continued(jax_fleet):
    """A JAX session snapshot (numpy, raw key words) adopted by the port,
    as is and through ``interop.session_snapshot_to_torch``, continues
    JAX's trajectory bit for bit; the port's own snapshot has JAX's keys
    and host types."""
    tb = onemax_toolbox()
    snaps = jax_fleet["snap"]
    names = sorted(snaps)
    with EvolutionService(max_batch=4, device="cpu") as svc:
        got = svc.adopt_sessions(
            {n: (interop.session_snapshot_to_torch(snaps[n], "cpu")
                 if i % 2 else snaps[n]) for i, n in enumerate(names)},
            {n: tb for n in names})
        for s in got.values():
            assert s.gen == NGEN + 2
            for f in s.step(2):
                f.result(timeout=60)
        mine = svc.snapshot_sessions()
    with JService(max_batch=4) as jsvc:
        jtb = j_onemax_toolbox()
        jgot = jsvc.adopt_sessions(snaps, {n: jtb for n in names})
        for s in jgot.values():
            for f in s.step(2):
                f.result(timeout=60)
        want = jsvc.snapshot_sessions()
    for n in names:
        assert set(mine[n]) == set(want[n])
        for k, v in want[n].items():
            if isinstance(v, np.ndarray):
                assert _same(mine[n][k], v), (n, k)
                assert isinstance(mine[n][k], np.ndarray)
            else:
                assert mine[n][k] == v and type(mine[n][k]) is type(v), k
        back = interop.session_snapshot_to_numpy(mine[n])
        assert _same(back["key"], want[n]["key"])


def test_rebucket_continuation_matches_jax():
    inputs = fleet_inputs(FLEET[:2], seed=3)
    with JService(max_batch=4) as jsvc:
        jss = [jsvc.open_session(jnp.asarray(k), j_pop(g),
                                 j_onemax_toolbox(), cxpb=0.6, mutpb=0.3)
               for k, g in inputs]
        jinfo = jsvc.rebucket(sizes=[48, 100])
        for fs in [s.step(2) for s in jss]:
            for f in fs:
                f.result(timeout=60)
        want = [_final(s.population()) for s in jss]
    with EvolutionService(max_batch=4, device="cpu") as svc:
        ss = _port_fleet(svc, onemax_toolbox(), inputs)
        info = svc.rebucket(sizes=[48, 100])
        assert info["sizes"] == jinfo["sizes"]
        assert sorted(info["moved"]) == sorted(jinfo["moved"])
        assert info["compiles"] == jinfo["compiles"]
        for fs in [s.step(2) for s in ss]:
            for f in fs:
                f.result(timeout=60)
        for s, w in zip(ss, want):
            assert _same_final(_final(s.population()), w)
        assert svc.stats().counters["rebuckets"] == 1


# ---------------------------------------------------------------------------
# cache tiers and buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int8",
                                   "int32", "bool", "uint8"])
def test_row_digests_and_rep_indices_match_jax(dtype):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 3, (40, 5)).astype(np.float32)
    rows[[3, 9, 17]] = rows[0]
    rows[[5, 30]] = rows[1]
    jrows = jnp.asarray(rows).astype(dtype)
    trows = torch.from_numpy(rows).to(getattr(torch, dtype))
    assert j_row_digests(np.asarray(jrows)) == row_digests(trows)
    if dtype != "bfloat16":
        assert row_digests(np.asarray(jrows)) == row_digests(trows)
    jrep, jn = jax.jit(j_rep_indices)(jrows)
    rep, n = rep_indices(trows)
    assert _same(jrep, rep) and int(jn) == int(n)
    assert n.dtype == torch.int32


def test_bucket_policy_and_signatures():
    p = BucketPolicy()
    assert [p.rows_for(n) for n in (1, 8, 9, 100, 128)] == [8, 8, 16, 128,
                                                           128]
    p2 = BucketPolicy(sizes=(32, 256))
    assert p2.rows_for(33) == 256
    with pytest.raises(BucketOverflow):
        p2.rows_for(257)
    with pytest.raises(BucketOverflow):
        BucketPolicy(max_rows=64).rows_for(100)
    a = p.bucket_for(t_pop(np.zeros((40, 8), np.float32)))
    b = p.bucket_for(t_pop(np.zeros((40, 9), np.float32)))
    c = p.bucket_for(t_pop(np.zeros((48, 8), np.float32)))
    assert a != b and a == c
    g = {"w": torch.zeros(4, 2, 3), "b": (torch.zeros(4, dtype=torch.int8),)}
    assert genome_signature(g) == genome_signature(
        {"b": (np.zeros(7, np.int8),), "w": np.zeros((7, 2, 3), np.float32)})
    padded = pad_rows(g, 8)
    assert padded["w"].shape == (8, 2, 3) and padded["b"][0].shape == (8,)
    assert unpad_rows(padded, 4)["w"].shape == (4, 2, 3)


def test_cache_lru_eviction_and_nan_policy():
    m = ServeMetrics()
    cache = FitnessCache(capacity=2, metrics=m)
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    digs = row_digests(rows)
    values = np.asarray([[1.0], [2.0], [np.nan], [4.0]], np.float32)
    assert cache.insert("ns", digs, values) == 3
    assert len(cache) == 2
    assert m.counter("cache_nan_skipped") == 1
    assert m.counter("cache_evictions") == 1
    assert not cache.contains("ns", digs[2])
    hits = cache.lookup("ns", digs)
    assert hits[2] is None and sum(h is not None for h in hits) == 2


def test_nan_evaluations_never_cached_end_to_end():
    tb = onemax_toolbox(lambda g: (torch.where(
        g[0] > 0.5, torch.full_like(torch.sum(g), float("nan")),
        torch.sum(g)),))
    with EvolutionService(max_batch=2, device="cpu") as svc:
        s = svc.open_session(tr.PRNGKey(5, device="cpu"),
                             t_pop(np.zeros((12, 6), np.float32)), tb)
        batch = torch.cat([torch.full((2, 6), 0.9), torch.full((2, 6), 0.1)])
        v1 = s.evaluate(batch).result(timeout=60).ravel()
        assert torch.isnan(v1[:2]).all() and torch.isfinite(v1[2:]).all()
        before = svc.stats().counters
        v2 = s.evaluate(batch).result(timeout=60).ravel()
        after = svc.stats().counters
        assert _same(v1[2:], v2[2:])
        assert after["cache_hits"] > before["cache_hits"]
        assert after["cache_misses"] > before["cache_misses"]
        assert after["cache_nan_skipped"] > 0
        with svc.cache._lock:
            assert all(np.isfinite(v).all()
                       for v in svc.cache._entries.values())


def test_close_purges_namespace_and_refcounted_pins():
    tb1, tb2 = onemax_toolbox(), onemax_toolbox()
    probe = torch.ones((4, 6))
    sig = genome_signature(probe)
    digs = row_digests(probe)
    with EvolutionService(max_batch=2, device="cpu") as svc:
        k = tr.PRNGKey(21, device="cpu")
        pop = t_pop(np.zeros((12, 6), np.float32))
        s1 = svc.open_session(k, pop, tb1, name="one")
        s2 = svc.open_session(k, pop, tb2, name="two")
        s1.evaluate(probe).result(timeout=60)
        s2.evaluate(probe).result(timeout=60)
        ns1, ns2 = (id(tb1.evaluate), sig, 1), (id(tb2.evaluate), sig, 1)
        assert svc.cache.contains(ns1, digs[0])
        s1.close()
        assert not svc.cache.contains(ns1, digs[0])
        assert svc.cache.contains(ns2, digs[0])
        assert svc.stats().counters["cache_purged"] >= 1


# ---------------------------------------------------------------------------
# the request protocol
# ---------------------------------------------------------------------------

def test_ask_tell_matches_internal_step_bitwise():
    tb = onemax_toolbox()
    k, g = fleet_inputs([(20, 10)], seed=7)[0]
    with EvolutionService(max_batch=2, device="cpu") as svc:
        s_int = svc.open_session(k, t_pop(g), tb, cxpb=0.6, mutpb=0.3,
                                 name="internal")
        s_ext = svc.open_session(k, t_pop(g), tb, cxpb=0.6, mutpb=0.3,
                                 name="external")
        for _ in range(3):
            s_int.step()[0].result(timeout=60)
            off = s_ext.ask().result(timeout=60)
            s_ext.tell(off.sum(dim=1)).result(timeout=60)
        assert _same_final(_final(s_ext.population()),
                           _final(s_int.population()))


def test_ask_tell_state_machine():
    tb = onemax_toolbox()
    with EvolutionService(max_batch=2, device="cpu") as svc:
        s = svc.open_session(tr.PRNGKey(8, device="cpu"),
                             t_pop(np.ones((16, 6), np.float32)), tb)
        with pytest.raises(ServeError):
            s.tell(np.zeros(16))
        s.ask().result(timeout=60)
        with pytest.raises(ServeError):
            s.step()
        with pytest.raises(ServeError):
            s.ask()
        s.tell(np.zeros(16)).result(timeout=60)
        assert s.phase == "idle"
        s.ask().result(timeout=60)
        with pytest.raises(ValueError):
            s.tell(np.zeros(10))
        s.tell(np.zeros(16)).result(timeout=60)
        svc._dispatcher.pause()
        fut = s.ask(deadline=0.0)
        svc._dispatcher.resume()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert s.phase == "idle"
        assert s.step()[0].result(timeout=60)["gen"] == 3


def test_admission_deadline_backpressure_cancel_and_names():
    tb = onemax_toolbox()
    pop = t_pop(np.ones((16, 6), np.float32))
    with EvolutionService(max_batch=2, max_pending=1, device="cpu") as svc:
        s = svc.open_session(tr.PRNGKey(1, device="cpu"), pop, tb,
                             name="a")
        with pytest.raises(ValueError, match="already open"):
            svc.open_session(tr.PRNGKey(1, device="cpu"), pop, tb, name="a")
        svc._dispatcher.pause()
        [fut] = s.step(deadline=0.0)
        svc._dispatcher.resume()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert svc.stats().counters["deadline_misses"] == 1
        assert s.step()[0].result(timeout=60)["gen"] == 1
        svc._dispatcher.pause()
        [first] = s.step()
        with pytest.raises(ServiceOverloaded):
            s.step()
        svc._dispatcher.resume()
        assert first.result(timeout=60)["gen"] == 2
        with svc.quiesce():
            [fut] = s.step()
            assert fut.cancel()
        with pytest.raises(RequestCancelled):
            fut.result(timeout=30)
        assert s.step()[0].result(timeout=60)["gen"] == 3
    with pytest.raises(ServiceClosed):
        svc.open_session(tr.PRNGKey(1, device="cpu"), pop, tb)
    with EvolutionService(policy=BucketPolicy(max_rows=8),
                          device="cpu") as small:
        with pytest.raises(BucketOverflow):
            small.open_session(tr.PRNGKey(1, device="cpu"), pop, tb)


def test_retries_faults_and_closed_sessions():
    tb = onemax_toolbox()
    pop = t_pop(np.ones((16, 6), np.float32))
    boom = {"left": 2}

    def flaky(kind, requests):
        if kind == "step" and boom["left"]:
            boom["left"] -= 1
            raise OSError("transient flake")

    with EvolutionService(max_batch=2, eval_retries=3, retry_backoff=0.0,
                          fault_hook=flaky, device="cpu") as svc:
        s = svc.open_session(tr.PRNGKey(4, device="cpu"), pop, tb)
        assert s.step()[0].result(timeout=60)["gen"] == 1
        assert svc.stats().counters["retries"] == 2
        s.close()
        with pytest.raises(ServiceClosed):
            s.step()

    def fatal(kind, requests):
        if kind == "step":
            raise ValueError("a bug, not a flake")

    with EvolutionService(max_batch=2, fault_hook=fatal,
                          device="cpu") as svc:
        s = svc.open_session(tr.PRNGKey(4, device="cpu"), pop, tb)
        with pytest.raises(ValueError):
            s.step()[0].result(timeout=60)
        assert svc.stats().counters["failed"] == 1


def test_checkpoint_restore_drain_and_export(tmp_path):
    tb = onemax_toolbox()
    inputs = fleet_inputs(FLEET[:2], seed=12)

    def fleet(svc):
        return [svc.open_session(k, t_pop(g), tb, cxpb=0.6, mutpb=0.3,
                                 name=f"run-{i}")
                for i, (k, g) in enumerate(inputs)]

    with EvolutionService(max_batch=4, device="cpu") as svc:
        ss = fleet(svc)
        for s in ss:
            for f in s.step(4):
                f.result(timeout=60)
        svc.checkpoint(tmp_path / "serve.ckpt")
        for s in ss:
            for f in s.step(4):
                f.result(timeout=60)
        want = [_final(s.population()) for s in ss]
    with EvolutionService(max_batch=4, device="cpu") as svc2:
        restored = svc2.restore_sessions(tmp_path / "serve.ckpt",
                                         {f"run-{i}": tb for i in range(2)})
        assert sorted(restored) == ["run-0", "run-1"]
        for i in range(2):
            s = restored[f"run-{i}"]
            assert s.gen == 4
            for f in s.step(4):
                f.result(timeout=60)
            assert _same_final(_final(s.population()), want[i])
        snap = svc2.export_session("run-0")
        assert snap["gen"] == 8 and "run-0" not in svc2.sessions()
        drained = svc2.drain()
        assert sorted(drained) == ["run-1"]
        with pytest.raises(ServiceDraining):
            restored["run-1"].step()


# ---------------------------------------------------------------------------
# engines: megakernel, streamed
# ---------------------------------------------------------------------------

def _mk_toolbox(engine="megakernel"):
    from deap_tpu_torch import benchmarks
    tb = tbase.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = engine
    return tb


def test_megakernel_session_equals_direct_calls():
    """The served megakernel session (K1's plain version on the CPU)
    against ``ea_step`` / ``ea_ask`` / ``ea_tell`` on the same padded
    state, as ``chip_smoke.py`` phase 55 (a) holds it on the card."""
    tb = _mk_toolbox()
    n, d, rows = 200, 10, 256
    key = tr.PRNGKey(31, device="cpu")
    g = tr.uniform(tr.fold_in(key, 1), (n, d), minval=-5.12, maxval=5.12)
    with EvolutionService(max_batch=4, device="cpu") as svc:
        s = svc.open_session(key, tbase.Population(g, tbase.Fitness.empty(
            n, (-1.0,), device="cpu")), tb, cxpb=0.9, mutpb=0.5)
        assert s.bucket.rows == rows
        for f in s.step(2):
            f.result(timeout=60)
        after = s.population()
        off = s.ask().result(timeout=60)
        vals = talg.evaluate_rows(tb.evaluate, off)
        s.tell(vals).result(timeout=60)
        served = s.population()
        assert svc.stats().counters["compiles_step"] == 1
    live = torch.arange(rows) < n
    gp = torch.zeros((rows, d))
    gp[:n] = g
    p = tbase.Population(gp, tbase.Fitness.empty(rows, (-1.0,),
                                                 device="cpu"))
    p, _ = talg.ea_tell(tb, p, live=live)
    k = key
    cx, mut = float(np.float32(0.9)), float(np.float32(0.5))
    for _ in range(2):
        k, p, _ = talg.ea_step(k, p, tb, cx, mut, live=live)
    assert _same(p.genome[:n], after.genome)
    assert _same(p.fitness.values[:n], after.fitness.values)
    k, offd = talg.ea_ask(k, p, tb, cx, mut, live=live)
    assert _same(offd.genome[:n], off)
    v = torch.zeros((rows, 1))
    v[:n] = vals
    p, _ = talg.ea_tell(tb, offd, v, live=live)
    assert _same_final(_final(tbase.Population(p.genome[:n], tbase.Fitness(
        p.fitness.values[:n], p.fitness.valid[:n], (-1.0,)))),
        _final(served))


def test_streamed_session_equals_resident_session():
    tb_s = _mk_toolbox("streamed")
    tb_r = _mk_toolbox("xla")
    n, d = 48, 12
    key = tr.PRNGKey(33, device="cpu")
    g = tr.uniform(tr.fold_in(key, 1), (n, d), minval=-5.12, maxval=5.12)
    pop = tbase.Population(g, tbase.Fitness.empty(n, (-1.0,), device="cpu"))
    with EvolutionService(max_batch=4, device="cpu") as svc:
        ss = svc.open_session(key, pop, tb_s, name="s")
        sr = svc.open_session(key, pop, tb_r, name="r")
        for x in (ss, sr):
            for f in x.step(2):
                f.result(timeout=60)
        assert _same_final(_final(ss.population()), _final(sr.population()))
        # ask / tell through the streamed session
        offs = ss.ask().result(timeout=60)
        offr = sr.ask().result(timeout=60)
        assert _same(offs, offr)
        v = talg.evaluate_rows(tb_r.evaluate, offr)
        ss.tell(v).result(timeout=60)
        sr.tell(v).result(timeout=60)
        assert _same_final(_final(ss.population()), _final(sr.population()))
        c = svc.stats().counters
        assert c["steps_streamed"] == 2 and c["compiles_step"] == 1
        assert svc.stats().gauges["sessions_streamed"] == 1


# ---------------------------------------------------------------------------
# observability and refusals
# ---------------------------------------------------------------------------

def test_stats_profiles_events_and_prometheus():
    tb = onemax_toolbox()
    tb.quarantine = Quarantine("penalize")
    with EvolutionService(max_batch=2, device="cpu") as svc:
        with events.collect() as col:
            s = svc.open_session(tr.PRNGKey(13, device="cpu"),
                                 t_pop(np.ones((16, 6), np.float32)), tb)
            for f in s.step(3):
                f.result(timeout=60)
        assert col.items == []          # the worker's events are its own
        rec = svc.stats()
        assert rec.meta["source"] == "serve"
        assert rec.counters["steps"] == 3
        assert rec.gauges["latency_p50_ms"] > 0
        assert rec.gauges["latency_p99_ms"] >= rec.gauges["latency_p50_ms"]
        assert 0 < rec.gauges["slot_occupancy"] <= 1
        assert rec.gauges["profile_programs"] == 2.0
        assert "profile_flops_total" not in rec.gauges
        progs = rec.meta["programs"]
        assert len(progs) == 2
        for row in progs.values():
            assert row["calls"] >= 1 and "window" in row
            assert "aot" not in row and "phase_split" not in row
        text = prometheus_text(rec)
        assert "deap_tpu_serve_steps_total 3" in text
        with events.collect() as col:
            svc._program("step", ("probe",), lambda: (lambda: None), ())
        assert col.drain()["serve_compiles"] == 1
        spans = svc.tracer.recent(64)
        assert any(sp["name"] == "serve.step" for sp in spans)


def test_refusals_and_no_cuda_fallback():
    with pytest.raises(NotImplementedError, match="11b"):
        EvolutionService(shard_threshold=64, device="cpu")
    with pytest.raises(NotImplementedError, match="11b"):
        EvolutionService(mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            EvolutionService()
    from deap_tpu_torch.serve import cli
    with pytest.raises(SystemExit):         # no such option before 11b
        cli.main(["--shard-threshold", "64", "--device", "cpu"])


def test_cli_smoke_on_the_cpu(capsys):
    from deap_tpu_torch.serve import cli
    import json
    assert cli.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == "net-smoke" and report["device"] == "cpu"
    assert report["failures"] == 0
    assert report["counters"]["steps"] == 2 * 3
    assert all(np.isfinite(report["best_fitness"]))


#: the demo's rastrigin (``serve.cli.demo_rastrigin``, XLA's float32 form
#: of the jitted function) against ``jax.jit(jax.vmap(rastrigin))`` on
#: 2048 uniform rows: bitwise at every width measured but 8, where 255 of
#: the 2048 rows are apart by at most 2 ulp (XLA's code for that width
#: was not read); the bound, in ulp
DEMO_RASTRIGIN_ULP = {2: 0, 12: 0, 16: 0, 24: 0, 32: 0, 64: 0, 100: 0,
                      8: 2}
#: ``benchmarks.rastrigin`` (``torch.cos``, ``torch.sum``) against the
#: same: at most 3 ulp at every width above (measured), why the demo
#: takes the XLA form
PLAIN_RASTRIGIN_ULP = 3


@pytest.mark.parametrize("d", sorted(DEMO_RASTRIGIN_ULP))
def test_demo_rastrigin_against_jitted_jax(d):
    from deap_tpu.benchmarks import rastrigin as jr
    from deap_tpu_torch.serve.cli import demo_rastrigin
    g = jax.random.uniform(jax.random.PRNGKey(d), (2048, d), jnp.float32,
                           -5.12, 5.12)
    from deap_tpu_torch.benchmarks import rastrigin
    want = np.asarray(jax.jit(jax.vmap(lambda x: jr(x)[0]))(g))
    x = torch.from_numpy(np.array(g))
    got = demo_rastrigin(x)[0].numpy()
    plain = torch.func.vmap(lambda r: rastrigin(r)[0])(x).numpy()

    def gap(a):
        return np.abs(want.view(np.int32).astype(np.int64)
                      - a.view(np.int32).astype(np.int64)).max()
    assert gap(got) <= DEMO_RASTRIGIN_ULP[d]
    assert gap(plain) <= PLAIN_RASTRIGIN_ULP


def test_cli_demo_fleet_bitwise_to_jax():
    """The CLI's demo (rastrigin GA with ``Quarantine("penalize")``,
    widths 16 and 32) served by the port and by JAX: bit for bit."""
    from deap_tpu.serve import cli as jcli
    from deap_tpu_torch.serve import cli as tcli
    pops, dims = [100, 180], [16, 32]
    with JService(max_batch=4) as jsvc:
        jf = jcli._open_fleet(jsvc, jcli._build_toolbox(), 4, pops, dims, 0)
        for fs in [s.step(6) for s in jf]:
            for f in fs:
                f.result(timeout=120)
        want = [_final(s.population()) for s in jf]
    with EvolutionService(max_batch=4, device="cpu") as svc:
        tf = tcli._open_fleet(svc, tcli._build_toolbox(), 4, pops, dims, 0)
        for fs in [s.step(6) for s in tf]:
            for f in fs:
                f.result(timeout=120)
        for s, w in zip(tf, want):
            assert _same_final(_final(s.population()), w)


def test_sinks_match_jax_and_tensorboard_is_lazy(tmp_path, monkeypatch):
    """The sink layer is the JAX package's: the same record gives the same
    JSONL and text lines; ``TensorBoardSink`` imports its writer only when
    built, and raises without one (as on the card's machine)."""
    import sys
    from deap_tpu.observability import sinks as js
    from deap_tpu_torch.observability import sinks as ts
    rec = dict(gen=7, counters={"steps": 3, "compiles": 2},
               gauges={"queue_depth": 1.0, "latency_p50_ms": 2.5},
               meta={"source": "serve"})
    jr, tr_ = js.MetricRecord(**rec), ts.MetricRecord(**rec)
    assert ts.format_record(tr_) == js.format_record(jr)
    assert tr_.to_json() == jr.to_json()
    for mod, name in ((js, "j.jsonl"), (ts, "t.jsonl")):
        sink = mod.JsonlSink(tmp_path / name)
        mod.emit_record([sink], jr if mod is js else tr_)
        mod.emit_text("[serve] hello", [sink])
        sink.close()
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    mem = ts.InMemorySink()
    ts.emit_record([mem], tr_)
    assert mem.records == [tr_]
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="SummaryWriter"):
        ts.TensorBoardSink(tmp_path / "tb")


def test_tracing_and_profiling_off_change_nothing():
    from deap_tpu_torch.observability import FleetTracer, ProgramProfiler
    tb = onemax_toolbox()
    runs = []
    for on in (True, False):
        kw = {} if on else dict(tracer=FleetTracer(enabled=False),
                                profiler=ProgramProfiler(enabled=False))
        with EvolutionService(max_batch=4, device="cpu", **kw) as svc:
            ss = _port_fleet(svc, tb, fleet_inputs(FLEET[:2], seed=5))
            for fs in [s.step(3) for s in ss]:
                for f in fs:
                    f.result(timeout=60)
            runs.append([_final(s.population()) for s in ss])
            assert bool(svc.tracer.recent()) is on
            assert ("programs" in svc.stats().meta) is on
    for a, b in zip(*runs):
        assert _same_final(a, b)


def test_late_registered_evaluator_and_step_path_quarantine():
    """An evaluator registered after its sessions opened is pinned per
    session (a sibling's close drops neither its program nor its cache);
    a NaN-emitting evaluator under ``Quarantine("penalize")`` never
    poisons a served session's state."""
    tb = tbase.Toolbox()
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3)
    pop = t_pop(np.ones((12, 6), np.float32))
    with EvolutionService(max_batch=2, device="cpu") as svc:
        k = tr.PRNGKey(22, device="cpu")
        a = svc.open_session(k, pop, tb, name="a", evaluate_initial=False)
        b = svc.open_session(k, pop, tb, name="b", evaluate_initial=False)
        tb.register("evaluate", lambda g: (torch.sum(g),))
        probe = torch.from_numpy(fleet_inputs([(6, 6)], seed=22)[0][1])
        a.evaluate(probe).result(timeout=60)
        vb = b.evaluate(probe).result(timeout=60)
        c = svc.stats().counters
        a.close()
        assert _same(vb, b.evaluate(probe).result(timeout=60))
        after = svc.stats().counters
        assert after["compiles_evaluate"] == c["compiles_evaluate"]
        assert after["cache_purged"] == c["cache_purged"]
    q = onemax_toolbox(lambda g: (torch.where(
        torch.sum(g) > 4.0, torch.full_like(torch.sum(g), float("nan")),
        torch.sum(g)),))
    q.quarantine = Quarantine("penalize")
    k, g = fleet_inputs([(24, 8)], seed=11)[0]
    with EvolutionService(max_batch=2, device="cpu") as svc:
        s = svc.open_session(k, t_pop(g), q, cxpb=0.6, mutpb=0.4)
        for f in s.step(5):
            f.result(timeout=60)
        p = s.population()
        assert torch.isfinite(p.fitness.values).all()
        assert p.fitness.valid.all()


def test_open_session_takes_host_arrays():
    """An unpadded population of numpy arrays opens like one of tensors
    (the same trajectory), and the caller's tensors are never aliased."""
    tb = onemax_toolbox()
    k, g = fleet_inputs([(40, 8)], seed=44)[0]
    host = tbase.Population(g.copy(), tbase.Fitness(
        np.zeros((40, 1), np.float32), np.zeros(40, bool), (1.0,)))
    tens = t_pop(g)
    with EvolutionService(max_batch=2, device="cpu") as svc:
        a = svc.open_session(k, host, tb, name="host")
        b = svc.open_session(k, tens, tb, name="tensor")
        for s in (a, b):
            for f in s.step(2):
                f.result(timeout=60)
        assert _same_final(_final(a.population()), _final(b.population()))
        assert _same(tens.genome, g)
