"""deap_tpu_torch.resilience (quarantine, ``run_resumable``, the session
checkpoints) and the sanitizer's lock factory against the JAX package,
on the CPU at small sizes.

The oracle is the JAX package on the same numpy inputs and keys:
``Quarantine``'s three policies (sentinels and the resample donor) bit
for bit, the loops with ``toolbox.quarantine`` (JAX's jitted
``ea_simple``) bit for bit, and ``run_resumable`` preempted and resumed
against JAX's undisturbed run: population, fitness and logbook.  The
streamed loop under ``run_resumable`` is held to the resident loop under
it (the JAX streamed engine refuses jax's partitionable key layout); the
sharded tier runs on two gloo ranks against one device.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.algorithms import ea_simple as j_ea_simple
from deap_tpu.algorithms import ea_mu_plus_lambda as j_ea_mu_plus_lambda
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.resilience import FaultInjector as JFaultInjector
from deap_tpu.resilience import FaultPlan as JFaultPlan
from deap_tpu.resilience import Quarantine as JQuarantine
from deap_tpu.resilience import run_resumable as j_run_resumable
from deap_tpu_torch import sanitize
from deap_tpu_torch import base as tbase, interop, random as tr
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch.bigpop import streamed_ea_simple
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.parallel import launch
from deap_tpu_torch.resilience import (FaultInjector, FaultPlan,
                                       NonFiniteFitnessError, Preempted,
                                       Quarantine, load_session_states,
                                       nonfinite_rows, run_resumable,
                                       save_session_states)

torch.set_num_threads(1)
TESTS = str(pathlib.Path(__file__).resolve().parent)
N, BITS = 32, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _same_pop(jpop, tpop):
    return (_same(jpop.genome, tpop.genome)
            and _same(jpop.fitness.values, tpop.fitness.values)
            and _same(jpop.fitness.valid, tpop.fitness.valid))


def _records(lb):
    return [{k: float(np.asarray(v)) for k, v in r.items()} for r in lb]


# ---------------------------------------------------------------------------
# Quarantine's policies
# ---------------------------------------------------------------------------

def _values_with_nonfinite():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(12, 3)).astype(np.float32)
    v[1, 0] = np.nan
    v[4, 2] = np.inf
    v[7] = -np.inf
    v[9, 1] = np.nan
    # ties on the best finite row: the donor is the first of them
    v[2] = v[5] = np.array([3.0, 1.0, -2.0], np.float32)
    return v


@pytest.mark.parametrize("policy", ["penalize", "resample"])
@pytest.mark.parametrize("weights,sentinel", [
    ((1.0, -1.0, 0.5), None), ((-1.0, 1.0, 0.0), None),
    ((2.0, -0.25, 1.0), 1e6)])
def test_quarantine_policies_match_jax(policy, weights, sentinel):
    v = _values_with_nonfinite()
    valid = np.ones(12, bool)
    valid[9] = False                       # an invalid NaN row is left alone
    newly = np.ones(12, bool)
    newly[4] = False                       # not freshly assigned: kept
    g = np.arange(12 * 5, dtype=np.float32).reshape(12, 5)
    jp = jbase.Population(jnp.asarray(g), jbase.Fitness(
        jnp.asarray(v), jnp.asarray(valid), weights))
    tp = interop.population_to_torch(g, v, valid, weights, device="cpu")
    jout = JQuarantine(policy, sentinel).apply(jp, newly=jnp.asarray(newly))
    tout = Quarantine(policy, sentinel).apply(tp,
                                              newly=torch.from_numpy(newly))
    assert _same_pop(jout, tout)
    assert _same(jout.fitness.valid, tout.fitness.valid)


def test_quarantine_raise_and_nonfinite_rows():
    v = _values_with_nonfinite()
    assert _same(np.asarray(jax.jit(lambda x: ~jnp.all(
        jnp.isfinite(x), axis=-1))(v)), nonfinite_rows(torch.from_numpy(v)))
    tp = interop.population_to_torch(np.zeros((12, 2), np.float32), v,
                                     np.ones(12, bool), (1.0, 1.0, 1.0),
                                     device="cpu")
    with pytest.raises(NonFiniteFitnessError) as e:
        Quarantine("raise").apply(tp)
    assert e.value.rows == [1, 4, 7, 9]
    finite = interop.population_to_torch(
        np.zeros((3, 2), np.float32), np.ones((3, 1), np.float32),
        np.ones(3, bool), (1.0,), device="cpu")
    assert Quarantine("raise").apply(finite) is finite
    with pytest.raises(ValueError):
        Quarantine("ignore")


def _nan_sum_j(g):
    s = jnp.sum(g)
    return (jnp.where((g[0] > 0.5) & (g[1] > 0.5), jnp.nan, s),)


def _nan_sum_t(g):
    s = torch.sum(g)
    return (torch.where((g[0] > 0.5) & (g[1] > 0.5),
                        torch.full_like(s, float("nan")), s),)


def _j_toolbox(policy=None, evaluate=_nan_sum_j):
    tb = jbase.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("mate", jcx.cx_two_point)
    tb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
    tb.register("select", jsel.sel_tournament, tournsize=3)
    if policy is not None:
        tb.quarantine = JQuarantine(policy)
    return tb


def _t_toolbox(policy=None, evaluate=_nan_sum_t):
    tb = tbase.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3)
    if policy is not None:
        tb.quarantine = Quarantine(policy)
    return tb


def _start(seed=0, n=N, bits=BITS):
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    g = np.asarray(jax.random.bernoulli(k_init, 0.5, (n, bits)),
                   np.float32)
    jpop = jbase.Population(jnp.asarray(g), jbase.Fitness.empty(n, (1.0,)))
    tpop = tbase.Population(torch.from_numpy(g.copy()),
                            tbase.Fitness.empty(n, (1.0,), device="cpu"))
    return k_run, interop.key_to_torch(np.asarray(k_run), "cpu"), jpop, tpop


@pytest.mark.parametrize("policy", ["penalize", "resample"])
def test_loops_apply_toolbox_quarantine_like_jax(policy):
    jk, tk, jpop, tpop = _start()
    jout, jlog = j_ea_simple(jk, jpop, _j_toolbox(policy), 0.6, 0.3, 5)
    tout, tlog = talg.ea_simple(tk, tpop, _t_toolbox(policy), 0.6, 0.3, 5)
    assert _same_pop(jout, tout)
    assert _records(jlog) == _records(tlog)
    # the initial evaluation: NaN rows quarantined, every value finite
    j0, _ = j_eval(_j_toolbox(policy), jpop)
    t0, _ = talg.evaluate_population(_t_toolbox(policy), tpop)
    assert _same_pop(j0, t0)
    assert bool(np.isfinite(_np(t0.fitness.values)).all())


def test_ea_tell_external_values_quarantine_and_raise():
    jk, tk, jpop, tpop = _start(1)
    v = np.arange(N, dtype=np.float32)[:, None]
    v[[3, 8]] = np.nan
    live = np.arange(N) < N - 4
    from deap_tpu.algorithms import ea_tell as j_ea_tell
    jout, jn = j_ea_tell(_j_toolbox("penalize"), jpop, jnp.asarray(v),
                         live=jnp.asarray(live))
    tout, tn = talg.ea_tell(_t_toolbox("penalize"), tpop,
                            torch.from_numpy(v), live=torch.from_numpy(live))
    assert _same_pop(jout, tout) and int(jn) == int(tn)
    with pytest.raises(NonFiniteFitnessError) as e:
        talg.ea_tell(_t_toolbox("raise"), tpop, torch.from_numpy(v))
    assert e.value.rows == [3, 8]


# ---------------------------------------------------------------------------
# run_resumable
# ---------------------------------------------------------------------------

def _onemax_j():
    return _j_toolbox(evaluate=lambda g: (jnp.sum(g),))


def _onemax_t():
    return _t_toolbox(evaluate=lambda g: (torch.sum(g),))


def _stats_t():
    from deap_tpu_torch.utils.support import Statistics
    s = Statistics(lambda p: p.fitness.values[:, 0])
    s.register("max", torch.max)
    return s


def _stats_j():
    from deap_tpu.utils.support import Statistics
    s = Statistics(lambda p: p.fitness.values[:, 0])
    s.register("max", jnp.max)
    return s


def test_run_resumable_preempted_and_resumed_matches_jax(tmp_path):
    jk, tk, jpop, tpop = _start(2)
    kw = dict(checkpoint_every=2, loop_kwargs=dict(cxpb=0.5, mutpb=0.2))
    jout, jlog = j_run_resumable(jk, jpop, _onemax_j(), 6,
                                 ckpt_path=tmp_path / "j.pkl",
                                 stats=_stats_j(), **kw)
    tout, tlog = run_resumable(tk, tpop, _onemax_t(), 6,
                               ckpt_path=tmp_path / "u.pkl",
                               stats=_stats_t(), **kw)
    assert _same_pop(jout, tout)
    assert _records(jlog) == _records(tlog)
    faults = FaultInjector(FaultPlan(preempt_at_gen=3, ckpt_fail_times=1))
    with pytest.raises(Preempted) as e:
        run_resumable(tk, tpop, _onemax_t(), 6, ckpt_path=tmp_path / "p.pkl",
                      stats=_stats_t(), faults=faults,
                      io_sleep=lambda s: None, **kw)
    assert e.value.gen == 4 and faults.saves_failed == 1
    rout, rlog = run_resumable(tk, tpop, _onemax_t(), 6,
                               ckpt_path=tmp_path / "p.pkl",
                               stats=_stats_t(), resume="require", **kw)
    assert _same_pop(jout, rout)
    assert _records(jlog) == _records(rlog)


def test_run_resumable_poisoned_generation_with_quarantine_matches_jax(
        tmp_path):
    jk, tk, jpop, tpop = _start(3)
    jtb, ttb = _onemax_j(), _onemax_t()
    jtb.quarantine, ttb.quarantine = JQuarantine("resample"), \
        Quarantine("resample")
    kw = dict(checkpoint_every=2, loop_kwargs=dict(cxpb=0.5, mutpb=0.2))
    jout, jlog = j_run_resumable(
        jk, jpop, jtb, 5, ckpt_path=tmp_path / "j.pkl",
        faults=JFaultInjector(JFaultPlan(nan_at_gen=3, nan_rows=(0, 5))),
        **kw)
    tout, tlog = run_resumable(
        tk, tpop, ttb, 5, ckpt_path=tmp_path / "t.pkl",
        faults=FaultInjector(FaultPlan(nan_at_gen=3, nan_rows=(0, 5))), **kw)
    assert _same_pop(jout, tout)
    assert _records(jlog) == _records(tlog)


def test_run_resumable_mu_plus_lambda_matches_jax(tmp_path):
    jk, tk, jpop, tpop = _start(4)
    kw = dict(checkpoint_every=2, loop_kwargs=dict(
        mu=N, lambda_=2 * N, cxpb=0.5, mutpb=0.3))
    jout, jlog = j_run_resumable(jk, jpop, _onemax_j(), 4,
                                 ckpt_path=tmp_path / "j.pkl",
                                 loop=j_ea_mu_plus_lambda, **kw)
    with pytest.raises(Preempted):
        run_resumable(tk, tpop, _onemax_t(), 4, ckpt_path=tmp_path / "t.pkl",
                      loop=talg.ea_mu_plus_lambda,
                      faults=FaultInjector(FaultPlan(preempt_at_gen=2)), **kw)
    tout, tlog = run_resumable(tk, tpop, _onemax_t(), 4,
                               ckpt_path=tmp_path / "t.pkl",
                               loop=talg.ea_mu_plus_lambda, **kw)
    assert _same_pop(jout, tout)
    assert _records(jlog) == _records(tlog)


def _ooc_toolbox(streamed: bool):
    tb = tbase.Toolbox()
    tb.register("evaluate", lambda g: (torch.sum(torch.round(g * 8) / 8),))
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.1)
    tb.register("select", tsel.sel_tournament, tournsize=3,
                tie_break="rank")
    if streamed:
        tb.generation_engine = "streamed"
    return tb


def test_run_resumable_streamed_loop_preempted_equals_resident(tmp_path):
    key = tr.PRNGKey(5, device="cpu")
    g = tr.uniform(tr.fold_in(key, 1), (48, 12), minval=-2.0, maxval=2.0)
    pop = tbase.Population(g, tbase.Fitness.empty(48, (-1.0,), device="cpu"))
    kw = dict(checkpoint_every=1, loop_kwargs=dict(cxpb=0.6, mutpb=0.4))
    ref, rlog = run_resumable(key, pop, _ooc_toolbox(False), 3,
                              ckpt_path=tmp_path / "r.pkl", **kw)
    with pytest.raises(Preempted) as e:
        run_resumable(key, pop, _ooc_toolbox(True), 3,
                      ckpt_path=tmp_path / "s.pkl", loop=streamed_ea_simple,
                      faults=FaultInjector(FaultPlan(preempt_at_gen=2)),
                      **dict(kw, loop_kwargs=dict(kw["loop_kwargs"],
                                                  slice_rows=16)))
    assert e.value.gen == 2
    got, glog = run_resumable(key, pop, _ooc_toolbox(True), 3,
                              ckpt_path=tmp_path / "s.pkl",
                              loop=streamed_ea_simple,
                              **dict(kw, loop_kwargs=dict(kw["loop_kwargs"],
                                                          slice_rows=16)))
    assert _same_pop(ref, got)
    assert _records(rlog) == _records(glog)


def test_run_resumable_refusals(tmp_path):
    jk, tk, jpop, tpop = _start(6)
    with pytest.raises(NotImplementedError, match="item 12"):
        run_resumable(tk, tpop, _onemax_t(), 2, ckpt_path=tmp_path / "x",
                      telemetry=object())
    with pytest.raises(ValueError):
        run_resumable(tk, tpop, _onemax_t(), 2, ckpt_path=tmp_path / "x",
                      checkpoint_every=0)
    with pytest.raises(FileNotFoundError):
        run_resumable(tk, tpop, _onemax_t(), 2, ckpt_path=tmp_path / "x",
                      resume="require")


def test_run_resumable_sharded_tier_on_two_ranks(tmp_path):
    """``sharded=True`` on two gloo ranks (the per-rank checkpoint tier),
    preempted and resumed, equals the one-device run."""
    env = dict(os.environ, PYTHONPATH=TESTS)
    out = launch.run_ranks(
        "_torch_serve_cases:sharded_resumable_case", 2,
        kwargs=dict(ckpt_dir=str(tmp_path / "ck")), env=env, timeout=60,
        deadline=240, threads=1, workdir=tmp_path / "ranks")
    import _torch_serve_cases as cases
    ref = cases.sharded_resumable_reference()
    for rank in out:
        assert rank["preempted_at"] == 2
        for name in ("undisturbed", "resumed"):
            for a, b in zip(rank[name], ref):
                assert _same(a, b), name


# ---------------------------------------------------------------------------
# session checkpoints
# ---------------------------------------------------------------------------

def test_session_states_round_trip(tmp_path):
    snap = {"s": {"gen": 3, "phase": "idle", "n": 2, "priority": 1,
                  "weights": (1.0,), "rows": 8,
                  "key": np.array([0, 7], np.uint32),
                  "genome": np.ones((2, 3), np.float32),
                  "values": np.zeros((2, 1), np.float32),
                  "valid": np.ones(2, bool), "cxpb": 0.5, "mutpb": 0.2}}
    save_session_states(tmp_path / "s.pkl", snap)
    back = load_session_states(tmp_path / "s.pkl")
    assert back.keys() == snap.keys()
    for k, v in snap["s"].items():
        if isinstance(v, np.ndarray):
            assert _same(v, back["s"][k])
        else:
            assert back["s"][k] == v
    from deap_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(tmp_path / "bad.pkl", {"format": 99, "sessions": {}})
    with pytest.raises(ValueError, match="format"):
        load_session_states(tmp_path / "bad.pkl")


# ---------------------------------------------------------------------------
# the lock factory
# ---------------------------------------------------------------------------

def test_sanitize_factory_is_stdlib_and_runtime_refused(monkeypatch):
    import threading
    assert type(sanitize.lock()) is type(threading.Lock())
    assert type(sanitize.rlock()) is type(threading.RLock())
    assert isinstance(sanitize.condition(), threading.Condition)
    assert isinstance(sanitize.event(), threading.Event)
    assert sanitize.active() is False
    with pytest.raises(NotImplementedError, match="item 12"):
        sanitize.arm()
    with pytest.raises(NotImplementedError, match="item 12"):
        sanitize.disarm()
    monkeypatch.setenv(sanitize.TSAN_ENV, "1")
    for make in (sanitize.lock, sanitize.rlock, sanitize.condition,
                 sanitize.event, sanitize.active):
        with pytest.raises(NotImplementedError, match="item 12"):
            make()
