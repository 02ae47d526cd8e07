"""deap_tpu_torch.serve.router (the fleet router) and the fleet half of
the port's ``NetServer`` (its redirects) against the JAX package, on the
CPU over loopback.

OneMax 40 / 48 x 8 at ``max_batch=4`` (one 64-row bucket), as the JAX
package's ``tests/test_serve_router.py``.  OneMax sums are exact, so every
population comparison is bitwise (tolerance 0).

* the weighted-fair scheduler, placement and ``fleet_sizes`` against
  JAX's on the same scripts;
* the fleet drill: two sessions placed by affinity on one instance, the
  health loop latching it sick through deadline-missed error spans,
  drain → restore elsewhere, the sessions continuing bitwise to JAX's
  undisturbed single-instance run, a typed quota rejection over the
  wire, the drained instance redirecting a direct client, one
  Prometheus scrape of the fleet.  It runs behind the port's router over
  the port's instances, behind the port's router over a JAX and a port
  instance (failing over JAX -> port), and behind JAX's router over the
  port's instances (JAX's failover calls the port's
  ``/v1/admin/redirect``); each router's counters are JAX's;
* the mirrors of JAX's non-slow router tests, and
  ``prometheus_fleet_text`` byte for byte against JAX's.
"""

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.serve import EvolutionService as JService
from deap_tpu.serve import metrics as jmetrics
from deap_tpu.serve.buckets import genome_signature as jsig
from deap_tpu.serve.net import NetServer as JNetServer
from deap_tpu.serve.router import server as jrserver
import deap_tpu.serve.router as jrouter
from deap_tpu.observability.sinks import MetricRecord as JRecord
from deap_tpu_torch import base as tbase
from deap_tpu_torch.observability.fleettrace import join_spans, span_tree
from deap_tpu_torch.observability.sinks import MetricRecord
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.serve import (DeadlineExceeded, EvolutionService,
                                  ServiceDraining, SessionUnknown)
from deap_tpu_torch.serve import metrics as tmetrics
from deap_tpu_torch.serve.buckets import genome_signature as tsig
from deap_tpu_torch.serve.net import NetServer, RemoteService, protocol
from deap_tpu_torch.serve.net.client import RemoteSession
from deap_tpu_torch.serve.router import server as trserver
import deap_tpu_torch.serve.router as trouter

torch.set_num_threads(1)

SHAPES = [(40, 8), (48, 8)]
NGEN = 4
#: the router counters a drill fixes (the rest count health probes and
#: requests, which depend on the health loop's timing)
DRILL_COUNTERS = {"router_failovers": 1, "router_failover_sessions": 2,
                  "router_quota_rejections": 1, "router_sessions_placed": 3,
                  "router_placements_warm": 2, "router_sessions_lost": 0,
                  "router_orphans_replaced": 0, "router_backends_sick": 1}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _final(pop):
    return [_np(pop.genome), _np(pop.fitness.values), _np(pop.fitness.valid)]


def _same_final(a, b):
    return all(x.shape == y.shape and x.dtype == y.dtype
               and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def j_toolbox():
    tb = jbase.Toolbox()
    tb.register("evaluate", lambda g: (jnp.sum(g),))
    tb.register("mate", jcx.cx_two_point)
    tb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
    tb.register("select", jsel.sel_tournament, tournsize=3)
    return tb


def t_toolbox():
    tb = tbase.Toolbox()
    tb.register("evaluate", lambda g: (torch.sum(g),))
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3)
    return tb


def inputs(seed=12, shapes=SHAPES):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    return [(np.asarray(k), np.asarray(jax.random.bernoulli(
        k, 0.5, (n, d)), np.float32)) for k, (n, d) in zip(keys, shapes)]


def t_pop(g):
    return tbase.Population(torch.from_numpy(np.array(g)),
                            tbase.Fitness.empty(g.shape[0], (1.0,),
                                                device="cpu"))


def j_pop(g):
    return jbase.Population(jnp.asarray(g),
                            jbase.Fitness.empty(g.shape[0], (1.0,)))


@pytest.fixture(scope="module")
def reference():
    """JAX's undisturbed in-process run: each session after 2 NGEN
    steps."""
    with JService(max_batch=4) as svc:
        ss = [svc.open_session(jnp.asarray(k), j_pop(g), j_toolbox(),
                               cxpb=0.6, mutpb=0.3, name=f"run-{i}")
              for i, (k, g) in enumerate(inputs())]
        for s in ss:
            for f in s.step(2 * NGEN):
                f.result(timeout=120)
        return [_final(s.population()) for s in ss]


def _instance(pkg):
    """One serving instance of ``pkg`` ("port" or "jax") on loopback."""
    if pkg == "port":
        svc = EvolutionService(max_batch=4, device="cpu")
        return svc, NetServer(svc, {"onemax": t_toolbox()}).start()
    svc = JService(max_batch=4)
    return svc, JNetServer(svc, {"onemax": j_toolbox()}).start()


class _Fleet:
    """Instances of the given packages behind one router of package
    ``router`` (its module ``r``); closes everything it started and
    checks that no thread it started outlives it."""

    def __init__(self, backends=("port",) * 3, router="port",
                 front=True, **router_kw):
        self.threads0 = set(threading.enumerate())
        self.r = trouter if router == "port" else jrouter
        self.insts = [_instance(p) for p in backends]
        self.srvs = [srv for _, srv in self.insts]
        self.backends = [self.r.Backend(f"b{i}", srv.url)
                         for i, srv in enumerate(self.srvs)]
        self.router = self.r.FleetRouter(self.backends, **router_kw)
        self.front = (self.r.RouterServer(self.router, failover_wait=60)
                      .start() if front else None)

    def close(self, dead=()):
        if self.front is not None:
            self.front.close()          # closes the router too
        else:
            self.router.close()
        for i, (svc, srv) in enumerate(self.insts):
            if i not in dead:
                srv.close()
            svc.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            left = [t for t in threading.enumerate()
                    if t not in self.threads0 and t.is_alive()
                    and not t.name.startswith(("ThreadPoolExecutor",
                                               "asyncio"))]
            if not left:
                return
            time.sleep(0.05)
        raise AssertionError(f"threads left alive: {left}")


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def _scrape(address, path):
    conn = http.client.HTTPConnection(*address, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# scheduling and placement: the same scripts through both packages
# ---------------------------------------------------------------------------


def _scheduler_script(r):
    """The JAX test's script of requests: weighted grant order, a backlog
    and a session quota, a timed-out waiter that backs out."""
    sched = r.WeightedFairScheduler(
        max_inflight=1,
        quotas={"gold": r.TenantQuota(weight=3.0),
                "silver": r.TenantQuota(weight=1.0, max_pending=2),
                "capped": r.TenantQuota(max_sessions=2)})
    out = {"order": [], "rejected": []}

    def queued(n):
        return _wait(lambda: len(sched._waiting) + len(sched._granted) >= n)

    def waiter(tenant, tag):
        sched.acquire(tenant, timeout=30)
        out["order"].append(tag)
        sched.release(tenant)

    sched.acquire("gold")
    threads = []
    for tenant, tag in [("gold", "g1"), ("silver", "s1"), ("gold", "g2"),
                        ("gold", "g3")]:
        threads.append(threading.Thread(target=waiter, args=(tenant, tag)))
        threads[-1].start()
        assert queued(len(threads))
    sched.release("gold")
    for t in threads:
        t.join(timeout=30)
    sched.acquire("gold")
    threads = [threading.Thread(target=waiter, args=("silver", f"q{i}"))
               for i in range(2)]
    for i, t in enumerate(threads):
        t.start()
        assert _wait(lambda: sched._pending.get("silver", 0) == i + 1)
    for tenant, call in (("silver", lambda: sched.acquire("silver", 1)),
                         ("capped", lambda: [sched.session_opened("capped")
                                             for _ in range(3)])):
        try:
            call()
        except r.TenantQuotaExceeded as e:
            out["rejected"].append((tenant, str(e)))
    sched.release("gold")
    for t in threads:
        t.join(timeout=30)
    sched.session_closed("capped")
    sched.session_opened("capped")      # the freed slot re-admits
    sched.acquire("a")
    try:
        sched.acquire("b", timeout=0.05)
    except TimeoutError:
        out["rejected"].append(("b", "timeout"))
    sched.release("a")
    out["residue"] = (sched._waiting, sched._granted, sched._pending,
                      sched._inflight, sched.sessions_of("capped"))
    sched.close()
    assert not any(t.is_alive() for t in threads)
    return out


def test_weighted_fair_scheduler_matches_jax():
    port, ref = _scheduler_script(trouter), _scheduler_script(jrouter)
    assert port == ref
    # tags: g1 = 1/3, g2 = 2/3, g3 = 1, s1 = 1 — silver's tie wins on seq
    assert port["order"] == ["g1", "g2", "s1", "g3", "q0", "q1"]
    assert [t for t, _ in port["rejected"]] == ["silver", "capped", "b"]
    assert port["residue"] == ([], {}, {}, 0, 2)


def _placement_script(r, sig_of):
    """Place 60 sessions of mixed row counts and two genome widths over
    three backends (spread 2), as the router's create path does."""
    policy = r.PlacementPolicy(spread=2)
    plans = [r.BackendPlan() for _ in range(3)]
    rng = np.random.default_rng(3)
    sigs = [sig_of(np.zeros((1, d), np.float32)) for d in (8, 16)]
    choices = []
    for _ in range(60):
        n = int(rng.choice([40, 48, 64, 100, 130, 250]))
        sig = sigs[int(rng.integers(2))]
        name, warm = policy.choose(
            [(f"b{i}", p) for i, p in enumerate(plans)], n, sig)
        choices.append((name, warm, policy.bucket_rows(n)))
        plans[int(name[1:])].observe_placement(n, policy.bucket_rows(n),
                                               sig)
    return choices, [r.fleet_sizes(plans, max_buckets=k) for k in (1, 2, 4)]


def test_placement_and_fleet_sizes_match_jax():
    port = _placement_script(trouter, tsig)
    assert port == _placement_script(jrouter, jsig)
    assert any(w for _, w, _ in port[0]) and not all(w for _, w, _ in port[0])
    # the JAX test's unit case
    a, b = trouter.BackendPlan(), trouter.BackendPlan()
    policy = trouter.PlacementPolicy(spread=2)
    sig = tsig(torch.zeros((1, 8)))
    a.observe_placement(40, 64, sig)
    assert policy.choose([("A", a), ("B", b)], 48, sig) == ("A", True)
    for _ in range(2):
        a.observe_placement(40, 64, sig)
    assert policy.choose([("A", a), ("B", b)], 48, sig) == ("B", False)
    assert trouter.fleet_sizes([a, b], max_buckets=4) == (40,)
    assert trouter.fleet_sizes([trouter.BackendPlan()]) is None


# ---------------------------------------------------------------------------
# the fleet drill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backends,router", [
    (("port", "port", "port"), "port"),
    (("jax", "port"), "port"),
    (("port", "port"), "jax")],
    ids=["port-router-port-fleet", "port-router-jax-to-port",
         "jax-router-port-fleet"])
def test_fleet_drill_health_failover_bitwise(reference, backends, router):
    fleet = _Fleet(backends, router,
                   quotas={"capped": fleet_quota(router)},
                   health=fleet_health(router))
    cli = RemoteService(fleet.front.url, timeout=120)
    try:
        ss = [cli.open_session(k, t_pop(g), "onemax", cxpb=0.6, mutpb=0.3,
                               name=f"run-{i}", tenant="acme")
              for i, (k, g) in enumerate(inputs())]
        # sibling shapes (40 and 48 pad to the 64-row bucket) co-locate
        homes = {fleet.router.route_of(s.name).name for s in ss}
        assert homes == {"b0"}      # the first, least-loaded instance
        for s in ss:
            for f in s.step(NGEN):
                assert f.result(timeout=120)["nevals"] >= 0
        # deadline-missed requests leave error spans in b0's trace
        # window (they never execute: the trajectories are untouched)
        victim = fleet.srvs[0]
        with RemoteService(victim.url, timeout=60) as direct:
            phantom = direct.attach("run-0")
            for _ in range(3):
                [f] = phantom.step(1, deadline=0.0)
                with pytest.raises(DeadlineExceeded):
                    f.result(timeout=60)
        assert _wait(lambda: all(fleet.router.route_of(s.name).name != "b0"
                                 for s in ss))
        assert fleet.router.health.is_sick("b0")
        for s in ss:
            for f in s.step(NGEN):
                f.result(timeout=120)
        for s, want in zip(ss, reference):
            assert _same_final(_final(s.population()), want)
        # the drained instance redirects a direct client: a step is a
        # typed rejection carrying the new home; the port's instance
        # redirects a read too, which the client follows (JAX's answers a
        # read with the stale state it still holds)
        new_home = fleet.router.route_of("run-1")
        assert victim.redirect_location == new_home.url
        with RemoteService(victim.url, timeout=60,
                           follow_redirects=False) as fixed:
            with pytest.raises(ServiceDraining) as e:
                fixed.attach("run-1").step(1)[0].result(timeout=60)
            assert e.value.remote_location == new_home.url
        if backends[0] == "port":
            with RemoteService(victim.url, timeout=60) as stale:
                assert stale.attach("run-1").gen == 2 * NGEN
                assert (stale.host, stale.port) == (new_home.host,
                                                    new_home.port)
        # the capped tenant's second session: typed, over the wire
        k2, g2 = inputs(99)[0]
        cli.open_session(k2, t_pop(g2), "onemax", name="cap-0",
                         tenant="capped", evaluate_initial=False)
        with pytest.raises(trouter.TenantQuotaExceeded):
            cli.open_session(k2, t_pop(g2), "onemax", name="cap-1",
                             tenant="capped", evaluate_initial=False)
        rec = fleet.router.stats()
        got = {k: rec.counters[k] for k in DRILL_COUNTERS}
        assert got == DRILL_COUNTERS, got
        assert rec.gauges["router_failover_recovery_s"] > 0
        assert set(rec.counters) == set(jmetrics.SERVE_COUNTERS
                                        + jmetrics.NET_COUNTERS
                                        + jmetrics.ROUTER_COUNTERS
                                        + jmetrics.AUTOSCALE_COUNTERS) \
            - ({"steps_sharded"} if router == "port" else set())
        # one scrape: the router and every live backend, labelled
        status, ctype, text = _scrape(fleet.front.address,
                                      "/v1/admin/fleet?format=prometheus")
        text = text.decode()
        assert status == 200 and ctype.startswith("text/plain")
        assert text.count("# TYPE deap_tpu_serve_steps_total counter") == 1
        assert "# backend b0 sick: excluded" in text
        for name in ["router"] + [b.name for b in fleet.backends[1:]]:
            assert f'deap_tpu_serve_requests_total{{instance="{name}"}}' \
                in text
        assert f'deap_tpu_serve_steps_total{{instance="{new_home.name}"}} ' \
               f'{2 * NGEN}' in text
    finally:
        cli.close()
        fleet.close()


def fleet_quota(router):
    return (trouter if router == "port" else jrouter).TenantQuota(
        max_sessions=1)


def fleet_health(router):
    return (trouter if router == "port" else jrouter).HealthPolicy(
        interval_s=0.1, fail_after=2, max_error_spans=0)


# ---------------------------------------------------------------------------
# the port server's redirects, and the router's envelope helpers
# ---------------------------------------------------------------------------


def test_client_follows_port_server_redirects(reference):
    """Per session: one session moved off a port instance redirects only
    its own paths (its neighbour keeps serving there).  Instance-wide: a
    drained port instance that knows its replacement redirects a stale
    client.  The client follows both, and the sessions go on bitwise."""
    (k0, g0), (k1, g1) = inputs()
    with EvolutionService(max_batch=4, device="cpu") as sa, \
            EvolutionService(max_batch=4, device="cpu") as sb, \
            NetServer(sa, {"onemax": t_toolbox()}) as a, \
            NetServer(sb, {"onemax": t_toolbox()}) as b, \
            RemoteService(a.url, timeout=120) as ca:
        admin_a, admin_b = trouter.Backend("a", a.url), \
            trouter.Backend("b", b.url)
        s0 = ca.open_session(k0, t_pop(g0), "onemax", cxpb=0.6, mutpb=0.3,
                             name="run-0")
        s1 = ca.open_session(k1, t_pop(g1), "onemax", cxpb=0.6, mutpb=0.3,
                             name="run-1")
        for s in (s0, s1):
            for f in s.step(NGEN):
                f.result(timeout=120)
        snap = sa.export_session("run-1")
        snap["toolbox"] = "onemax"
        assert admin_b.restore({"run-1": snap}) == {
            "restored": ["run-1"], "skipped": {}}
        admin_a.set_redirect(b.url, session="run-1")
        assert a.redirect_for("run-1") == b.url
        assert a.redirect_for("run-0") is None and a.redirect_location is None
        with RemoteService(a.url, timeout=120,
                           follow_redirects=False) as fixed:
            with pytest.raises(SessionUnknown) as e:
                fixed.attach("run-1")
            assert e.value.remote_location == b.url
        with RemoteService(a.url, timeout=120) as c1:
            moved = c1.attach("run-1")
            for f in moved.step(NGEN):
                f.result(timeout=120)
            assert (c1.host, c1.port) == tuple(b.address)
            assert _same_final(_final(moved.population()), reference[1])
        for f in s0.step(NGEN):             # the neighbour stays on a
            f.result(timeout=120)
        assert (ca.host, ca.port) == tuple(a.address)
        admin_a.set_redirect(None, session="run-1")
        assert a.redirect_for("run-1") is None
        # instance-wide: a drains to b, then redirects everything there
        snaps = admin_a.drain()
        assert sorted(snaps) == ["run-0"]
        assert admin_b.restore(snaps)["restored"] == ["run-0"]
        admin_a.set_redirect(b.url)
        assert a.redirect_location == b.url == a.redirect_for("run-0")
        assert _same_final(_final(s0.population()), reference[0])
        assert (ca.host, ca.port) == tuple(b.address)


_ENVELOPES = [
    protocol.error_payload(ServiceDraining("moving"), location="host9:1234"),
    protocol.error_payload(SessionUnknown("gone"), location="http://h:1"),
    protocol.error_payload(ValueError("x")),
    json.dumps({"error": 3, "location": "h"}).encode(),
    b"\x93not json", b"", protocol.encode_frame({"ok": True})]


@pytest.mark.parametrize("i", range(len(_ENVELOPES)))
def test_strip_redirect_and_envelope_error_match_jax(i):
    """A backend's redirect never reaches a router client (its
    redirect-following would bypass the router for good), and the typed
    class name is read off an envelope as JAX's router reads it."""
    data = _ENVELOPES[i]
    assert trserver._strip_redirect(data) == jrserver._strip_redirect(data)
    assert trserver._envelope_error(data) == jrserver._envelope_error(data)
    if i == 0:
        doc = json.loads(trserver._strip_redirect(data))
        assert "location" not in doc and doc["error"] == "ServiceDraining"


@pytest.mark.parametrize("r", [trouter, jrouter], ids=["port", "jax"])
def test_health_probe_latches_queue_progress_stall(r):
    """Queued requests with a flat ``completed`` counter past stall_s
    latch the probe; resumed completions reopen the window; an empty
    queue is idle, not wedged (the same verdicts from both packages)."""

    class Wedged:
        name = "b0"
        completed = 5
        depth = 3.0

        def healthz(self):
            return {"ok": True, "draining": False}

        def metrics(self):
            return {"counters": {"completed": self.completed, "failed": 0},
                    "gauges": {"queue_depth": self.depth}}

        def trace_tail(self, n):
            return {"spans": []}

    now = [0.0]
    be = Wedged()
    mon = r.HealthMonitor([be], on_sick=lambda b, why: None,
                          policy=r.HealthPolicy(stall_s=5.0),
                          clock=lambda: now[0])
    seen = []
    for t, done, depth in ((0, 0, 3.0), (0, 0, 3.0), (6, 0, 3.0),
                           (12, 1, 3.0), (16, 0, 3.0), (22, 0, 3.0),
                           (40, 0, 0.0)):
        now[0] = float(t)
        be.completed += done
        be.depth = depth
        sample = mon.probe(be)
        seen.append((sample.ok, "wedged" in sample.reason))
    assert seen == [(True, False), (True, False), (False, True),
                    (True, False), (True, False), (False, True),
                    (True, False)]


def test_commit_session_never_stomps_failover_reroute():
    """A route the failover already wrote is kept; a backend declared
    down before the commit never receives the new session, which is
    accounted lost with its quota slot freed."""
    backends = [trouter.Backend(f"b{i}", ("127.0.0.1", 1 + i))
                for i in range(3)]
    router = trouter.FleetRouter(
        backends, start_health=False,
        quotas={"capT": trouter.TenantQuota(max_sessions=1)})
    try:
        sig = tsig(torch.zeros((1, 8)))
        router.commit_session("plain", backends[1], 40, sig, None)
        assert router.route_of("plain").name == "b1"
        with router._lock:
            router._routes["moved"] = "b2"
        router.commit_session("moved", backends[0], 40, sig, "capT")
        assert router.route_of("moved").name == "b2"
        assert router.tenant_of("moved") == "capT"
        router.scheduler.session_opened("capT")
        with router._lock:
            router._down["b0"] = "drill"
        router.commit_session("gone", backends[0], 40, sig, "capT")
        with pytest.raises(SessionUnknown):
            router.route_of("gone")
        assert router.stats().counters["router_sessions_lost"] == 1
        assert router.scheduler.sessions_of("capT") == 0
    finally:
        router.close()


@pytest.mark.parametrize("native", [False, True],
                         ids=["orphan", "target-with-native-sessions"])
def test_restore_target_dies_mid_restore_replaced_on_third(native):
    """A failover whose first restore target is dead re-places the
    session on a third instance.  With ``native``, the dead target's own
    session gets its own failover: accounted lost, its tenant's quota
    slot freed, never left routed to the dead instance."""
    fleet = _Fleet(front=False, start_health=False,
                   quotas={"capT": trouter.TenantQuota(max_sessions=1)})
    b0, b1, b2 = fleet.backends
    (k, g), = inputs(31, [(40, 8)])
    try:
        with RemoteService(fleet.srvs[0].url, timeout=120) as ca:
            s = ca.open_session(k, t_pop(g), "onemax", cxpb=0.6, mutpb=0.3,
                                name="orph")
            s.step(2)[1].result(timeout=120)
        sig = tsig(torch.zeros((1, 8)))
        fleet.router.commit_session("orph", b0, 40, sig, None)
        if native:
            fleet.router.scheduler.session_opened("capT")
            fleet.router.commit_session("native", b1, 40, sig, "capT")
            for i in range(2):      # b1 stays the least-loaded choice
                fleet.router.commit_session(f"pad-{i}", b2, 40, sig, None)
        assert fleet.router.toolbox_union() == ["onemax"]
        fleet.srvs[1].close()       # b1 dies before the restore reaches it
        out = fleet.router.failover(b0, reason="drill")
        assert out["restored"] == {"orph": "b2"} and out["lost"] == []
        assert fleet.router.health.is_sick("b1")
        assert fleet.router.route_of("orph").name == "b2"
        counters = fleet.router.stats().counters
        assert counters["router_orphans_replaced"] == 1
        if native:
            with pytest.raises(SessionUnknown):
                fleet.router.route_of("native")
            assert fleet.router.scheduler.sessions_of("capT") == 0
            assert counters["router_sessions_lost"] == 1
        with RemoteService(fleet.srvs[2].url, timeout=120) as cc:
            moved = cc.attach("orph")
            assert moved.gen == 2
            moved.step(1)[0].result(timeout=120)
    finally:
        fleet.close(dead={1})


def test_restore_skip_toolbox_orphans_replaced():
    """A target whose registry lost the toolbox skips the session; the
    router re-places it on an instance that still holds it, and traffic
    through the router goes on there."""
    fleet = _Fleet(start_health=False)
    (k, g), = inputs(37, [(40, 8)])
    cli = RemoteService(fleet.front.url, timeout=120)
    try:
        s = cli.open_session(k, t_pop(g), "onemax", cxpb=0.6, mutpb=0.3,
                             name="skipme")
        s.step(2)[1].result(timeout=120)
        home = fleet.router.route_of("skipme").name
        others = [b.name for b in fleet.backends if b.name != home]
        assert fleet.router.toolbox_union() == ["onemax"]
        fleet.srvs[int(others[0][1:])].toolboxes.pop("onemax")
        out = fleet.router.failover(fleet.router.backends[home],
                                    reason="drill")
        assert out["restored"] == {"skipme": others[1]} and out["lost"] == []
        s.step(1)[0].result(timeout=120)
        assert fleet.router.route_of("skipme").name == others[1]
        assert s.population().genome.shape == (40, 8)
    finally:
        cli.close()
        fleet.close()


@pytest.mark.parametrize("compress", [None, "zlib"])
def test_router_relays_compression_and_joins_spans(compress):
    """Through the router: the client's ``X-DTF-Accept`` is relayed on a
    bodyless GET (the backend compresses the population read) and
    compressed request frames reach the backend compressed
    (``net_frames_compressed`` / ``net_bytes_saved`` move there), the
    populations are the same bits either way, and one request's spans
    join client -> router.forward -> backend."""
    fleet = _Fleet(("port", "port"), start_health=False)
    (k, g), = inputs(47, [(160, 10)])   # 6400 B: past the 4096 B floor
    probe = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(48), 0.5,
                                            (160, 10)), np.float32)
    cli = RemoteService(fleet.front.url, timeout=120, compress=compress)
    try:
        s = cli.open_session(k, t_pop(g), "onemax", cxpb=0.6, mutpb=0.3,
                             name="zipped")
        s.step(2)[1].result(timeout=120)
        v = s.evaluate(probe).result(timeout=120)
        assert torch.equal(v[:, 0], torch.from_numpy(probe).sum(dim=1))
        pop = s.population()
        backend = fleet.router.route_of("zipped")
        svc = fleet.insts[int(backend.name[1:])][0]
        counters = backend.metrics()["counters"]
        # the client advertises zlib for responses either way (the
        # population read); with compress="zlib" its create and evaluate
        # frames travel compressed too
        assert counters["net_frames_compressed"] >= (3 if compress else 1)
        assert counters["net_bytes_saved"] > 0
        with RemoteService(backend.url, timeout=120) as plain:
            assert _same_final(_final(plain.attach("zipped").population()),
                               _final(pop))
        merged = join_spans({"client": cli.tracer.recent(),
                             "router": fleet.router.tracer.recent(),
                             "backend": svc.tracer.recent()})
        ev = [sp for sp in merged if sp["name"].startswith("client.POST")
              and sp["name"].endswith("/evaluate")]
        spans = [sp for sp in merged if sp["trace_id"] == ev[-1]["trace_id"]]
        [root] = [sp for sp in span_tree(spans)
                  if sp["attrs"]["source"] == "client"]
        hops = [c for c in root["children"]
                if c["attrs"]["source"] == "router"]
        assert hops and hops[0]["name"].startswith("router.forward")
        assert [g for c in hops for g in c["children"]
                if g["attrs"]["source"] == "backend"]
        names = {sp["name"] for sp in spans
                 if sp["attrs"].get("source") == "backend"}
        assert {"wire_decode", "serve.evaluate"} <= names
    finally:
        cli.close()
        fleet.close()


class _HangingHandler(BaseHTTPRequestHandler):
    """Answers nothing for ``hang_s`` seconds, then an empty frame: a
    wedged instance holding the socket open."""

    hang_s = 1.0

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
        time.sleep(self.hang_s)
        payload = protocol.encode_frame({"ok": True})
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except BrokenPipeError:     # the client gave up, as it should
            pass

    def log_message(self, fmt, *args):
        pass


def test_remote_request_timeout_is_typed_deadline():
    """``request_timeout`` fails the hung future with a typed
    ``DeadlineExceeded``, and the client's ordered worker lives on to
    time the next request out the same way."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _HangingHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with RemoteService(httpd.server_address, timeout=30,
                           request_timeout=0.3) as cli:
            rs = RemoteSession(cli, "phantom", weights=(1.0,), pop=8)
            for _ in range(2):
                [fut] = rs.step(1)
                with pytest.raises(DeadlineExceeded):
                    fut.result(timeout=10)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _records():
    rng = np.random.default_rng(5)
    counters = {k: int(v) for k, v in zip(
        tmetrics.SERVE_COUNTERS, rng.integers(0, 1000, 64))}
    gauges = {"queue_depth": 3.0, "pad_waste": 0.125,
              "latency_p50_ms": 12.5, "latency_step_p99_ms": 40.0,
              "router_failover_recovery_s": 0.25}
    tenants = {"acme": {"requests": 7, "steps": 5},
               'we"ird\\n': {"requests": 1}}
    programs = {"step|rows=64": {"kind": "step", "calls": 4,
                                 "device_min_s": 0.001, "compile_s": 0.5},
                "ask|rows=64": {"kind": "ask", "calls": 1,
                                "device_min_s": 0.002}}
    return [("router", 3, counters, gauges, {"source": "serve"}),
            ("b0", 17, counters, gauges, {"tenants": tenants}),
            ("b1", 0, {"steps": 2}, {}, {"tenants": tenants,
                                         "programs": programs})]


@pytest.mark.parametrize("programs", [False, True])
def test_prometheus_fleet_text_matches_jax(programs):
    """One exposition of router and backends, byte for byte JAX's, with
    and without a per-program profile table."""
    recs = [r for r in _records() if programs or r[0] != "b1"]
    port = {n: MetricRecord(gen=g, counters=c, gauges=gg, meta=m)
            for n, g, c, gg, m in recs}
    ref = {n: JRecord(gen=g, counters=c, gauges=gg, meta=m)
           for n, g, c, gg, m in recs}
    text = tmetrics.prometheus_fleet_text(port)
    assert text == jmetrics.prometheus_fleet_text(ref)
    assert text.count("# TYPE deap_tpu_serve_steps_total counter") == 1
    assert ('deap_tpu_serve_program_calls{instance="b1",kind="step",'
            'program="step|rows=64"} 4' in text) == programs
    assert tmetrics.ServeMetrics(
        extra_counters=tmetrics.ROUTER_COUNTERS,
        extra_gauges=tmetrics.ROUTER_GAUGES).snapshot().counters.keys() \
        >= set(jmetrics.ROUTER_COUNTERS)
