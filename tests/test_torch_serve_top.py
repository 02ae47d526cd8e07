"""deap_tpu_torch.serve.top (the fleet dashboard) and the router CLI's
argument parsers against the JAX package's, on the CPU over loopback.

``aggregate`` and ``render_screen`` give JAX's output on the same
documents; ``--once --json`` against the port's router reports fleet
counters equal to the per-instance sums; instances mode needs no router;
live mode's tail threads are joined at close; ``parse_backend`` /
``parse_quota`` accept and refuse what JAX's do.  OneMax 40 / 48 x 8 at
``max_batch=4``.
"""

import argparse
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax

from deap_tpu.serve import top as jtop
from deap_tpu.serve.router import cli as jcli
from deap_tpu_torch import base
from deap_tpu_torch.ops import crossover, mutation, selection
from deap_tpu_torch.serve import EvolutionService
from deap_tpu_torch.serve import top
from deap_tpu_torch.serve.net import NetServer, RemoteService
from deap_tpu_torch.serve.router import (Backend, FleetRouter,
                                         PlacementPolicy, RouterServer)
from deap_tpu_torch.serve.router import cli as tcli

torch.set_num_threads(1)


def onemax_toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (torch.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def onemax_pop(key, n=40, nbits=8):
    g = np.asarray(jax.random.bernoulli(key, 0.5, (n, nbits)), np.float32)
    return base.Population(torch.from_numpy(g),
                           base.Fitness.empty(n, (1.0,), device="cpu"))


@pytest.fixture
def fleet():
    """Two port instances behind the port's router, placement spread 1
    (sessions alternate, so both carry traffic); four sessions of two
    tenants stepped 3 times.  Everything is closed after the test, and
    no thread it started is left alive."""
    threads0 = set(threading.enumerate())
    tb = onemax_toolbox()
    svcs = [EvolutionService(max_batch=4, device="cpu") for _ in range(2)]
    srvs = [NetServer(s, {"onemax": tb}).start() for s in svcs]
    router = FleetRouter([Backend(f"b{i}", s.address)
                          for i, s in enumerate(srvs)],
                         placement=PlacementPolicy(spread=1),
                         start_health=False)
    front = RouterServer(router).start()
    try:
        with RemoteService(front.url, timeout=120) as cli:
            keys = jax.random.split(jax.random.PRNGKey(21), 4)
            ss = [cli.open_session(np.asarray(k),
                                   onemax_pop(k, 40 + 8 * (i % 2)),
                                   "onemax", cxpb=0.6, mutpb=0.3,
                                   tenant=f"tenant-{i % 2}")
                  for i, k in enumerate(keys)]
            for s in ss:
                for f in s.step(3):
                    f.result(timeout=120)
        yield front, 12
    finally:
        front.close()
        for s in srvs:
            s.close()
        for s in svcs:
            s.close()
    deadline = time.monotonic() + 10    # handler threads see the close
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in threads0 and t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert not left, left


def _sum_pinned(doc, total_steps):
    per = {n: r["counters"] for n, r in doc["instances"].items()
           if r["error"] is None}
    for name, total in doc["fleet"]["counters"].items():
        assert total == sum(c.get(name, 0) for c in per.values()), name
    assert doc["fleet"]["counters"]["steps"] == total_steps
    return per


def test_once_json_fleet_counters_equal_instance_sum(fleet, capsys):
    front, total_steps = fleet
    doc = top.FleetTop(router=front.url).collect_once()
    assert set(doc["instances"]) == {"b0", "b1"}
    per = _sum_pinned(doc, total_steps)
    assert per["b0"]["steps"] > 0 and per["b1"]["steps"] > 0
    assert doc["fleet"]["instances_up"] == 2
    assert doc["router"]["sessions"] == 4 and doc["fleet"]["tenants"]
    assert top.main(["--router", front.url, "--once", "--json"]) == 0
    _sum_pinned(json.loads(capsys.readouterr().out), total_steps)
    assert top.main(["--router", front.url, "--once"]) == 0
    out = capsys.readouterr().out
    assert "deap-tpu-top" in out and "b0" in out and "b1" in out
    # live mode: one tail thread an instance, two frames, joined at close
    buf = io.StringIO()
    live = top.FleetTop(router=front.url)
    assert live.run_live(refresh=0.3, max_refreshes=2, out=buf) == 0
    assert buf.getvalue().count("deap-tpu-top") == 2
    assert not live._threads


def test_instances_mode_without_router():
    key = jax.random.PRNGKey(5)
    with EvolutionService(max_batch=4, device="cpu") as svc, \
            NetServer(svc, {"onemax": onemax_toolbox()}) as srv, \
            RemoteService(srv.url, timeout=120) as cli:
        s = cli.open_session(np.asarray(key), onemax_pop(key), "onemax",
                             cxpb=0.6, mutpb=0.3)
        for f in s.step(2):
            f.result(timeout=120)
        doc = top.FleetTop(instances=(f"live={srv.url}",
                                      "dead=127.0.0.1:9")).collect_once()
        assert doc["instances"]["live"]["error"] is None
        assert doc["instances"]["live"]["counters"]["steps"] == 2
        assert doc["instances"]["dead"]["error"]
        assert doc["fleet"]["instances_up"] == 1
        assert doc["fleet"]["counters"]["steps"] == 2
        assert "DOWN" in top.render_screen(doc)
    with pytest.raises(SystemExit):
        top.main(["--once"])                # neither router nor instances


def _documents():
    instances = {
        "a": {"error": None, "counters": {"steps": 3, "requests": 5},
              "gauges": {"queue_depth": 1, "pad_waste": 0.2,
                         "latency_p50_ms": 1.5, "latency_p99_ms": 9.0},
              "meta": {"tenants": {"t": {"requests": 2}}}},
        "b": {"error": None, "counters": {"steps": 4, "compiles": 2},
              "gauges": {"queue_depth": 2, "pad_waste": 0.5,
                         "slot_occupancy": 0.75, "latency_p99_ms": 4.0},
              "meta": {"tenants": {"t": {"requests": 1},
                                   "u": {"requests": 7, "rejected": 1}}}},
        "c": {"error": "ConnectionRefusedError: down"}}
    router = {"url": "http://127.0.0.1:1", "sessions": 3,
              "sick": {"c": "unreachable"}, "fleet_sizes": [64],
              "autoscale": {"decision": "out", "cooldown_remaining_s": 1.5,
                            "policy": {"min_instances": 1,
                                       "max_instances": 4},
                            "signals": {"instances": 2,
                                        "queue_depth": 3.0}}}
    return [({}, {}), (instances, {}),
            (instances, {"router": router,
                         "throughput": {"steps_per_s": 2.5}})]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("clear", [False, True])
def test_aggregate_and_render_match_jax(case, clear):
    instances, extra = _documents()[case]
    fleet = top.aggregate(instances)
    assert fleet == jtop.aggregate(instances)
    doc = {"instances": instances, "fleet": fleet, **extra}
    assert top.render_screen(doc, clear=clear) == \
        jtop.render_screen(doc, clear=clear)
    if case:
        assert fleet["counters"] == {"steps": 7, "requests": 5,
                                     "compiles": 2}
        assert fleet["instances_up"] == 2 and fleet["instances_total"] == 3


@pytest.mark.parametrize("spec", [
    "a=10.0.0.1:8077", "b=:8078", "c=[::1]:9", "x=host", "=h:1", "noeq",
    "d=h:port", "e=h:"])
def test_parse_backend_matches_jax(spec):
    _same_parse(tcli.parse_backend, jcli.parse_backend, spec)


@pytest.mark.parametrize("spec", [
    "gold=sessions:8,weight:3", "free=sessions:1", "t=pending:4",
    "t=", "t=weight:0", "t=weight:x", "t=bogus:1", "=sessions:1", "t",
    "t=sessions:1.5"])
def test_parse_quota_matches_jax(spec):
    _same_parse(tcli.parse_quota, jcli.parse_quota, spec)


def _same_parse(port, ref, spec):
    try:
        want = ref(spec)
    except argparse.ArgumentTypeError as e:
        with pytest.raises(argparse.ArgumentTypeError) as got:
            port(spec)
        assert str(got.value) == str(e)
        return
    got = port(spec)
    if isinstance(want[1], tuple):
        assert got == want
    else:       # (tenant, TenantQuota): the same fields
        assert got[0] == want[0]
        assert vars(got[1]) == vars(want[1])
