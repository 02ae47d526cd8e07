"""deap_tpu_torch.serve.net (the DTF1 wire, ``NetServer``,
``RemoteService``) against the JAX package's, on the CPU over loopback.

The wire is held byte for byte: ``encode_frame`` of the same object
(numpy arrays, the port's tensors, bfloat16 as torch's and as
``ml_dtypes``', uint32 key words, tuples, bytes, zlib) gives the JAX
package's bytes, and each package decodes the other's frames.  Then the
two packages drive each other over loopback, each trajectory bit for bit
against JAX's in-process service: a JAX ``RemoteService`` against the
port's ``NetServer``, the port's ``RemoteService`` against JAX's
``NetServer``, and sessions drained from a JAX server and adopted by the
port's through ``/v1/admin/restore``.  OneMax sums are exact, so the
comparisons are bitwise (tolerance 0).  Also: typed errors over the
wire (a kernel failure included), the metrics, profile and trace
endpoints, and the admin rebucket.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from deap_tpu import base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.serve import EvolutionService as JService
from deap_tpu.serve.net import NetServer as JNetServer
from deap_tpu.serve.net import RemoteService as JRemote
from deap_tpu.serve.net import protocol as jp
from deap_tpu_torch import base as tbase
from deap_tpu_torch.kernels import KernelLaunchError
from deap_tpu_torch.kernels.build import KernelBuildError
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.serve import (EvolutionService, ServeError,
                                  ServiceDraining, SessionUnknown)
from deap_tpu_torch.serve.net import NetServer, RemoteService
from deap_tpu_torch.serve.net import protocol as tp

torch.set_num_threads(1)

SHAPES = [(40, 8), (100, 12)]
NGEN = 4


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


def inputs(seed=12):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(SHAPES))
    return [(np.asarray(k), np.asarray(jax.random.bernoulli(
        k, 0.5, (n, d)), np.float32)) for k, (n, d) in zip(keys, SHAPES)]


def j_pop(g):
    return jbase.Population(jnp.asarray(g),
                            jbase.Fitness.empty(g.shape[0], (1.0,)))


def t_pop(g):
    return tbase.Population(torch.from_numpy(np.array(g)),
                            tbase.Fitness.empty(g.shape[0], (1.0,),
                                                device="cpu"))


@pytest.fixture(scope="module")
def reference():
    """JAX's in-process service: each session after NGEN and 2 NGEN
    steps."""
    tb = j_toolbox()
    out = {"half": [], "full": []}
    with JService(max_batch=4) as svc:
        ss = [svc.open_session(jnp.asarray(k), j_pop(g), tb, cxpb=0.6,
                               mutpb=0.3, name=f"run-{i}")
              for i, (k, g) in enumerate(inputs())]
        for s in ss:
            for f in s.step(NGEN):
                f.result(timeout=120)
        out["half"] = [_final(s.population()) for s in ss]
        for s in ss:
            for f in s.step(NGEN):
                f.result(timeout=120)
        out["full"] = [_final(s.population()) for s in ss]
    return out


# ---------------------------------------------------------------------------
# the frame codec
# ---------------------------------------------------------------------------

def _objects():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    f32[0, 0], f32[1, 1], f32[2, 2] = np.nan, np.inf, -0.0
    bf = rng.normal(size=(5,)).astype(np.float32)
    return [
        ({"a": f32}, {"a": torch.from_numpy(f32)}),
        ({"h": f32.astype(np.float16)},
         {"h": torch.from_numpy(f32).to(torch.float16)}),
        ({"b": bf.astype(ml_dtypes.bfloat16)},
         {"b": torch.from_numpy(bf).to(torch.bfloat16)}),
        ({"i": np.arange(-4, 4, dtype=np.int8)},
         {"i": torch.arange(-4, 4, dtype=torch.int8)}),
        ({"m": np.array([True, False, True])},
         {"m": torch.tensor([True, False, True])}),
        ({"key": np.array([0, 2**32 - 1], np.uint32)},
         {"key": np.array([0, 2**32 - 1], np.uint32)}),
        ({"w": (1.0, -1.0), "n": 3, "s": "x", "z": None, "blob": b"\x00\xff",
          "nested": [{"k": np.arange(3, dtype=np.int32)}, True]},
         {"w": (1.0, -1.0), "n": 3, "s": "x", "z": None, "blob": b"\x00\xff",
          "nested": [{"k": torch.arange(3, dtype=torch.int32)}, True]}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_encode_frame_byte_identical_to_jax(case):
    jobj, tobj = _objects()[case]
    jframe = jp.encode_frame(jobj)
    assert tp.encode_frame(tobj) == jframe
    assert tp.encode_frame(jobj) == jframe
    assert tp.encode_frame(tobj, deadline=2.5, accept=("zlib",)) == \
        jp.encode_frame(jobj, deadline=2.5, accept=("zlib",))
    # each package re-encodes its decode of the other's frame unchanged
    assert tp.encode_frame(tp.decode_frame(jframe)) == jframe
    assert tp.encode_frame(jp.decode_frame(tp.encode_frame(tobj))) == jframe


def test_zlib_trace_and_header_rewrites_match_jax():
    g = (np.random.default_rng(1).integers(0, 2, (4000, 16))
         .astype(np.float32))
    jf, jstats = jp.encode_frame_ex({"genome": g}, compress="zlib")
    tf, tstats = tp.encode_frame_ex({"genome": torch.from_numpy(g)},
                                    compress="zlib")
    assert tf == jf and tstats == jstats
    assert tstats["wire_payload_bytes"] < tstats["payload_bytes"]
    obj, meta = tp.decode_frame_with_meta(jf)
    assert _same(obj["genome"], g) and meta["compressed"] == "zlib"
    trace = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
    assert tp.rewrite_trace(jf, trace) == jp.rewrite_trace(jf, trace)
    assert tp.rewrite_header(jf, deadline=1.5) == \
        jp.rewrite_header(jf, deadline=1.5)
    bf = torch.tensor([1.5, -2.25, float("nan")]).to(torch.bfloat16)
    dec = tp.decode_frame(tp.encode_frame({"g": bf}))["g"]
    assert dec.dtype == torch.bfloat16
    assert torch.equal(dec.view(torch.int16), bf.view(torch.int16))
    with pytest.raises(ValueError):
        tp.decode_frame(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError):
        tp.decode_frame(jp.encode_frame({"genome": g})[:-3])
    with pytest.raises(TypeError):
        tp.encode_frame({0: np.zeros(2)})


def test_error_mapping_matches_jax():
    from deap_tpu.serve import dispatcher as jd
    from deap_tpu_torch.serve import dispatcher as td
    for name in ("SessionUnknown", "ServiceOverloaded", "DeadlineExceeded",
                 "ServiceDraining", "ServiceClosed", "RequestCancelled",
                 "TenantQuotaExceeded", "CircuitOpen", "ServiceBrownout",
                 "ServeError"):
        texc, jexc = getattr(td, name)("m"), getattr(jd, name)("m")
        assert tp.status_of(texc) == jp.status_of(jexc)
        assert tp.error_payload(texc, "http://x") == \
            jp.error_payload(jexc, "http://x")
        assert type(tp.remote_exception(name, "m")) is type(texc)
    assert tp.status_of(ValueError("x")) == 400
    assert isinstance(tp.remote_exception("NoSuchThing", "m"), ServeError)
    assert type(tp.remote_exception("KernelLaunchError", "m")) is \
        KernelLaunchError


# ---------------------------------------------------------------------------
# the two packages over loopback
# ---------------------------------------------------------------------------

def _drive(client, pops, toolbox_name="onemax", keys=None):
    sessions = [client.open_session(k, p, toolbox_name, cxpb=0.6, mutpb=0.3,
                                    name=f"run-{i}")
                for i, (k, p) in enumerate(zip(keys, pops))]
    for s in sessions:
        for f in s.step(NGEN):
            f.result(timeout=120)
    return sessions


def test_jax_client_drives_port_server(reference):
    ins = inputs()
    with EvolutionService(max_batch=4, device="cpu") as svc, \
            NetServer(svc, {"onemax": t_toolbox()}) as srv, \
            JRemote(srv.url, timeout=120) as cli:
        ss = _drive(cli, [j_pop(g) for _, g in ins], keys=[
            jnp.asarray(k) for k, _ in ins])
        for s, want in zip(ss, reference["half"]):
            assert _same_final(_final(s.population()), want)
        # ask / tell / evaluate from the JAX client
        off = np.asarray(ss[0].ask().result(timeout=60))
        ss[0].tell(off.sum(axis=1)).result(timeout=60)
        v = np.asarray(ss[0].evaluate(off[:5]).result(timeout=60))
        assert _same(v[:, 0], off[:5].sum(axis=1))
        assert cli.stats().counters["steps"] == NGEN * len(SHAPES)


def test_port_client_drives_jax_server(reference):
    ins = inputs()
    with JService(max_batch=4) as jsvc, \
            JNetServer(jsvc, {"onemax": j_toolbox()}) as srv, \
            RemoteService(srv.url, timeout=120) as cli:
        ss = _drive(cli, [t_pop(g) for _, g in ins],
                    keys=[k for k, _ in ins])
        for s, want in zip(ss, reference["half"]):
            got = s.population()
            assert isinstance(got.genome, torch.Tensor)
            assert _same_final(_final(got), want)
        for s in ss:
            for f in s.step(NGEN):
                f.result(timeout=120)
        for s, want in zip(ss, reference["full"]):
            assert _same_final(_final(s.population()), want)


def test_session_drained_from_jax_adopted_by_port(reference):
    """Sessions served by a JAX instance are drained, shipped over the
    wire and restored on the port's server (``/v1/admin/restore``): they
    continue JAX's undisturbed trajectory; the drained JAX instance
    refuses further work with a typed ``ServiceDraining``."""
    ins = inputs()
    with JService(max_batch=4) as jsvc, EvolutionService(
            max_batch=4, device="cpu") as svc, \
            JNetServer(jsvc, {"onemax": j_toolbox()}) as a, \
            NetServer(svc, {"onemax": t_toolbox()}) as b, \
            JRemote(a.url, timeout=120) as ca, \
            RemoteService(b.url, timeout=120) as cb:
        _drive(ca, [j_pop(g) for _, g in ins],
               keys=[jnp.asarray(k) for k, _ in ins])
        snap = ca.drain()
        assert sorted(snap) == ["run-0", "run-1"]
        with pytest.raises(Exception) as e:
            cb_stale = RemoteService(a.url, timeout=60)
            try:
                cb_stale.attach("run-0").step(1)[0].result(timeout=60)
            finally:
                cb_stale.close()
        assert isinstance(e.value, ServiceDraining)
        assert cb.restore(snap) == ["run-0", "run-1"]
        for i, want in enumerate(reference["full"]):
            s = cb.attach(f"run-{i}")
            assert s.gen == NGEN
            for f in s.step(NGEN):
                f.result(timeout=120)
            assert _same_final(_final(s.population()), want)
        # and back: the port's drain restores on a JAX instance
        back = cb.drain()
        with JService(max_batch=4) as jsvc2, \
                JNetServer(jsvc2, {"onemax": j_toolbox()}) as c, \
                JRemote(c.url, timeout=120) as cc:
            assert cc.restore(back) == ["run-0", "run-1"]
            assert _same_final(_final(cc.attach("run-0").population()),
                               reference["full"][0])



def test_port_client_follows_a_jax_failover_redirect(reference):
    """A JAX instance drained to the port's server and told where its
    sessions went (``/v1/admin/redirect``) answers a stale port client
    with a typed redirect; the client follows it and the session goes on
    with JAX's undisturbed trajectory.  ``follow_redirects=False`` sees
    the typed error instead."""
    ins = inputs()
    with JService(max_batch=4) as jsvc, EvolutionService(
            max_batch=4, device="cpu") as svc, \
            JNetServer(jsvc, {"onemax": j_toolbox()}) as a, \
            NetServer(svc, {"onemax": t_toolbox()}) as b, \
            JRemote(a.url, timeout=120) as ca, \
            RemoteService(b.url, timeout=120) as cb:
        _drive(ca, [j_pop(g) for _, g in ins],
               keys=[jnp.asarray(k) for k, _ in ins])
        assert cb.restore(ca.drain()) == ["run-0", "run-1"]
        ca._sync("POST", "/v1/admin/redirect", {"url": b.url})
        with RemoteService(a.url, timeout=60,
                           follow_redirects=False) as fixed:
            with pytest.raises(ServiceDraining):
                fixed.attach("run-1").step(1)[0].result(timeout=60)
        with RemoteService(a.url, timeout=120) as stale:
            s = stale.attach("run-1")
            assert s.gen == NGEN
            for f in s.step(NGEN):
                f.result(timeout=120)
            assert (stale.host, stale.port) == tuple(b.address)
            assert _same_final(_final(s.population()), reference["full"][1])

def test_port_wire_ask_tell_errors_endpoints_and_admin(reference):
    ins = inputs()
    with EvolutionService(max_batch=4, device="cpu") as svc, \
            NetServer(svc, {"onemax": t_toolbox()}) as srv, \
            RemoteService(srv.url, timeout=120) as cli:
        ss = _drive(cli, [t_pop(g) for _, g in ins],
                    keys=[k for k, _ in ins])
        for s, want in zip(ss, reference["half"]):
            assert _same_final(_final(s.population()), want)
        s = ss[0]
        off = s.ask().result(timeout=60)
        assert isinstance(off, torch.Tensor) and off.shape == (40, 8)
        with pytest.raises(ServeError):
            s.step(1)[0].result(timeout=60)    # mid-ask step, typed
        assert s.tell(off.sum(dim=1)).result(timeout=60)["gen"] == NGEN + 1
        with pytest.raises(ServeError):
            s.tell(np.zeros(40)).result(timeout=60)
        v = s.evaluate(off[:6]).result(timeout=60)
        assert _same(v[:, 0], off[:6].sum(dim=1))
        with pytest.raises(SessionUnknown):
            cli.attach("nobody")
        rec = cli.stats()
        assert rec.counters["steps"] == NGEN * len(SHAPES)
        assert rec.counters["net_bytes_in"] > 0
        recs = list(cli.stream_metrics(max_records=1, timeout=10))
        assert len(recs) == 1
        prof = cli.profile()
        assert prof["enabled"] and prof["programs"]
        assert all("aot" not in row for row in prof["programs"].values())
        assert cli.trace_tail(max_spans=16)["spans"]
        info = cli.rebucket(max_buckets=1)
        assert list(info["sizes"]) == [100] and info["compiles"] >= 1
        for f in ss[1].step(1):
            f.result(timeout=60)
        assert cli.healthz()["status"] == "ok"


@pytest.mark.parametrize("error", [KernelLaunchError, KernelBuildError])
def test_kernel_failure_reaches_the_client_typed(error):
    """A kernel that fails to build or launch fails the request, and the
    client raises the same class: nothing falls back to a plain
    version."""
    def hook(kind, requests):
        if kind == "step":
            raise error("megakernel_vary: an injected failure")

    with EvolutionService(max_batch=2, device="cpu", fault_hook=hook) as svc, \
            NetServer(svc, {"onemax": t_toolbox()}) as srv, \
            RemoteService(srv.url, timeout=60) as cli:
        k, g = inputs()[0]
        s = cli.open_session(k, t_pop(g), "onemax")
        with pytest.raises(error, match="injected"):
            s.step(1)[0].result(timeout=60)
        assert svc.stats().counters["failed"] == 1


def test_trace_context_and_rbg_key_ride_the_wire():
    """The client's trace context rides the frame header: the server's
    spans of a request carry the client's ``trace_id``.  An rbg key (4
    raw words) opens a session as a threefry key (2) does; its programs
    are its toolbox's own (the key's width is part of a slot's shapes,
    and a program refuses another, as a compiled JAX program does)."""
    from deap_tpu_torch import random as tr
    from deap_tpu_torch.observability import FleetTracer
    tracer = FleetTracer()
    with EvolutionService(max_batch=2, device="cpu") as svc, \
            NetServer(svc, {"onemax": t_toolbox(),
                            "onemax_rbg": t_toolbox()}) as srv, \
            RemoteService(srv.url, timeout=60, tracer=tracer) as cli:
        k, g = inputs()[0]
        s = cli.open_session(k, t_pop(g), "onemax")
        s.step(1)[0].result(timeout=60)
        client_ids = {sp["trace_id"] for sp in tracer.recent()}
        server_ids = {sp["trace_id"] for sp in svc.tracer.recent()}
        assert client_ids and client_ids & server_ids
        rbg = tr.PRNGKey(3, impl="rbg", device="cpu")
        r = cli.open_session(rbg, t_pop(g), "onemax_rbg", name="rbg")
        r.step(2)[1].result(timeout=60)
        snap = svc.export_session("rbg")
        assert snap["key"].dtype == np.uint32 and snap["key"].shape == (4,)
        assert snap["gen"] == 2
