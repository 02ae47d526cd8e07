""":class:`RouterServer` — the fleet's DTF1 HTTP frontend.

Clients speak to the router exactly as they speak to one
:class:`~deap_tpu_torch.serve.net.server.NetServer` — the same paths, the same
frame codec, the same typed error envelopes — so the existing
:class:`~deap_tpu_torch.serve.net.client.RemoteService` works unchanged with a
router URL.  Per request the router:

1. **admits** — session creates pass tenant quotas and affinity
   placement (:meth:`FleetRouter.admit_session`); session-mutating ops
   take a weighted-fair forwarding slot first, so one tenant's burst
   cannot monopolize the fleet's dispatch parallelism;
2. **traces** — the client's ``__trace__`` header is adopted and
   REWRITTEN to the router's own hop
   (:func:`~deap_tpu_torch.serve.net.protocol.rewrite_trace` — header-only,
   tensor payloads untouched), so the backend's span tree hangs off a
   ``router.forward`` span that hangs off the client hop;
3. **forwards** — raw frames relayed to the routed backend over pooled
   keep-alive connections.  Compression negotiated end-to-end survives
   the hop because payload bytes are never touched;
4. **retries safely** — a forward the backend never received
   (:class:`~deap_tpu_torch.serve.router.backend.BackendDown` with
   ``sent=False``) or typed-rejected (``ServiceDraining``) re-routes
   after waiting for the failover to move the session, then retries —
   both cases provably never executed.  A mid-response death is NOT
   retried (the step may have applied); the client resyncs, exactly as
   it would against a bare instance.

Router-only surface (on top of the NetServer paths)::

    GET  /v1/admin/fleet            topology: backends, health, routes
                                    (?format=prometheus: ONE exposition
                                    covering the router plus every live
                                    backend's metrics, each sample
                                    labelled instance="..." — one scrape
                                    covers the fleet)
    POST /v1/admin/fleet/failover   {"backend": name} — manual drill
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Sequence, Tuple
from urllib.parse import parse_qs, quote, unquote, urlparse

from ...observability.sinks import MetricRecord, emit_text
from ..dispatcher import (CircuitOpen, DeadlineExceeded, ServeError,
                          ServiceOverloaded, SessionUnknown,
                          TenantQuotaExceeded)
from ..metrics import prometheus_fleet_text, prometheus_text
from ..net import protocol
from ..net.httpcommon import FleetHTTPServer, FrameHTTPHandler
from .backend import Backend, BackendDown
from .core import FleetRouter

__all__ = ["RouterServer"]

#: session-op names whose forwards take a weighted-fair slot
_FAIR_OPS = ("step", "ask", "tell", "evaluate")


class RouterServer:
    """Serve a :class:`FleetRouter` over HTTP (see module docstring).

    ``failover_wait`` bounds how long a safely-retryable forward waits
    for the routing table to move its session before giving up;
    ``acquire_timeout`` bounds the weighted-fair slot wait (a saturated
    fleet then sheds typed :class:`ServiceOverloaded`, mirroring the
    instance-level queue bound)."""

    def __init__(self, router: FleetRouter, *, host: str = "127.0.0.1",
                 port: int = 0, failover_wait: float = 30.0,
                 acquire_timeout: float = 60.0, sinks: Sequence = (),
                 verbose: bool = False, ssl_context=None):
        self.router = router
        self.failover_wait = float(failover_wait)
        self.acquire_timeout = float(acquire_timeout)
        self.sinks = list(sinks) or list(router.sinks)
        self.verbose = bool(verbose)
        ctx = self

        class Handler(_RouterHandler):
            server_ctx = ctx

        self._httpd = FleetHTTPServer((host, port), Handler)
        # TLS termination: same shape as NetServer — wrap the listening
        # socket once; every accepted connection then handshakes before
        # the HTTP layer sees a byte
        self._ssl_context = ssl_context
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RouterServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="deap-tpu-router-http", daemon=True)
            self._thread.start()
            if self.verbose:
                emit_text(f"[router] listening on {self.url} fronting "
                          f"{sorted(self.router.backends)}", self.sinks)
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()
        self.router.close()

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def address(self) -> tuple:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        scheme = "https" if self._ssl_context is not None else "http"
        return f"{scheme}://{host}:{port}"


class _RouterHandler(FrameHTTPHandler):
    """One connection's requests, routed into the :class:`RouterServer`
    context.  The keep-alive wire plumbing — body read, byte counters,
    error envelopes, unread-body drain — is the shared
    :class:`~deap_tpu_torch.serve.net.httpcommon.FrameHTTPHandler` base, the
    same copy the instance handler uses."""

    server_ctx: RouterServer = None     # bound by RouterServer
    log_prefix = "router"

    # -- plumbing ------------------------------------------------------------

    def _handler_metrics(self):
        ctx = self.server_ctx
        return ctx.router.metrics if ctx is not None else None

    def _log_conf(self):
        ctx = self.server_ctx
        if ctx is None:
            return False, ()
        return ctx.verbose, ctx.sinks

    def _send_error_obj(self, exc: BaseException) -> None:
        self.server_ctx.router.metrics.inc("router_errors")
        if isinstance(exc, TenantQuotaExceeded):
            # both rejection shapes — session quota at create, backlog
            # quota at the fair scheduler — count as admission decisions
            self.server_ctx.router.metrics.inc("router_quota_rejections")
        self._send_error_envelope(exc)

    def _respond_raw(self, status: int, data: bytes) -> None:
        """Relay a backend's response bytes (frame or error envelope —
        the client's decoder handles both).  Error envelopes are
        sanitized first: a backend's failover ``location`` must never
        reach a router client, or its redirect-following would re-point
        it AT the backend and bypass quotas/scheduling for good."""
        if status >= 400 and data[:4] != protocol.MAGIC:
            data = _strip_redirect(data)
        ctype = (protocol.CONTENT_TYPE if data[:4] == protocol.MAGIC
                 else "application/json")
        self._send(data, status=status, content_type=ctype)

    # -- routing -------------------------------------------------------------

    def _route(self, method: str) -> None:
        ctx = self.server_ctx
        router = ctx.router
        router.metrics.inc("router_requests")
        self._body_consumed = False
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts[:1] != ["v1"]:
                raise SessionUnknown(f"unknown path {url.path!r}")
            rest = parts[1:]
            if method == "GET" and rest == ["healthz"]:
                return self._healthz()
            if method == "GET" and rest == ["toolboxes"]:
                return self._send_json(
                    {"toolboxes": router.toolbox_union()})
            if method == "GET" and rest == ["metrics"]:
                return self._metrics(parse_qs(url.query))
            if method == "GET" and rest == ["trace"]:
                return self._trace_tail(parse_qs(url.query))
            if method == "GET" and rest == ["admin", "fleet"]:
                query = parse_qs(url.query)
                if query.get("format", [""])[0] == "prometheus":
                    return self._fleet_prometheus()
                return self._send_json(router.topology())
            if (method == "POST" and rest == ["admin", "fleet",
                                              "failover"]):
                return self._manual_failover()
            if rest[:1] == ["sessions"]:
                if method == "POST" and len(rest) == 1:
                    return self._create()
                if len(rest) == 2 and method in ("GET", "DELETE"):
                    return self._session_op(method, unquote(rest[1]), None)
                if method == "POST" and len(rest) == 3 \
                        and rest[2] in _FAIR_OPS:
                    return self._session_op(method, unquote(rest[1]),
                                            rest[2])
            raise SessionUnknown(f"unknown path {url.path!r}")
        except BrokenPipeError:
            raise
        except Exception as e:  # noqa: BLE001 — typed over the wire
            try:
                self._send_error_obj(e)
            except BrokenPipeError:
                pass

    # -- router-local endpoints ----------------------------------------------

    def _healthz(self) -> None:
        router = self.server_ctx.router
        sick = router.health.sick()
        self._send_json({
            "status": "ok" if len(sick) < len(router.backends) else "sick",
            "role": "router",
            "backends": {n: ("sick" if n in sick else "ok")
                         for n in router.backends},
            "sessions": router.stats().gauges["router_sessions_routed"]})

    def _metrics(self, query) -> None:
        rec = self.server_ctx.router.stats()
        if query.get("format", [""])[0] == "prometheus":
            return self._send(
                prometheus_text(rec).encode("utf-8"),
                content_type="text/plain; version=0.0.4; charset=utf-8")
        self._send_json(json.loads(rec.to_json()))

    def _fleet_prometheus(self) -> None:
        """``GET /v1/admin/fleet?format=prometheus`` — the whole fleet
        in one exposition: the router's own record plus every reachable
        backend's ``/v1/metrics`` snapshot, merged so each metric family
        is declared once and every sample carries an ``instance`` label.
        Unreachable/down backends degrade to a comment line (the scrape
        must not fail because one instance is mid-failover)."""
        router = self.server_ctx.router
        records = {"router": router.stats()}
        down: list = []
        sick = router.health.sick()
        live = [n for n in sorted(router.backends) if n not in sick]
        down += [f"# backend {n} sick: excluded"
                 for n in sorted(router.backends) if n in sick]
        # fetch the backends CONCURRENTLY: one wedged-but-not-yet-sick
        # instance must cost the scrape its own control timeout once,
        # not once per position in a sequential walk — a fleet scrape
        # that overruns Prometheus's scrape_timeout drops every
        # instance's samples, not just the slow one's
        results: dict = {}

        def fetch(name: str) -> None:
            try:
                results[name] = router.backends[name].metrics()
            except (BackendDown, ServeError, OSError, ValueError) as e:
                # ValueError covers a malformed/truncated body from an
                # instance mid-restart (Backend._control's json.loads;
                # UnicodeDecodeError is its subclass) — the scrape must
                # degrade that instance to a comment, not kill the thread
                results[name] = e
        threads = [threading.Thread(target=fetch, args=(n,),
                                    name=f"deap-tpu-router-scrape-{n}",
                                    daemon=True) for n in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join()        # bounded by each backend's control timeout
        for name in live:
            rec = results.get(name)
            if rec is None or isinstance(rec, Exception):
                down.append(f"# backend {name} unreachable: "
                            f"{type(rec).__name__ if rec else 'missing'}")
                continue
            records[name] = MetricRecord(
                gen=int(rec.get("gen", 0)),
                counters=rec.get("counters", {}),
                gauges=rec.get("gauges", {}),
                meta=rec.get("meta", {}) or {})
        text = prometheus_fleet_text(records)
        if down:
            text += "\n".join(down) + "\n"
        self._send(text.encode("utf-8"),
                   content_type="text/plain; version=0.0.4; charset=utf-8")

    def _trace_tail(self, query) -> None:
        tracer = self.server_ctx.router.tracer
        n = int(query.get("max", ["256"])[0])
        trace_id = query.get("trace_id", [None])[0]
        self._send_json({"enabled": bool(tracer.enabled),
                         "dropped": tracer.dropped,
                         "spans": tracer.recent(n, trace_id=trace_id)})

    def _manual_failover(self) -> None:
        router = self.server_ctx.router
        raw = self._read_raw_body()
        if raw[:4] == protocol.MAGIC:
            body = protocol.decode_frame(raw)
        else:
            body = json.loads(raw.decode("utf-8")) if raw else {}
        name = body.get("backend")
        backend = router.backends.get(name)
        if backend is None:
            raise SessionUnknown(f"no backend named {name!r}")
        router.health.force_sick(name, "manual failover")
        self._send_json(
            {"backend": name, "sick": router.health.is_sick(name)})

    # -- the create path (decode once: placement needs the shape) ------------

    def _create(self) -> None:
        ctx = self.server_ctx
        router = ctx.router
        raw = self._read_raw_body()
        if raw[:4] != protocol.MAGIC:
            raise ValueError("session create requires a DTF1 frame body")
        body, meta = protocol.decode_frame_with_meta(raw)
        trace_ctx = router.tracer.adopt(meta["trace"])
        backend, tenant, name, n, sig = router.admit_session(body)
        body["name"] = name
        # re-encode (the one path the router must decode, for placement)
        # with the sender's own codec — the initial population is the
        # protocol's largest payload, and decoding must not strip its
        # compression for the router→backend leg
        frame = protocol.encode_frame(
            body, trace=None if trace_ctx is None else trace_ctx.wire(),
            accept=meta["accept"], compress=meta["compressed"])
        t0 = router.tracer.clock()
        try:
            status, data = backend.forward(
                "POST", "/v1/sessions", frame,
                accept=self.headers.get(protocol.ACCEPT_HEADER))
        except CircuitOpen:
            # the breaker refused pre-send (placement raced its opening)
            # — the backend never saw the create: release the admission
            # and surface the typed 503
            router.abort_session(name, tenant)
            raise
        except BackendDown as e:
            router.abort_session(name, tenant)
            router.note_forward_failure(backend, e)
            raise ServeError(f"create failed: {e}") from e
        router.metrics.inc("router_forwards")
        if status >= 400:
            router.abort_session(name, tenant)
        else:
            router.commit_session(name, backend, n, sig, tenant)
        if trace_ctx is not None:
            router.tracer.record(
                "router.forward POST /v1/sessions", trace_ctx, t0,
                router.tracer.clock(),
                attrs={"backend": backend.name, "status": status,
                       "session": name, "tenant": tenant})
        self._respond_raw(status, data)

    # -- forwarded session ops -----------------------------------------------

    def _session_op(self, method: str, name: str,
                    op: Optional[str]) -> None:
        ctx = self.server_ctx
        router = ctx.router
        t_in = router.tracer.clock()
        raw = self._read_raw_body() if method == "POST" else b""
        tenant = router.tenant_of(name)
        quoted = quote(name, safe="")
        path = (f"/v1/sessions/{quoted}/{op}" if op
                else f"/v1/sessions/{quoted}")
        # router hop in the span tree + deadline budget: adopt the
        # client context and remaining-deadline from the frame header,
        # swap in this hop's identity and the DECREMENTED budget — one
        # header rewrite, payloads untouched
        trace_ctx = None
        budget = None
        is_frame = raw[:4] == protocol.MAGIC
        if is_frame:
            _hdr, _off = protocol._split_header(raw)
            trace_ctx = router.tracer.adopt(_hdr.get("__trace__"))
            d = _hdr.get("__deadline__")
            if isinstance(d, (int, float)) and not isinstance(d, bool):
                budget = float(d)
        fair = op in _FAIR_OPS
        if fair:
            try:
                router.scheduler.acquire(tenant,
                                         timeout=ctx.acquire_timeout)
            except TimeoutError as e:
                raise ServiceOverloaded(
                    f"router forwarding saturated: {e}") from e
        t0 = router.tracer.clock()
        body = raw
        try:
            if is_frame and (trace_ctx is not None or budget is not None):
                kw = {}
                if trace_ctx is not None:
                    kw["trace"] = trace_ctx.wire()
                if budget is not None:
                    # everything the router spent on this request — body
                    # read, header parse, the fair-scheduler slot wait —
                    # comes out of the client's remaining budget
                    remaining = budget - (t0 - t_in)
                    if remaining <= 0.0:
                        router.metrics.inc("router_deadline_shed")
                        raise DeadlineExceeded(
                            f"deadline budget spent at the router hop "
                            f"({-remaining:.3f}s over, {budget:.3f}s "
                            "arrived); not forwarded")
                    kw["deadline"] = remaining
                body = protocol.rewrite_header(raw, **kw)
            status, data, backend = self._forward_routed(
                method, name, path, body,
                accept=self.headers.get(protocol.ACCEPT_HEADER))
        finally:
            if fair:
                router.scheduler.release(tenant)
        if method == "DELETE" and status < 400:
            router.forget_session(name)
        if trace_ctx is not None:
            router.tracer.record(
                f"router.forward {method} {path}", trace_ctx, t0,
                router.tracer.clock(),
                attrs={"backend": backend.name, "status": status,
                       "session": name, "tenant": tenant})
        self._respond_raw(status, data)

    def _forward_routed(self, method: str, name: str, path: str,
                        body: bytes, accept: Optional[str] = None
                        ) -> Tuple[int, bytes, Backend]:
        """Forward to the session's routed backend; re-route and retry
        ONLY failures that provably never executed (unreachable before
        send, or typed ServiceDraining rejections) — a failover in
        flight moves the session, and the retry lands on its new home."""
        ctx = self.server_ctx
        router = ctx.router
        last_exc: Optional[Exception] = None
        for attempt in range(3):
            backend = router.route_of(name)     # SessionUnknown when lost
            if attempt:
                router.metrics.inc("router_forward_retries")
            try:
                status, data = backend.forward(method, path, body or None,
                                               accept=accept)
            except CircuitOpen:
                # refused pre-send (provably unexecuted) — but the
                # session is still ROUTED here (breaker-open means
                # degraded, not failed over), so waiting for a re-route
                # would only time out: surface the typed 503 and let the
                # client back off until a probe closes the circuit
                raise
            except BackendDown as e:
                router.note_forward_failure(backend, e)
                if e.sent:
                    # the instance may have executed this op — never
                    # silently re-send a step/tell
                    raise ServeError(
                        f"backend {backend.name} died mid-request; resync "
                        f"the session state ({e})") from e
                last_exc = e
                router.wait_rerouted(name, backend.name,
                                     timeout=ctx.failover_wait)
                continue
            router.metrics.inc("router_forwards")
            if status < 400:
                return status, data, backend
            err = _envelope_error(data)
            retryable = err == "ServiceDraining"
            if err == "SessionUnknown":
                # a live migration's export can beat its route-table
                # commit: the source already exported (and forgot) the
                # session while the routing table still points there.
                # Provably unexecuted — wait for the commit, retry on
                # the new home.  A session the router itself no longer
                # routes is a genuine 404 and surfaces as-is.
                try:
                    retryable = router.route_of(name) is backend
                except SessionUnknown:
                    retryable = False
            if not retryable:
                return status, data, backend
            # typed rejection (draining / mid-migration): the op never
            # executed; wait for the re-route to commit, then retry
            last_exc = None
            if not router.wait_rerouted(name, backend.name,
                                        timeout=ctx.failover_wait):
                return status, data, backend
        if last_exc is not None:
            raise ServeError(
                f"session {name!r} unreachable after retries: "
                f"{last_exc}") from last_exc
        return status, data, backend


def _strip_redirect(data: bytes) -> bytes:
    """Drop ``location`` from a relayed JSON error envelope; anything
    unparsable is returned untouched."""
    try:
        doc = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return data
    if not isinstance(doc, dict) or "location" not in doc:
        return data
    doc.pop("location")
    return json.dumps(doc).encode("utf-8")


def _envelope_error(data: bytes) -> Optional[str]:
    """The typed error class name from a JSON error envelope, or None
    for frames / unparsable bodies."""
    if data[:4] == protocol.MAGIC or not data:
        return None
    try:
        doc = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    err = doc.get("error")
    return err if isinstance(err, str) else None
