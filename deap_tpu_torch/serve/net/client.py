""":class:`RemoteService` / :class:`RemoteSession` — the in-process
``Session`` API over the wire.

A ``RemoteSession`` mirrors :class:`deap_tpu_torch.serve.service.Session`:
``step(n)`` returns ``n`` :class:`~deap_tpu_torch.serve.dispatcher.ServeFuture`
objects, ``ask``/``tell``/``evaluate`` return one — the same shapes, the
same typed exceptions (rebuilt from the wire error envelope), the same
bitwise trajectories (held against in-process serving by
``tests/test_torch_serve_net.py``).  Results come back as CPU tensors:
the client does no device work.  Keys travel as raw ``uint32`` words and
frames are the JAX package's byte for byte, so this client drives a JAX
``NetServer`` too.  Ordering is preserved the same way the
in-process dispatcher preserves it: one background worker thread owns the
session-mutating HTTP connection and sends requests strictly in
submission order, resolving futures as responses land.  ``step(n)``
travels as ONE request carrying ``n`` (a per-generation result list comes
back), so pipelined stepping costs one round trip per *call*, not per
generation.

Failover from the client's side is symmetric to the server's
drain/restore::

    snap = RemoteService(a_url).drain()      # instance A quiesces + snapshots
    b = RemoteService(b_url)
    b.restore(snap)                          # instance B adopts every session
    s = b.attach("run-0")                    # continue, bitwise

Synchronous reads (``population()``, ``stats()``, admin calls) use
per-call connections so they never queue behind a long step pipeline.
"""

from __future__ import annotations

import http.client
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple
from urllib.parse import quote

import numpy as np
import torch

from ... import sanitize
from ...base import Population, Fitness
from ...observability.fleettrace import FleetTracer
from ...observability.sinks import MetricRecord
from ...resilience.retry import with_retries, RetriesExhausted
from ..dispatcher import (DeadlineExceeded, ServeError, ServeFuture,
                          ServiceClosed)
from . import protocol

__all__ = ["RemoteService", "RemoteSession"]


def _parse_url(address) -> Tuple[str, str, int]:
    """``(scheme, host, port)`` of an address — tuple/list, bare
    ``host:port`` (scheme defaults to http), or an http(s) URL."""
    if isinstance(address, (tuple, list)):
        return "http", str(address[0]), int(address[1])
    addr = str(address)
    scheme = "http"
    for s in ("http", "https"):
        prefix = f"{s}://"
        if addr.startswith(prefix):
            scheme, addr = s, addr[len(prefix):]
            break
    addr = addr.rstrip("/")
    host, _, port = addr.rpartition(":")
    if not host:
        raise ValueError(f"address {address!r} needs host:port")
    return scheme, host, int(port)


def _parse_address(address) -> Tuple[str, int]:
    return _parse_url(address)[1:]


def _make_connection(host: str, port: int, *, timeout: float,
                     ssl_context=None) -> http.client.HTTPConnection:
    """One client connection; an ``ssl.SSLContext`` switches it to TLS
    (``HTTPSConnection`` — the context's verify mode/CA set governs how
    the server certificate is checked)."""
    if ssl_context is not None:
        return http.client.HTTPSConnection(host, port, timeout=timeout,
                                           context=ssl_context)
    return http.client.HTTPConnection(host, port, timeout=timeout)


class _Worker:
    """One thread + FIFO queue owning the ordered (session-mutating) HTTP
    connection — the client-side mirror of the dispatcher's single worker
    thread.  Jobs run strictly in submission order; a job's ``resolve``
    callback receives ``(result, exception)``."""

    #: lock-guarded shared state: the failover retarget latch is written from any
    #: redirect-following thread and consumed by the worker
    _GUARDED_BY = {"_target_lock": ("_pending_target",)}

    def __init__(self, host: str, port: int, timeout: float,
                 request_timeout: Optional[float] = None,
                 retry_budget: int = 2, backoff: float = 0.05,
                 max_backoff: float = 2.0,
                 rng: Optional[Callable[[], float]] = None,
                 ssl_context=None):
        self._host, self._port, self._timeout = host, port, timeout
        self._ssl_context = ssl_context
        #: per-request response deadline (socket timeout on the ordered
        #: connection): a hung backend fails the ONE waiting future with
        #: typed DeadlineExceeded instead of blocking this worker thread
        #: forever; None falls back to the connection timeout
        self._request_timeout = request_timeout
        #: send-phase reconnect budget PER REQUEST: a request that never
        #: hit the wire may be re-sent at most this many times, each
        #: retry backed off exponentially with full jitter so a fleet of
        #: clients doesn't hammer a flapping backend in lockstep
        self._retry_budget = int(retry_budget)
        if self._retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        self._backoff = float(backoff)
        self._max_backoff = float(max_backoff)
        self._rng = rng
        #: set by close(): interrupts any in-progress backoff nap so a
        #: closing client never waits out a retry schedule
        self._wake = sanitize.event()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._jobs: "queue.Queue" = queue.Queue()
        self._closed = False
        # retargets land here from ANY thread (a _sync caller following
        # a redirect) and are applied by the worker thread itself at its
        # next _connection() — the worker owns the live connection, and
        # closing it cross-thread would kill a response mid-read
        self._target_lock = sanitize.lock()
        self._pending_target: Optional[Tuple[str, int]] = None
        self._thread = threading.Thread(target=self._run,
                                        name="deap-tpu-remote", daemon=True)
        self._thread.start()

    def retarget(self, host: str, port: int) -> None:
        """Point the ordered connection at a new instance (failover
        redirect).  Thread-safe: the new address is latched and the
        worker thread applies it — dropping its own connection — before
        its next request."""
        with self._target_lock:
            self._pending_target = (host, int(port))

    def submit(self, job: Callable, resolve: Callable) -> None:
        if self._closed:
            raise ServiceClosed("remote client is closed")
        self._jobs.put((job, resolve))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._wake.set()          # abort any backoff nap in progress
            self._jobs.put(None)
            self._thread.join(timeout=10.0)
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _connection(self) -> http.client.HTTPConnection:
        with self._target_lock:
            target, self._pending_target = self._pending_target, None
        if target is not None and target != (self._host, self._port):
            self._host, self._port = target
            self._drop_connection()
        if self._conn is None:
            t = (self._request_timeout if self._request_timeout is not None
                 else self._timeout)
            self._conn = _make_connection(self._host, self._port, timeout=t,
                                          ssl_context=self._ssl_context)
        return self._conn

    def _backoff_wait(self, delay: float) -> None:
        """Interruptible backoff nap between send-phase reconnects —
        an Event wait, never a blocking sleep, so close() aborts the
        schedule instead of waiting it out."""
        if self._wake.wait(delay):
            raise ServiceClosed("remote client closed during backoff")

    def _attempt(self, job: Callable) -> Any:
        """One send attempt; a send-phase failure drops the (poisoned)
        connection before propagating so the next attempt reconnects."""
        try:
            return job(self._connection())
        except _SendFailed:
            self._drop_connection()
            raise

    def _run(self) -> None:
        # the per-request send retry policy: only _SendFailed (request
        # provably never hit the wire) is retried — capped exponential
        # backoff with FULL jitter, at most retry_budget re-sends.  A
        # response-phase failure is never re-sent: the server may have
        # executed the request, and re-sending would double-apply it.
        while True:
            item = self._jobs.get()
            if item is None:
                while not self._jobs.empty():      # fail queued stragglers
                    tail = self._jobs.get()
                    if tail is not None:
                        tail[1](None, ServiceClosed("remote client closed"))
                return
            job, resolve = item
            send = with_retries(
                lambda: self._attempt(job), retries=self._retry_budget,
                backoff=self._backoff, max_backoff=self._max_backoff,
                jitter=True, rng=self._rng, retry_on=(_SendFailed,),
                sleep=self._backoff_wait)
            try:
                result = send()
            except RetriesExhausted as e:
                # every send attempt failed before reaching the wire —
                # surface the last transport error, budget spent
                resolve(None, e.last.cause
                        if isinstance(e.last, _SendFailed) else e.last)
                continue
            except TimeoutError as e:
                # the per-request deadline passed with no response: the
                # typed failure the serving stack already speaks.  The
                # connection is poisoned (a late response would answer
                # the WRONG request) — drop it; the worker moves on to
                # the next job instead of blocking forever
                self._drop_connection()
                resolve(None, DeadlineExceeded(
                    "no response from "
                    f"{self._host}:{self._port} within "
                    f"{self._request_timeout or self._timeout}s "
                    f"({e or 'socket timeout'})"))
                continue
            except (http.client.HTTPException, OSError) as e:
                # response-phase failure: the server MAY have executed the
                # request (a step/tell is not idempotent), so fail the
                # future instead of silently re-sending — the caller can
                # resync via population()/attach()
                self._drop_connection()
                resolve(None, e)
                continue
            except Exception as e:  # noqa: BLE001
                resolve(None, e)
                continue
            resolve(result, None)

    def _drop_connection(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class _SendFailed(Exception):
    """Transport failure BEFORE the request reached the wire — the server
    cannot have executed it, so a retry on a fresh connection is safe.
    (A response-phase failure is NOT retried: the server may already have
    applied a step/tell, and re-sending would silently double-apply.)"""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def _request(conn: http.client.HTTPConnection, method: str, path: str,
             obj: Any = None, trace: Any = None,
             deadline: Optional[float] = None,
             compress: Optional[str] = None,
             accept: Tuple[str, ...] = ("zlib",)) -> Any:
    body = (None if obj is None
            else protocol.encode_frame(obj, trace=trace, deadline=deadline,
                                       compress=compress, accept=accept))
    headers = {"Content-Type": protocol.CONTENT_TYPE}
    if accept:
        # bodyless requests (population GETs — the responses most worth
        # compressing) advertise through the HTTP header channel
        headers[protocol.ACCEPT_HEADER] = ",".join(accept)
    try:
        conn.request(method, path, body=body, headers=headers)
    except (http.client.HTTPException, OSError) as e:
        # an incomplete HTTP request is never processed server-side
        raise _SendFailed(e)
    resp = conn.getresponse()
    data = resp.read()
    if resp.status >= 400:
        try:
            err = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise ServeError(f"HTTP {resp.status}: {data[:200]!r}")
        exc = protocol.remote_exception(err.get("error", "ServeError"),
                                        err.get("message", ""))
        # a drained instance's envelope may carry the replacement's URL;
        # the caller (RemoteService) follows it — the rejected request
        # never executed, so a re-send cannot double-apply
        loc = err.get("location")
        if isinstance(loc, str) and loc:
            exc.remote_location = loc
        raise exc
    if not data:
        return None
    if data[:4] == protocol.MAGIC:
        return protocol.decode_frame(data)
    return json.loads(data.decode("utf-8"))


class RemoteService:
    """Client handle on one :class:`~deap_tpu_torch.serve.net.server.NetServer`
    instance (see module docstring).  ``address`` is ``"host:port"``,
    ``(host, port)`` or an ``http://`` URL.

    ``request_timeout`` bounds each ordered request's wait for a
    response: a hung backend fails that ONE future with typed
    :class:`~deap_tpu_torch.serve.dispatcher.DeadlineExceeded` (and the worker
    reconnects for the next job) instead of wedging the ordered pipeline
    forever.  ``compress="zlib"`` deflates outgoing tensor payloads (big
    tells/evaluates); the client always advertises what it can inflate,
    so servers compress responses regardless.  ``follow_redirects``
    (default on) makes the client transparently re-target when a drained
    instance's error envelope names the replacement — the failover moves
    without the caller seeing an exception.

    ``retry_budget`` caps how many times ONE request may be re-sent after
    a send-phase transport failure (the request provably never reached
    the wire); the re-sends back off exponentially with full jitter, so
    a flapping backend sees a bounded, de-synchronized retry stream
    instead of every client hammering it in lockstep."""

    def __init__(self, address, *, timeout: float = 600.0,
                 request_timeout: Optional[float] = None,
                 compress: Optional[str] = None,
                 follow_redirects: bool = True,
                 retry_budget: int = 2,
                 tracer: Optional[FleetTracer] = None,
                 ssl_context=None):
        scheme, self.host, self.port = _parse_url(address)
        #: TLS client side: an ``ssl.SSLContext`` governs certificate
        #: verification for every connection (ordered worker, per-call
        #: syncs, the metrics stream).  An ``https://`` address with no
        #: explicit context gets the stdlib default (system CAs,
        #: hostname verification on).
        if ssl_context is None and scheme == "https":
            import ssl as _ssl
            ssl_context = _ssl.create_default_context()
        self.ssl_context = ssl_context
        self.timeout = float(timeout)
        self.request_timeout = (None if request_timeout is None
                                else float(request_timeout))
        if compress is not None and compress not in protocol.WIRE_CODECS:
            raise ValueError(f"unknown wire codec {compress!r} "
                             f"(have {sorted(protocol.WIRE_CODECS)})")
        self.compress = compress
        self.follow_redirects = bool(follow_redirects)
        #: client-side span recorder: every ordered (session-mutating)
        #: request mints a root TraceContext here that rides the DTF1
        #: frame header, so the server's span tree links back to the
        #: client hop.  Pass FleetTracer(enabled=False) to opt out.
        self.tracer = tracer if tracer is not None else FleetTracer(
            capacity=1024)
        self._worker = _Worker(self.host, self.port, self.timeout,
                               request_timeout=self.request_timeout,
                               retry_budget=retry_budget,
                               ssl_context=ssl_context)
        self._closed = False

    # -- plumbing ------------------------------------------------------------

    def _redirect_target(self, exc: BaseException) -> Optional[Tuple[str,
                                                                     int]]:
        """(host, port) of the replacement instance a typed error names,
        when redirect-following applies."""
        loc = getattr(exc, "remote_location", None)
        if not self.follow_redirects or not loc:
            return None
        try:
            return _parse_address(loc)
        except ValueError:
            return None

    def _retarget(self, host: str, port: int) -> None:
        """Re-point this client at a replacement instance.  Called on
        the ordered worker thread (which owns the ordered connection) or
        from a _sync caller — either way the rejected request is about
        to be re-sent to the new address."""
        self.host, self.port = host, int(port)
        self._worker.retarget(host, port)

    def _sync(self, method: str, path: str, obj: Any = None) -> Any:
        """Out-of-band request on a fresh connection (never queues behind
        the ordered worker); follows at most one failover redirect."""
        for _hop in range(2):
            conn = _make_connection(self.host, self.port,
                                    timeout=self.timeout,
                                    ssl_context=self.ssl_context)
            try:
                return _request(conn, method, path, obj,
                                compress=self.compress)
            except ServeError as e:
                target = self._redirect_target(e)
                if target is None or _hop:
                    raise
                self._retarget(*target)
            finally:
                conn.close()

    def _ordered_raw(self, method: str, path: str, obj: Any,
                     resolve: Callable[[Any, Optional[BaseException]], None],
                     deadline: Optional[float] = None) -> None:
        """Queue one request on the ordered worker connection;
        ``resolve(result, exc)`` runs on the worker thread.  With tracing
        on, the request's root :class:`TraceContext` is minted HERE (at
        submission) and reused verbatim across the worker's send-phase
        reconnect retry — a retried request keeps its trace identity.
        ``deadline`` (seconds from now) becomes the request's deadline
        BUDGET: the time already burned waiting in the client queue (and
        across reconnect backoffs) is subtracted at send, so the header's
        ``__deadline__`` carries what actually remains."""
        ctx = self.tracer.context() if self.tracer.enabled else None
        t_submit = time.monotonic()

        def job(conn):
            t0 = self.tracer.clock() if ctx is not None else 0.0
            wire_ctx = None if ctx is None else ctx.wire()
            budget = (None if deadline is None else
                      max(0.0, float(deadline)
                          - (time.monotonic() - t_submit)))
            try:
                out = _request(conn, method, path, obj, trace=wire_ctx,
                               deadline=budget, compress=self.compress)
            except ServeError as e:
                # transparent redirect-on-failover: the drained instance
                # rejected this request (never executed) and named its
                # replacement — re-send there, keeping trace identity
                target = self._redirect_target(e)
                if target is None:
                    raise
                self._retarget(*target)
                budget = (None if deadline is None else
                          max(0.0, float(deadline)
                              - (time.monotonic() - t_submit)))
                out = _request(self._worker._connection(), method, path,
                               obj, trace=wire_ctx, deadline=budget,
                               compress=self.compress)
            if ctx is not None:
                self.tracer.record(f"client.{method} {path}", ctx, t0,
                                   self.tracer.clock())
            return out
        self._worker.submit(job, resolve)

    def _ordered(self, method: str, path: str, obj: Any,
                 on_result: Callable[[Any, ServeFuture], None] = None,
                 deadline: Optional[float] = None) -> ServeFuture:
        future = ServeFuture()

        def resolve(result, exc):
            if exc is not None:
                future._set_exception(exc)
            elif on_result is not None:
                on_result(result, future)
            else:
                future._set_result(result)

        self._ordered_raw(method, path, obj, resolve, deadline=deadline)
        return future

    # -- service surface -----------------------------------------------------

    def healthz(self) -> dict:
        return self._sync("GET", "/v1/healthz")

    def toolboxes(self) -> List[str]:
        return self._sync("GET", "/v1/toolboxes")["toolboxes"]

    def stats(self) -> MetricRecord:
        rec = self._sync("GET", "/v1/metrics")
        return MetricRecord(gen=rec["gen"], counters=rec["counters"],
                            gauges=rec["gauges"], meta=rec.get("meta", {}))

    def profile(self) -> dict:
        """``GET /v1/profile`` — the server's per-compiled-program
        device-phase profiles (``{"enabled", "programs": {key: ...}}``;
        see :class:`~deap_tpu_torch.observability.profiling.ProgramProfiler`)."""
        return self._sync("GET", "/v1/profile")

    def trace_tail(self, *, max_spans: int = 256,
                   trace_id: Optional[str] = None) -> dict:
        """``GET /v1/trace`` — the server's recent span window
        (``{"enabled", "dropped", "spans": [...]}``), optionally filtered
        to one ``trace_id`` (e.g. a span's id from this client's own
        ``tracer.recent()``)."""
        path = f"/v1/trace?max={int(max_spans)}"
        if trace_id is not None:
            path += f"&trace_id={quote(str(trace_id), safe='')}"
        return self._sync("GET", path)

    def stream_metrics(self, *, max_records: int = 10,
                       timeout: float = 30.0) -> Iterator[MetricRecord]:
        """Tail the server's metrics stream: yields a
        :class:`MetricRecord` per service activity wave (chunked ND-JSON
        under the hood)."""
        conn = _make_connection(self.host, self.port, timeout=self.timeout,
                                ssl_context=self.ssl_context)
        try:
            conn.request("GET", f"/v1/metrics?stream=1&max={int(max_records)}"
                                f"&timeout={float(timeout)}")
            resp = conn.getresponse()
            if resp.status >= 400:
                raise ServeError(f"HTTP {resp.status} on metrics stream")
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line.decode("utf-8"))
                yield MetricRecord(gen=rec["gen"], counters=rec["counters"],
                                   gauges=rec["gauges"],
                                   meta=rec.get("meta", {}))
        finally:
            conn.close()

    def open_session(self, key, population: Population, toolbox: str, *,
                     cxpb: float = 0.5, mutpb: float = 0.2,
                     name: Optional[str] = None,
                     tenant: Optional[str] = None,
                     evaluate_initial: bool = True) -> "RemoteSession":
        """Mirror of :meth:`EvolutionService.open_session`, with
        ``toolbox`` a *name* in the server's registry (functions don't
        travel).  ``tenant`` names the paying tenant for fleet-router
        admission (quotas + weighted-fair scheduling); a plain NetServer
        ignores it."""
        fit = population.fitness
        body = {"toolbox": str(toolbox),
                "key": _raw_key(key),
                "genome": _host_tree(population.genome),
                "weights": tuple(fit.weights),
                "cxpb": float(cxpb), "mutpb": float(mutpb),
                "evaluate_initial": bool(evaluate_initial)}
        if bool(_host_leaf(fit.valid).any()):
            body["values"] = _host_leaf(fit.values).to(torch.float32)
            body["valid"] = _host_leaf(fit.valid).to(torch.bool)
        if name is not None:
            body["name"] = str(name)
        if tenant is not None:
            body["tenant"] = str(tenant)
        out = self._sync("POST", "/v1/sessions", body)
        return RemoteSession(self, out["name"], gen=int(out["gen"]),
                             weights=tuple(fit.weights),
                             pop=int(out["pop"]))

    def attach(self, name: str) -> "RemoteSession":
        """Handle on a session that already lives server-side (opened by
        another client, or restored there by failover)."""
        info = self._sync("GET", f"/v1/sessions/{quote(name, safe='')}")
        return RemoteSession(self, name, gen=int(info["gen"]),
                             weights=tuple(info["weights"]),
                             pop=int(info["pop"]))

    # -- failover ------------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> Dict[str, dict]:
        """Quiesce the instance and fetch its full session snapshot (the
        object :meth:`restore` feeds to the replacement instance)."""
        return self._sync("POST", "/v1/admin/drain",
                          {"timeout": float(timeout)})["sessions"]

    def restore(self, snapshot: Dict[str, dict]) -> List[str]:
        """Adopt a drained snapshot on this instance; returns the restored
        session names (attach with :meth:`attach`)."""
        return self._sync("POST", "/v1/admin/restore",
                          {"sessions": snapshot})["restored"]

    def rebucket(self, *, max_buckets: int = 8,
                 warm: tuple = ("step",)) -> dict:
        return self._sync("POST", "/v1/admin/rebucket",
                          {"max_buckets": int(max_buckets),
                           "warm": list(warm)})

    def close(self) -> None:
        """Close the client (the server and its sessions stay up)."""
        self._closed = True
        self._worker.close()

    def __enter__(self) -> "RemoteService":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RemoteSession:
    """Wire mirror of :class:`deap_tpu_torch.serve.service.Session` — same
    future-based API, same typed failures, protocol state enforced
    server-side (an out-of-order ``tell`` fails its future with the same
    :class:`ServeError` the in-process session raises)."""

    def __init__(self, service: RemoteService, name: str, *, gen: int = 0,
                 weights: tuple = (), pop: Optional[int] = None):
        self._service = service
        self.name = name
        self.gen = int(gen)
        self.weights = tuple(weights)
        self._pop = pop           # population size never changes server-side
        self.closed = False

    def _path(self, op: str = "") -> str:
        # names are chosen by clients and may hold '/', spaces, '?', ... —
        # percent-encode so every name that create accepted stays routable
        base = f"/v1/sessions/{quote(self.name, safe='')}"
        return f"{base}/{op}" if op else base

    # -- request API (mirrors Session) ---------------------------------------

    def step(self, n: int = 1,
             deadline: Optional[float] = None) -> List[ServeFuture]:
        """Advance ``n`` generations; returns ``n`` futures resolving to
        ``{"gen", "nevals"}``.  One wire round trip for the whole call —
        the per-generation results fan back out onto the futures (a
        generation that failed server-side fails only its own future,
        exactly like in-process serving)."""
        futures = [ServeFuture() for _ in range(int(n))]

        def resolve(result, exc):
            if exc is not None:      # transport failure fails every gen
                for f in futures:
                    f._set_exception(exc)
                return
            for f, r in zip(futures, result["results"]):
                if "error" in r:
                    f._set_exception(protocol.remote_exception(
                        r["error"], r.get("message", "")))
                else:
                    self.gen = int(r["ok"]["gen"])
                    f._set_result(r["ok"])

        self._service._ordered_raw("POST", self._path("step"),
                                   {"n": int(n), "deadline": deadline},
                                   resolve, deadline=deadline)
        return futures

    def ask(self, deadline: Optional[float] = None) -> ServeFuture:
        """Resolves to the offspring genome rows awaiting external
        evaluation (CPU tensors, same bits the in-process ask returns)."""
        def keep_gen(result, future):
            self.gen = int(result["gen"])
            future._set_result(_host_tree(result["offspring"]))
        return self._service._ordered("POST", self._path("ask"),
                                      {"deadline": deadline},
                                      on_result=keep_gen, deadline=deadline)

    def tell(self, values,
             deadline: Optional[float] = None) -> ServeFuture:
        def keep_gen(result, future):
            self.gen = int(result["ok"]["gen"])
            future._set_result(result["ok"])
        return self._service._ordered(
            "POST", self._path("tell"),
            {"values": _host_leaf(values), "deadline": deadline},
            on_result=keep_gen, deadline=deadline)

    def evaluate(self, genomes,
                 deadline: Optional[float] = None) -> ServeFuture:
        def unwrap(result, future):
            future._set_result(_host_tree(result["values"]))
        return self._service._ordered(
            "POST", self._path("evaluate"),
            {"genome": _host_tree(genomes), "deadline": deadline},
            on_result=unwrap, deadline=deadline)

    # -- introspection -------------------------------------------------------

    def population(self) -> Population:
        """Current population as CPU tensors, fetched synchronously
        (mirrors the in-process accessor)."""
        info = self._service._sync("GET", self._path())
        self.gen = int(info["gen"])
        self._pop = int(info["pop"])
        return Population(
            genome=_host_tree(info["genome"]),
            fitness=Fitness(values=_host_tree(info["values"]).to(
                                torch.float32),
                            valid=_host_tree(info["valid"]).to(torch.bool),
                            weights=tuple(info["weights"])))

    @property
    def pop_size(self) -> int:
        # cached from create/attach — a session's size is immutable, and
        # the full-state GET would ship the whole population for one int
        if self._pop is None:
            self._pop = int(self._service._sync("GET", self._path())["pop"])
        return self._pop

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._service._sync("DELETE", self._path())


def _raw_key(key) -> np.ndarray:
    """The raw ``uint32`` key words (2 for threefry, 4 for rbg) of a port
    key tensor or of raw words."""
    if isinstance(key, torch.Tensor):
        return key.detach().cpu().numpy().astype(np.uint32)
    return np.asarray(key).astype(np.uint32)


def _host_leaf(x) -> torch.Tensor:
    """One leaf (tensor or host array) as a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    from ..service import _as_tensor
    return _as_tensor(x, copy=False)


def _host_tree(tree):
    """Genome tree (tensors, or decoded wire arrays) → CPU tensors,
    container structure preserved."""
    if isinstance(tree, dict):
        return {k: _host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_tree(t) for t in tree)
    return _host_leaf(tree)

