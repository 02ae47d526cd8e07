""":class:`Backend` — the router's handle on one
:class:`~deap_tpu_torch.serve.net.server.NetServer` instance (or a JAX
package's: the wire is the same).

Two traffic classes, deliberately separated:

* **forwarding** (:meth:`forward`) — raw DTF1 frames relayed
  byte-for-byte (payloads untouched, so compression negotiated between
  client and instance survives the hop).  Each router handler thread
  keeps its own keep-alive connection to the backend (thread-local
  pool), mirroring the stdlib frontend's one-handler-per-connection
  model; a send-phase failure retries once on a fresh connection (the
  request never hit the wire), a response-phase failure propagates — the
  instance may have executed a non-idempotent step.  The router's
  :meth:`Backend.close` closes every thread's pooled connection;
* **control** (:meth:`healthz` / :meth:`metrics` / :meth:`trace_tail` /
  :meth:`drain` / :meth:`restore` / :meth:`set_redirect` /
  :meth:`toolboxes`) — per-call connections with their own (short)
  timeout so a wedged instance can never stall the health loop or a
  failover behind a long forward.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ... import sanitize
from ..dispatcher import CircuitOpen, ServeError
from ..net import protocol
from ..net.client import _make_connection, _parse_url

__all__ = ["Backend", "BackendDown", "CircuitBreaker", "CircuitOpen"]


class BackendDown(ServeError):
    """The backend did not answer (connect/send/read failure) — the
    transport-level 'sick' signal, distinct from a typed service error
    the instance itself raised.  ``sent`` records whether the request
    reached the wire: ``False`` means the instance provably never saw it
    (a re-send cannot double-execute anything), ``True`` means it died
    mid-response and MAY have executed — the router never retries
    those."""

    def __init__(self, message: str, *, sent: bool = False):
        super().__init__(message)
        self.sent = bool(sent)


class CircuitBreaker:
    """Per-backend circuit breaker: closed → open → half-open.

    ``fail_threshold`` consecutive transport failures
    (:class:`BackendDown`) trip the breaker OPEN: further non-idempotent
    forwards are refused immediately with typed
    :class:`~deap_tpu_torch.serve.dispatcher.CircuitOpen` instead of queueing
    behind a connect timeout to a wedged instance.  After a *jittered*
    probe delay (``reset_s * (1 + probe_jitter * u)``, ``u`` uniform —
    jitter so a fleet of routers doesn't re-probe a recovering backend in
    lockstep) the breaker goes HALF-OPEN and admits exactly one trial
    request; its success closes the breaker, its failure re-opens with a
    fresh jittered delay.  Idempotent GETs are never blocked — they pass
    through and their outcomes double as organic probes, which is what
    makes a breaker-open backend merely *degraded* (still readable)
    rather than down.

    ``clock``/``rng`` are injectable so drills pin the exact open/probe
    schedule; ``on_event(kind)`` (kind in ``"opened"``/``"probe"``/
    ``"shortcircuit"``) and ``on_state(name, state)`` are the metrics /
    health hooks, called OUTSIDE the breaker lock."""

    #: lock-guarded state machine, written from every router handler
    #: thread that forwards through this backend
    _GUARDED_BY = {"_lock": ("_state", "_failures", "_opened_at",
                             "_probe_delay", "_probe_inflight")}

    def __init__(self, name: str = "", *, fail_threshold: int = 3,
                 reset_s: float = 5.0, probe_jitter: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[Callable[[], float]] = None,
                 on_event: Optional[Callable[[str], None]] = None,
                 on_state: Optional[Callable[[str, str], None]] = None):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if reset_s <= 0:
            raise ValueError("reset_s must be > 0")
        if probe_jitter < 0:
            raise ValueError("probe_jitter must be >= 0")
        self.name = str(name)
        self.fail_threshold = int(fail_threshold)
        self.reset_s = float(reset_s)
        self.probe_jitter = float(probe_jitter)
        self._clock = clock
        self._rng = rng if rng is not None else random.random
        self._on_event = on_event
        self._on_state = on_state
        self._lock = sanitize.lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probe_delay = 0.0
        self._probe_inflight = False

    def bind(self, on_event: Optional[Callable[[str], None]] = None,
             on_state: Optional[Callable[[str, str], None]] = None) -> None:
        """Fill in UNSET observer hooks (the router wires its metrics /
        health callbacks onto breakers it did not construct — e.g. one a
        test pre-attached with an injected clock) without stomping hooks
        the constructor already received."""
        if self._on_event is None and on_event is not None:
            self._on_event = on_event
        if self._on_state is None and on_state is not None:
            self._on_state = on_state

    def _emit(self, events, state_change):
        if self._on_event is not None:
            for kind in events:
                self._on_event(kind)
        if state_change is not None and self._on_state is not None:
            self._on_state(self.name, state_change)

    def state(self) -> str:
        with self._lock:
            return self._state

    def before_request(self) -> None:
        """Admission gate for a non-idempotent forward.  Passes when
        closed, claims the single half-open probe slot when the probe
        delay has elapsed, and raises :class:`CircuitOpen` otherwise."""
        events: list = []
        state_change = None
        with self._lock:
            if self._state == "closed":
                return
            now = self._clock()
            if (self._state == "open"
                    and now - self._opened_at >= self._probe_delay):
                self._state = "half_open"
                self._probe_inflight = True
                events.append("probe")
                state_change = "half_open"
            elif self._state == "half_open" and not self._probe_inflight:
                # a previous probe resolved elsewhere (organic GET) but
                # the breaker is still deciding — admit one more trial
                self._probe_inflight = True
                events.append("probe")
            else:
                wait = max(0.0, self._opened_at + self._probe_delay
                           - self._clock())
                events.append("shortcircuit")
                self._emit(events, None)
                raise CircuitOpen(
                    f"backend {self.name} circuit is {self._state} "
                    f"(next probe in {wait:.2f}s); retry later or "
                    "against another instance")
        self._emit(events, state_change)

    def record_success(self) -> None:
        state_change = None
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != "closed":
                self._state = "closed"
                state_change = "closed"
        self._emit((), state_change)

    def record_failure(self) -> None:
        events: list = []
        state_change = None
        with self._lock:
            self._failures += 1
            self._probe_inflight = False
            tripped = (self._state == "closed"
                       and self._failures >= self.fail_threshold)
            reopened = self._state == "half_open"
            if tripped or reopened:
                self._state = "open"
                self._opened_at = self._clock()
                self._probe_delay = self.reset_s * (
                    1.0 + self.probe_jitter * self._rng())
                events.append("opened")
                state_change = "open"
        self._emit(events, state_change)


class Backend:
    """One routable serving instance (see module docstring).

    ``breaker`` (optional) is this backend's :class:`CircuitBreaker`;
    when set, non-idempotent forwards pass its admission gate and every
    forward outcome feeds its state machine.  The router attaches one
    per backend (:class:`~deap_tpu_torch.serve.router.core.FleetRouter`)."""

    #: the forwarding pool: every thread's keep-alive connection, so
    #: close() can reach the connections other threads opened
    _GUARDED_BY = {"_pool_lock": ("_pool",)}

    def __init__(self, name: str, address, *, timeout: float = 600.0,
                 control_timeout: float = 10.0,
                 breaker: Optional[CircuitBreaker] = None,
                 ssl_context=None):
        self.name = str(name)
        scheme, self.host, self.port = _parse_url(address)
        #: TLS toward the instance: an ``ssl.SSLContext`` (verify mode /
        #: CA set included) applied to every forwarding and control
        #: connection; an https address with no context gets the stdlib
        #: default (system CAs)
        if ssl_context is None and scheme == "https":
            import ssl as _ssl
            ssl_context = _ssl.create_default_context()
        self.ssl_context = ssl_context
        self.timeout = float(timeout)
        self.control_timeout = float(control_timeout)
        self.breaker = breaker
        self._tls = threading.local()
        self._pool_lock = sanitize.lock()
        self._pool: set = set()

    @property
    def url(self) -> str:
        scheme = "https" if self.ssl_context is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def __repr__(self) -> str:
        return f"Backend({self.name!r}, {self.url})"

    # -- forwarding ----------------------------------------------------------

    def _fwd_conn(self, fresh: bool = False) -> http.client.HTTPConnection:
        conn = getattr(self._tls, "conn", None)
        if fresh and conn is not None:
            self.drop_connections()
            conn = None
        if conn is None:
            conn = _make_connection(self.host, self.port,
                                    timeout=self.timeout,
                                    ssl_context=self.ssl_context)
            self._tls.conn = conn
            with self._pool_lock:
                self._pool.add(conn)
        return conn

    def forward(self, method: str, path: str, body: Optional[bytes],
                content_type: str = protocol.CONTENT_TYPE,
                accept: Optional[str] = None) -> Tuple[int, bytes]:
        """Relay one raw request; returns ``(status, response bytes)``.
        ``accept`` relays the client's ``X-DTF-Accept`` compression
        advertisement (the only negotiation channel a bodyless GET has).
        Raises :class:`BackendDown` when the instance cannot be reached
        (send retried once on a fresh connection — safe, the request
        never arrived) or stops answering mid-response, and
        :class:`CircuitOpen` (request NEVER sent) when this backend's
        breaker is open — idempotent GETs bypass the gate and double as
        organic recovery probes."""
        if self.breaker is not None and method != "GET":
            self.breaker.before_request()
        try:
            return self._forward_raw(method, path, body, content_type,
                                     accept)
        except BackendDown:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise

    def _forward_raw(self, method: str, path: str, body: Optional[bytes],
                     content_type: str, accept: Optional[str]
                     ) -> Tuple[int, bytes]:
        headers = {"Content-Type": content_type}
        if accept:
            headers[protocol.ACCEPT_HEADER] = accept
        for attempt in (0, 1):
            conn = self._fwd_conn(fresh=attempt > 0)
            try:
                conn.request(method, path, body=body, headers=headers)
            except (http.client.HTTPException, OSError) as e:
                if attempt:
                    self.drop_connections()
                    raise BackendDown(
                        f"backend {self.name} unreachable at {self.url}: "
                        f"{e}", sent=False) from e
                continue            # stale keep-alive: one fresh retry
            try:
                resp = conn.getresponse()
                status, data = resp.status, resp.read()
            except (http.client.HTTPException, OSError) as e:
                # response-phase: the instance may have executed the
                # request — no silent re-send, surface the failure
                self.drop_connections()
                raise BackendDown(
                    f"backend {self.name} died mid-response on "
                    f"{method} {path}: {e}", sent=True) from e
            # ANY complete HTTP response — typed service errors included
            # — proves the transport is healthy: only BackendDown above
            # counts against the breaker
            if self.breaker is not None:
                self.breaker.record_success()
            return status, data
        raise AssertionError("unreachable")

    def drop_connections(self) -> None:
        """Drop THIS thread's pooled forwarding connection (other
        threads' pools drop lazily on their next send failure)."""
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            conn.close()
            self._tls.conn = None
            with self._pool_lock:
                self._pool.discard(conn)

    def close(self) -> None:
        """Close every thread's pooled forwarding connection (a thread
        that forwards again afterwards opens a fresh one)."""
        with self._pool_lock:
            pool, self._pool = self._pool, set()
        for conn in pool:
            conn.close()

    # -- control plane -------------------------------------------------------

    def _control(self, method: str, path: str, obj: Any = None,
                 timeout: Optional[float] = None) -> Any:
        conn = _make_connection(
            self.host, self.port,
            timeout=self.control_timeout if timeout is None else timeout,
            ssl_context=self.ssl_context)
        try:
            body = None if obj is None else protocol.encode_frame(obj)
            try:
                conn.request(method, path, body=body,
                             headers={"Content-Type":
                                      protocol.CONTENT_TYPE})
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                raise BackendDown(
                    f"backend {self.name} control call {method} {path} "
                    f"failed: {e}") from e
            if resp.status >= 400:
                try:
                    err = json.loads(data.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    raise ServeError(
                        f"backend {self.name}: HTTP {resp.status}: "
                        f"{data[:200]!r}")
                raise protocol.remote_exception(
                    err.get("error", "ServeError"), err.get("message", ""))
            if not data:
                return None
            if data[:4] == protocol.MAGIC:
                return protocol.decode_frame(data)
            return json.loads(data.decode("utf-8"))
        finally:
            conn.close()

    def healthz(self) -> dict:
        return self._control("GET", "/v1/healthz")

    def metrics(self) -> dict:
        return self._control("GET", "/v1/metrics")

    def trace_tail(self, max_spans: int = 256) -> dict:
        return self._control("GET", f"/v1/trace?max={int(max_spans)}")

    def toolboxes(self) -> List[str]:
        return list(self._control("GET", "/v1/toolboxes")["toolboxes"])

    def drain(self, timeout: float = 60.0) -> Dict[str, dict]:
        """Quiesce + snapshot (control call with the DRAIN timeout, not
        the short health one — a loaded instance needs time to flush)."""
        out = self._control("POST", "/v1/admin/drain",
                            {"timeout": float(timeout)},
                            timeout=timeout + self.control_timeout)
        return out["sessions"]

    def restore(self, snapshot: Dict[str, dict],
                timeout: float = 120.0) -> dict:
        """Adopt a snapshot; returns the full ``{"restored", "skipped"}``
        response — the router re-places skipped orphans elsewhere."""
        return self._control("POST", "/v1/admin/restore",
                             {"sessions": snapshot},
                             timeout=timeout)

    def set_redirect(self, url: Optional[str],
                     session: Optional[str] = None) -> None:
        """Record the failover redirect on the instance; with
        ``session`` it applies to that ONE session (the tombstone live
        migration leaves at the source)."""
        body: Dict[str, Any] = {"url": url}
        if session is not None:
            body["session"] = session
        self._control("POST", "/v1/admin/redirect", body)

    def migrate(self, name: str, timeout: float = 30.0) -> dict:
        """Live-migration source call: quiesce + export exactly one
        session; returns its snapshot (drain wire form, toolbox name
        included)."""
        out = self._control("POST", "/v1/admin/migrate",
                            {"name": name, "timeout": float(timeout)},
                            timeout=timeout + self.control_timeout)
        return out["session"]

    def rebucket(self, *, sizes: Optional[List[int]] = None,
                 max_buckets: int = 8,
                 warm: Tuple[str, ...] = ("step",),
                 timeout: float = 60.0) -> dict:
        """Bucket-grid refit on the instance; ``sizes`` installs an
        explicit grid (the autoscaler's predictive pre-warm — a fresh
        instance has no histogram to derive one from)."""
        body: Dict[str, Any] = {"max_buckets": int(max_buckets),
                                "warm": list(warm)}
        if sizes is not None:
            body["sizes"] = [int(r) for r in sizes]
        return self._control("POST", "/v1/admin/rebucket", body,
                             timeout=timeout)

    def profile(self) -> dict:
        """The instance's per-program device-phase profile table
        (roofline ``phase_split`` signals ride here)."""
        return self._control("GET", "/v1/profile")

    def cache_export(self, since: int, limit: int = 256) -> dict:
        """Pull the instance's fitness-cache journal after cursor
        ``since`` (portable namespaces); ``{"entries", "seq"}``."""
        return self._control("POST", "/v1/admin/cache/export",
                             {"since": int(since), "limit": int(limit)})

    def cache_import(self, entries: List[dict]) -> int:
        """Push exported entries into the instance's fabric table;
        returns rows admitted."""
        out = self._control("POST", "/v1/admin/cache/import",
                            {"entries": list(entries)})
        return int(out["admitted"])
