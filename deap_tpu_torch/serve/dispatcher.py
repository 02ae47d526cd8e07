"""Request queue + microbatching worker — the service's control plane.

One daemon thread owns all device dispatch.  Clients (any thread) submit
:class:`Request` objects into a **bounded** pending deque — a full queue
rejects (:class:`ServiceOverloaded`) or blocks with a timeout, so overload
backpressures at the edge instead of growing an unbounded heap.  The worker
coalesces compatible pending requests into one fixed-shape microbatch per
dispatch:

* **group identity** — requests batch together iff they share
  ``(kind, program_key)``: same program, same bucket shapes;
* **capacity** — a batch packs requests while the sum of their ``weight``
  stays within the group's ``capacity`` (step/ask/tell weigh 1 against the
  slot count; evaluate requests weigh their row count against the row
  bucket);
* **per-session FIFO** — at most one request per session per batch, and a
  session's later request never overtakes its earlier one (stateful kinds
  would otherwise race their own state);
* **deadlines** — a request whose deadline passed before dispatch fails
  with :class:`DeadlineExceeded` and never reaches the device: deadline
  misses fail the *request*, not the service;
* **cancellation** — :meth:`ServeFuture.cancel` wins any race that
  resolves before dispatch; cancelled requests are dropped at collection.

Execution runs under :func:`deap_tpu_torch.resilience.with_retries` (transient
``OSError``/``TimeoutError``-class faults back off and retry; anything
else fails the batch's requests and the worker moves on).  Waiting uses
``threading.Condition`` timeouts only — no blocking ``time.sleep`` on any
service path.

All device work of a service runs on the one worker thread: its batches,
and the host reads and placements other threads hand it through
:meth:`BatchDispatcher.call` (a CUDA tensor is never read or launched on
from a client or HTTP thread).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import sanitize
from ..resilience.retry import with_retries, RetriesExhausted

__all__ = ["ServeFuture", "Request", "BatchDispatcher", "ServeError",
           "ServiceClosed", "ServiceOverloaded", "DeadlineExceeded",
           "RequestCancelled", "ServiceDraining", "SessionUnknown",
           "TenantQuotaExceeded", "CircuitOpen", "ServiceBrownout"]


class ServeError(RuntimeError):
    """Base class of service-layer failures."""


class ServiceClosed(ServeError):
    """The service (or the request's session) was closed."""


class ServiceDraining(ServeError):
    """The service is draining for failover: no new work is admitted.
    Clients should retry against the instance the sessions restore on."""


class SessionUnknown(ServeError):
    """No live session with that name (network frontend lookup miss)."""


class ServiceOverloaded(ServeError):
    """The bounded request queue is full — shed load or retry later."""


class TenantQuotaExceeded(ServeError):
    """The request's tenant is over an admission quota (session count or
    queued-request backlog) at the fleet router — a per-tenant admission
    decision, distinct from :class:`ServiceOverloaded` (whole-service
    backpressure).  Raised by
    :mod:`deap_tpu_torch.serve.router.tenants` and rebuilt typed on the client
    from the wire error envelope."""


class CircuitOpen(ServeError):
    """A per-backend circuit breaker is open: the backend failed enough
    consecutive forwards that the router stopped sending it work until a
    half-open probe succeeds (:class:`deap_tpu_torch.serve.router.backend.
    CircuitBreaker`).  The request was NEVER sent — retrying against the
    fleet later (or another instance) is always safe.  Travels the typed
    error envelope with status 503."""


class ServiceBrownout(ServeError):
    """The request was shed by priority under sustained queue pressure:
    the dispatcher's pending queue stayed at/above its brownout watermark
    and this admission's priority class is lower than work already
    queued.  Distinct from :class:`ServiceOverloaded` (the queue is not
    necessarily full — the service is degrading *selectively* so
    higher-priority tenants keep their deadlines).  Status 429; clients
    should back off longer than for a plain overload."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before it was dispatched."""


class RequestCancelled(ServeError):
    """The request was cancelled before it was dispatched."""


class ServeFuture:
    """Completion handle for one submitted request (thread-safe).

    ``result(timeout)`` blocks until resolution and returns the request's
    payload result or raises its failure; ``cancel()`` succeeds iff the
    request has not started executing."""

    #: resolution state shared between the dispatch worker and any
    #: number of waiting client threads (``_on_failure`` is deliberately
    #: NOT declared: sessions assign the rollback hook after
    #: construction but before the future is published via submit)
    _GUARDED_BY = {"_lock": ("_result", "_exc", "_cancelled", "_started")}

    def __init__(self):
        self._event = sanitize.event()
        self._lock = sanitize.lock()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        self._started = False
        #: optional hook run exactly once when the future resolves with a
        #: failure (cancellation included) — sessions use it to roll back
        #: protocol state (e.g. an ask() that never executed)
        self._on_failure: Optional[Callable[[], None]] = None

    # -- dispatcher side -----------------------------------------------------

    def _start(self) -> bool:
        """Claim the future for execution; False if already cancelled."""
        with self._lock:
            if self._cancelled:
                return False
            self._started = True
            return True

    def _set_result(self, value: Any) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = value
            self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exc = exc
            self._event.set()
            hook, self._on_failure = self._on_failure, None
        if hook is not None:
            hook()

    # -- client side ---------------------------------------------------------

    def cancel(self) -> bool:
        """Request cancellation.  True iff the request will never execute
        (it had not been claimed by a batch); a started request cannot be
        recalled from the device."""
        with self._lock:
            if self._started or self._event.is_set():
                return False
            self._cancelled = True
            self._exc = RequestCancelled("request cancelled")
            self._event.set()
            hook, self._on_failure = self._on_failure, None
        if hook is not None:
            hook()
        return True

    def cancelled(self) -> bool:
        with self._lock:
            return self._cancelled

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request not complete")
        # the event's set() already orders these reads after the writer,
        # but they take the lock anyway: _GUARDED_BY declares them, and
        # an exception the lockset sanitizer must special-case is worth
        # more than an uncontended acquire on an already-resolved future
        with self._lock:
            exc, result = self._exc, self._result
        if exc is not None:
            raise exc
        return result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("request not complete")
        with self._lock:
            return self._exc


_req_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One unit of queued work.  ``program_key`` is the batching identity
    (same program + bucket); ``weight``/``capacity`` implement
    slot- or row-packing; ``session`` scopes the per-session FIFO rule
    (``None`` → unconstrained); ``trace`` is this request's
    :class:`~deap_tpu_torch.observability.fleettrace.TraceContext` (``None``
    when tracing is off) — the span every phase the request crosses
    hangs its child spans off."""

    kind: str
    program_key: tuple
    payload: Dict[str, Any]
    session: Any = None
    weight: int = 1
    capacity: int = 1
    deadline: Optional[float] = None
    future: ServeFuture = dataclasses.field(default_factory=ServeFuture)
    submitted: float = 0.0
    seq: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    trace: Any = None
    #: tenant priority class (higher = more important; router tenants
    #: stamp it from their quota).  Under sustained queue pressure the
    #: dispatcher sheds admissions whose priority is lower than work
    #: already queued (:class:`ServiceBrownout`).
    priority: int = 1

    @property
    def tenant(self) -> Optional[str]:
        """Session name for per-tenant metric attribution."""
        return getattr(self.session, "name", None)


class BatchDispatcher:
    """Bounded queue + single worker thread (see module docstring).

    ``execute`` is called on the worker thread as
    ``execute(kind, program_key, requests) -> list_of_results`` (one result
    per request, same order) and is wrapped in
    :func:`~deap_tpu_torch.resilience.with_retries` with ``retries`` /
    ``backoff`` (transient classes only).  ``clock`` is the monotonic
    deadline clock, injectable for tests."""

    #: lock-guarded shared state, enforced statically by the
    #: ``lock-discipline`` lint pass: every write to these attributes
    #: must sit under ``with self._cv:`` (or in a ``*_locked`` method
    #: whose callers all hold it) — the queue, the worker's lifecycle
    #: flags, and the batch counter are shared between every client
    #: thread and the dispatch worker
    _GUARDED_BY = {"_cv": ("_pending", "_closed", "_draining", "_paused",
                           "_busy", "_batches", "_pressure_since",
                           "_inflight", "_calls", "_init_error")}

    def __init__(self, execute: Callable[[str, tuple, List[Request]], list],
                 *, max_pending: int = 256, batch_window: float = 0.0,
                 metrics=None, retries: int = 2, backoff: float = 0.05,
                 retry_on: tuple = (OSError, TimeoutError, ConnectionError),
                 clock: Callable[[], float] = time.monotonic,
                 on_retry: Optional[Callable] = None,
                 tracer=None, after_batch: Optional[Callable] = None,
                 brownout_watermark: Optional[float] = None,
                 brownout_grace_s: float = 0.0,
                 worker_init: Optional[Callable[[], None]] = None):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if brownout_watermark is not None and not (
                0.0 < float(brownout_watermark) <= 1.0):
            raise ValueError("brownout_watermark must be in (0, 1]")
        self._execute_once = execute
        self._metrics = metrics
        #: fleettrace.FleetTracer (or None): queue-wait phase spans and
        #: the per-request "serve.<kind>" spans are recorded here
        self._tracer = tracer
        #: called on the worker thread after every dispatched batch,
        #: OUTSIDE the queue lock and with the worker not busy — the
        #: service hangs its auto-rebucket policy tick here (it may
        #: pause/resume this dispatcher, which is re-entrant from this
        #: position).  Exceptions are contained: a policy bug must not
        #: kill the one thread that owns device dispatch.
        self._after_batch = after_batch

        def _note_retry(attempt, exc, delay):
            if metrics is not None:
                metrics.inc("retries")
            if on_retry is not None:
                on_retry(attempt, exc, delay)

        # the backoff sleep inside with_retries runs on the WORKER thread
        # between attempts of an already-failing batch — queued requests
        # wait behind it by design (the device path is down).
        self._execute = with_retries(
            execute, retries=retries, backoff=backoff, retry_on=retry_on,
            on_retry=_note_retry)
        self.max_pending = int(max_pending)
        self.batch_window = float(batch_window)
        #: queue depth at/above which brownout pressure accrues
        #: (``None`` disables priority shedding entirely)
        self._brownout_depth = (
            None if brownout_watermark is None
            else max(1, int(float(brownout_watermark) * max_pending)))
        self._brownout_grace_s = float(brownout_grace_s)
        self._clock = clock
        self._cv = sanitize.condition()
        self._pending: "collections.deque[Request]" = collections.deque()
        self._closed = False
        self._draining = False
        self._paused = False
        self._busy = False
        self._batches = 0
        #: ``id(session)`` of every session with a request in the batch
        #: the worker currently has in flight — the single-session
        #: quiesce predicate (live migration) waits on this, never on
        #: the global ``_busy`` flag, so one hot session can reach a
        #: dispatch boundary while its neighbors keep streaming batches
        self._inflight: set = set()
        #: clock at which queue depth first reached the brownout
        #: watermark; ``None`` while below it
        self._pressure_since: Optional[float] = None
        #: host calls other threads hand the worker (:meth:`call`): they
        #: run between batches, paused or not, and count as no request
        self._calls: "collections.deque" = collections.deque()
        #: run first on the worker thread (the service binds its CUDA
        #: device there); if it raises, the dispatcher closes and every
        #: submission and host call fails with that error
        self._worker_init = worker_init
        self._init_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="deap-tpu-serve-dispatch", daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, request: Request, *, block: bool = False,
               timeout: Optional[float] = None) -> ServeFuture:
        """Enqueue; on a full queue either raise :class:`ServiceOverloaded`
        (default) or block up to ``timeout`` for space."""
        return self.submit_many([request], block=block,
                                timeout=timeout)[0]

    def submit_many(self, requests: List[Request], *, block: bool = False,
                    timeout: Optional[float] = None) -> List[ServeFuture]:
        """Enqueue several requests **atomically**: either every request
        is queued or none is.  This is how ``Session.step(n)`` pipelines
        its n generations — a drain (or close, or full queue) racing the
        submission must never split the pipeline, queueing a prefix that
        executes while the caller is told the call failed.  The failover
        retry story depends on it: a ``ServiceDraining`` rejection
        PROVES nothing of the call ran, so re-sending the whole call to
        the restored instance cannot double-apply a generation."""
        if not requests:
            return []
        now = self._clock()
        for request in requests:
            request.submitted = now
        with self._cv:
            if self._closed:
                raise self._closed_error_locked()
            if self._draining:
                # checked under the queue lock: once set_draining()
                # returns, NOTHING can slip into the queue behind the
                # drain wait — the failover snapshot sits at a boundary
                # every client observed
                raise ServiceDraining("service is draining for failover")
            self._check_migrating_locked(requests)
            if any(r.deadline is not None and now > r.deadline
                   for r in requests):
                # deadline-budget shed: the remaining budget that rode in
                # with the request (client hop + router hop already
                # subtracted) is spent on ARRIVAL — queueing it would
                # only burn a batch slot on work nobody is waiting for.
                # The whole atomic batch fails together (none of it ran,
                # so a re-send with a fresh budget is safe).
                for r in requests:
                    self._shed_expired(r, now)
                return [r.future for r in requests]
            self._check_brownout_locked(requests, now)
            if len(requests) > self.max_pending:
                # an atomic batch bigger than the queue can EVER hold
                # would wait on a predicate no completion satisfies —
                # fail fast instead of hanging (or spin-rejecting) the
                # caller forever
                if self._metrics is not None:
                    self._metrics.inc("rejected", len(requests))
                    for r in requests:
                        self._metrics.inc_tenant(r.tenant, "rejected")
                raise ServiceOverloaded(
                    f"an atomic batch of {len(requests)} requests can "
                    f"never fit the queue (max_pending="
                    f"{self.max_pending}); split the call or raise "
                    "max_pending")
            if len(self._pending) + len(requests) > self.max_pending:
                # cancelled/expired entries still hold queue slots until
                # the worker reaches them — resolve them here instead of
                # shedding live work while the queue is full of corpses
                self._pending = collections.deque(
                    r for r in self._pending if not self._prune_locked(r))
            if len(self._pending) + len(requests) > self.max_pending:
                if not block or not self._cv.wait_for(
                        lambda: self._closed or self._draining
                        or (len(self._pending) + len(requests)
                            <= self.max_pending),
                        timeout=timeout):
                    if self._metrics is not None:
                        self._metrics.inc("rejected", len(requests))
                        for r in requests:
                            self._metrics.inc_tenant(r.tenant, "rejected")
                    raise ServiceOverloaded(
                        f"{len(self._pending)} requests pending "
                        f"(max_pending={self.max_pending})")
                if self._closed:
                    raise ServiceClosed("service is closed")
                if self._draining:
                    # a drain that landed while this submission was
                    # blocked on queue space: enqueueing now would slip
                    # work behind the drain wait, after set_draining()
                    # promised the pending queue can only shrink
                    raise ServiceDraining(
                        "service is draining for failover")
                # a migration quiesce that landed while this submission
                # was blocked: same atomicity promise, per session
                self._check_migrating_locked(requests)
            self._pending.extend(requests)
            if self._metrics is not None:
                self._metrics.inc("requests", len(requests))
                # per-request tenant rows: a batch is not required to be
                # single-session, so requests[0] must not absorb them all
                for r in requests:
                    self._metrics.inc_tenant(r.tenant, "requests")
                self._metrics.set_gauge("queue_depth", len(self._pending))
            self._cv.notify_all()
        return [r.future for r in requests]

    def _shed_expired(self, req: Request, now: float) -> None:
        """Fail a request whose deadline budget was already spent at
        submission (pre-dispatch shed).  Counts ``deadline_shed`` on top
        of the ordinary miss accounting, and records the same error span
        :meth:`_prune_locked` would — a shed must look identical to a
        queue-pruned miss to the health monitor's trace window."""
        req.future._set_exception(DeadlineExceeded(
            f"deadline budget spent {now - req.deadline:.3f}s before "
            "submission (shed pre-dispatch)"))
        if self._metrics is not None:
            self._metrics.inc("deadline_shed")
            self._metrics.inc("deadline_misses")
            self._metrics.inc_tenant(req.tenant, "deadline_misses")
        if self._tracer is not None and req.trace is not None:
            self._tracer.record(
                f"serve.{req.kind}", req.trace, req.submitted, now,
                attrs={"error": "DeadlineExceeded", "session": req.tenant})

    def _check_brownout_locked(self, requests: List[Request],
                               now: float) -> None:
        """Priority load shedding (holds ``_cv``).  While the queue sits
        at/above the brownout watermark for longer than the grace
        period, an admission whose priority class is LOWER than work
        already queued is refused with :class:`ServiceBrownout` — the
        graceful middle ground between admitting everything (every
        tenant's deadline misses) and a hard :class:`ServiceOverloaded`
        at the brim.  Equal-priority traffic is never shed here, so a
        fleet with uniform priorities behaves exactly as before."""
        if self._brownout_depth is None:
            return
        if len(self._pending) >= self._brownout_depth:
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
            return
        if now - self._pressure_since < self._brownout_grace_s:
            return
        queued_top = max((r.priority for r in self._pending), default=None)
        incoming = min(r.priority for r in requests)
        if queued_top is None or incoming >= queued_top:
            return
        if self._metrics is not None:
            self._metrics.inc("brownout_sheds", len(requests))
            for r in requests:
                self._metrics.inc_tenant(r.tenant, "rejected")
        raise ServiceBrownout(
            f"priority {incoming} admission shed: queue at "
            f"{len(self._pending)}/{self.max_pending} holds priority "
            f"{queued_top} work (sustained {now - self._pressure_since:.1f}s "
            "over the brownout watermark)")

    def set_draining(self, value: bool = True) -> None:
        """Reject (``ServiceDraining``) every submission from now on —
        atomic with respect to in-flight :meth:`submit` calls, so after
        this returns the pending queue can only shrink."""
        with self._cv:
            self._draining = bool(value)
            self._cv.notify_all()

    def _check_migrating_locked(self, requests: List[Request]) -> None:
        """Reject (``ServiceDraining``) any request for a session whose
        ``migrating`` flag is up (holds ``_cv``).  The flag flips under
        this same lock (:meth:`set_session_migrating`), so the drain
        atomicity promise holds per session: once the flip returns, that
        session's pending work can only shrink — the migration snapshot
        sits at a boundary every one of its clients observed."""
        for r in requests:
            if r.session is not None and getattr(
                    r.session, "migrating", False):
                raise ServiceDraining(
                    f"session {getattr(r.session, 'name', '?')!r} "
                    "is migrating")

    def set_session_migrating(self, session, value: bool = True) -> None:
        """Flip one session's ``migrating`` flag under the queue lock —
        atomic with respect to in-flight :meth:`submit` calls, exactly
        like :meth:`set_draining` but scoped to one session.  Neighbor
        sessions keep submitting and dispatching throughout."""
        with self._cv:
            session.migrating = bool(value)
            self._cv.notify_all()

    def wait_session_idle(self, session,
                          timeout: Optional[float] = None) -> bool:
        """Block until ``session`` has nothing queued and nothing in the
        worker's in-flight batch (or ``timeout`` elapses; True on idle).
        With the session's ``migrating`` flag already up this is the
        single-session quiesce point: after it returns True the
        session's device state is at a dispatch boundary and can be
        snapshotted without pausing the dispatcher."""
        sid = id(session)
        with self._cv:
            return self._cv.wait_for(
                lambda: sid not in self._inflight
                and not any(r.session is session for r in self._pending),
                timeout=timeout)

    def pause(self) -> None:
        """Stop dispatching new batches (in-flight one completes) —
        checkpoint quiesce uses this."""
        with self._cv:
            self._paused = True
            self._cv.wait_for(lambda: not self._busy)

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no batch is in flight."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._pending and not self._busy,
                timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker; every still-pending request fails with
        :class:`ServiceClosed`."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            while self._pending:
                self._pending.popleft().future._set_exception(
                    ServiceClosed("service closed with request pending"))
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def batches(self) -> int:
        with self._cv:
            return self._batches

    def remap_pending(self, fn: Callable[[Request], None]) -> None:
        """Apply ``fn`` to every still-queued request under the queue
        lock.  The rebucket quiesce uses this to rewrite queued requests'
        ``program_key``/``capacity`` after sessions moved buckets —
        without it, a request enqueued before the refit would dispatch
        its new-shaped state through the stale program."""
        with self._cv:
            for req in self._pending:
                fn(req)

    def wait_for_batches(self, seen: int,
                         timeout: Optional[float] = None) -> int:
        """Block until the dispatched-batch count exceeds ``seen`` (or the
        dispatcher closes, or ``timeout`` elapses) and return the current
        count.  A Condition wait, not a poll — the streaming metrics
        endpoint tails service activity through this without burning a
        busy loop."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._batches > seen or self._closed,
                timeout=timeout)
            return self._batches

    def call(self, fn: Callable[[], Any],
             timeout: Optional[float] = None) -> Any:
        """Run ``fn()`` on the worker thread and return its result (or
        raise its exception).  Runs between batches, also while the
        dispatcher is paused, and counts as no request; called from the
        worker itself it runs in place.  This is how client and HTTP
        threads read or place device state without touching the device
        themselves."""
        if threading.current_thread() is self._thread:
            return fn()
        fut = ServeFuture()
        with self._cv:
            if self._closed:
                raise self._closed_error_locked()
            self._calls.append((fn, fut))
            self._cv.notify_all()
        return fut.result(timeout=timeout)

    def _run_calls(self) -> None:
        """Run the queued host calls (worker thread, lock not held)."""
        while True:
            with self._cv:
                if not self._calls:
                    return
                fn, fut = self._calls.popleft()
            try:
                fut._set_result(fn())
            except BaseException as e:  # noqa: BLE001 — handed back
                fut._set_exception(e)

    # -- worker side ---------------------------------------------------------

    def _prune_locked(self, req: Request) -> bool:
        """Resolve a request that must not run; True if it was pruned."""
        if req.future.cancelled():
            if self._metrics is not None:
                self._metrics.inc("cancelled")
            return True
        if req.session is not None and getattr(req.session, "closed", False):
            req.future._set_exception(ServiceClosed(
                f"session {getattr(req.session, 'name', '?')} is closed"))
            return True
        if req.deadline is not None and self._clock() > req.deadline:
            req.future._set_exception(DeadlineExceeded(
                f"deadline passed {self._clock() - req.deadline:.3f}s "
                "before dispatch"))
            if self._metrics is not None:
                self._metrics.inc("deadline_misses")
                self._metrics.inc_tenant(req.tenant, "deadline_misses")
            if self._tracer is not None and req.trace is not None:
                self._tracer.record(
                    f"serve.{req.kind}", req.trace, req.submitted,
                    self._clock(), attrs={"error": "DeadlineExceeded",
                                          "session": req.tenant})
            return True
        return False

    def _collect_locked(self) -> List[Request]:
        """Pop the next microbatch (FIFO anchor + compatible followers)."""
        batch: List[Request] = []
        anchor_key = None
        weight = 0
        capacity = 0
        sessions_seen = set()
        keep: "collections.deque[Request]" = collections.deque()
        while self._pending:
            req = self._pending.popleft()
            if self._prune_locked(req):
                continue
            sess = id(req.session) if req.session is not None else None
            if anchor_key is None:
                anchor_key = (req.kind, req.program_key)
                capacity = req.capacity
            if ((req.kind, req.program_key) == anchor_key
                    and weight + req.weight <= capacity
                    and (sess is None or sess not in sessions_seen)):
                batch.append(req)
                weight += req.weight
            else:
                keep.append(req)
            if sess is not None:
                # a skipped session's LATER requests must also wait,
                # preserving per-session order
                sessions_seen.add(sess)
        self._pending = keep
        if self._metrics is not None:
            self._metrics.set_gauge("queue_depth", len(self._pending))
        return batch

    def _closed_error_locked(self) -> ServeError:
        if self._init_error is not None:
            return ServiceClosed(
                "the dispatch worker failed to start: "
                f"{type(self._init_error).__name__}: {self._init_error}")
        return ServiceClosed("service is closed")

    def _run(self) -> None:
        if self._worker_init is not None:
            try:
                self._worker_init()
            except BaseException as e:  # noqa: BLE001 — reported, loud
                with self._cv:
                    self._init_error = e
                    self._closed = True
                    err = self._closed_error_locked()
                    while self._pending:
                        self._pending.popleft().future._set_exception(err)
                    self._fail_calls_locked()
                    self._cv.notify_all()
                return
        while True:
            self._run_calls()
            with self._cv:
                self._cv.wait_for(
                    lambda: self._closed or self._calls
                    or (self._pending and not self._paused))
                if self._closed:
                    self._fail_calls_locked()
                    return
                if self._calls:
                    continue
                batch = self._collect_locked()
                if (batch and self.batch_window > 0
                        and sum(r.weight for r in batch) < batch[0].capacity):
                    # linger once for stragglers, then take what arrived.
                    # wait() released the lock, so pause()/close() may have
                    # happened meanwhile — re-check before dispatching: a
                    # quiesced service must not swap session states under a
                    # checkpoint, and a closed one must fail, not run
                    self._cv.wait(self.batch_window)
                    self._pending.extendleft(reversed(batch))
                    if self._closed:
                        while self._pending:
                            self._pending.popleft().future._set_exception(
                                ServiceClosed(
                                    "service closed with request pending"))
                        self._fail_calls_locked()
                        return
                    if self._paused:
                        continue
                    batch = self._collect_locked()
                if not batch:
                    continue
                self._busy = True
                self._inflight = {id(r.session) for r in batch
                                  if r.session is not None}
            try:
                self._dispatch(batch)
            finally:
                with self._cv:
                    self._busy = False
                    self._inflight = set()
                    self._batches += 1
                    self._cv.notify_all()
            if self._after_batch is not None:
                try:
                    self._after_batch()
                except Exception:  # noqa: BLE001 — the hook reports its
                    pass           # own failures; the worker must survive

    def _fail_calls_locked(self) -> None:
        while self._calls:
            self._calls.popleft()[1]._set_exception(
                self._closed_error_locked() if self._init_error is not None
                else ServiceClosed("service closed with a host call pending"))

    def _dispatch(self, batch: List[Request]) -> None:
        live = [r for r in batch if r.future._start()]
        if not live:
            return
        kind, program_key = live[0].kind, live[0].program_key
        tracer = self._tracer
        start = self._clock()
        if tracer is not None:
            # queue-wait phase: submission to the moment this batch
            # claimed the worker (explicit bounds — t0 happened long
            # before the tracer saw the request)
            for r in live:
                if r.trace is not None:
                    tracer.phase("queue_wait", r.trace, r.submitted, start,
                                 attrs={"session": r.tenant})
        try:
            results = self._execute(kind, program_key, live)
        except (Exception, RetriesExhausted) as e:  # noqa: BLE001
            now = self._clock()
            for r in live:
                r.future._set_exception(e)
                if self._metrics is not None:
                    self._metrics.inc_tenant(r.tenant, "failed")
                if tracer is not None and r.trace is not None:
                    tracer.record(f"serve.{kind}", r.trace, r.submitted, now,
                                  attrs={"error": type(e).__name__,
                                         "session": r.tenant})
            if self._metrics is not None:
                self._metrics.inc("failed", len(live))
            return
        now = self._clock()
        for r, res in zip(live, results):
            r.future._set_result(res)
            if self._metrics is not None:
                self._metrics.observe_latency(kind, now - r.submitted)
                self._metrics.inc_tenant(r.tenant, "completed")
            if tracer is not None and r.trace is not None:
                tracer.record(f"serve.{kind}", r.trace, r.submitted, now,
                              attrs={"session": r.tenant})
        if self._metrics is not None:
            self._metrics.inc("completed", len(live))
            self._metrics.inc("batches")
