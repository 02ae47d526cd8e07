"""Health-driven failover: the loop that turns the manual
drain→restore drill into an automatic reflex.

Every poll period the monitor probes each live backend out-of-band
(control connections, never the forwarding path):

* ``GET /v1/healthz`` — reachability and drain state;
* ``GET /v1/metrics`` — the ``failed``/``net_errors`` counter deltas
  since the previous poll (a device path throwing on every batch is sick
  even while its HTTP frontend answers politely);
* ``GET /v1/trace`` — the instance's recent span window, joined through
  :func:`~deap_tpu_torch.observability.fleettrace.join_spans` /
  :func:`~deap_tpu_torch.observability.fleettrace.span_tree`: spans carrying
  an ``error`` attribute count against the instance, and a request span
  stuck beyond ``stall_s`` (queue-wait phases dominating the window)
  marks degradation the counters alone miss.

A wedge *in progress* leaves no spans at all (phases are recorded when a
request dispatches, never while it waits), so the probe also tracks
queue **progress**: a nonzero ``queue_depth`` gauge with a flat
``completed`` counter for longer than ``stall_s`` is a wedged dispatch
pipeline even though every control route still answers politely.

``fail_after`` consecutive bad polls latch the instance **sick** and
fire ``on_sick(backend, reason)`` exactly once — the router's failover
path.  A latched instance is probed no further until
:meth:`HealthMonitor.revive` (failover replaces it; flapping must not
re-trigger mid-drain).  The loop waits on an event (wakes on
:meth:`stop` immediately — no blocking sleep).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ... import sanitize
from ...observability.fleettrace import join_spans, span_tree
from .backend import Backend, BackendDown

__all__ = ["HealthPolicy", "HealthMonitor", "HealthSample"]


@dataclass(frozen=True)
class HealthPolicy:
    """Knobs of the health loop (see module docstring)."""

    interval_s: float = 2.0
    fail_after: int = 2
    max_failed_delta: int = 0       # failed-counter rise tolerated per poll
    max_error_spans: int = 0        # error spans tolerated per window
    stall_s: float = 30.0           # a span older than this and unfinished
    trace_window: int = 128


@dataclass
class HealthSample:
    """One probe's verdict for one backend."""

    ok: bool
    reason: str = ""
    queue_depth: float = 0.0
    failed_delta: int = 0
    error_spans: int = 0


class HealthMonitor:
    """Polls backends, latches sickness, drives the failover callback
    (see module docstring).  ``on_sick(backend, reason)`` runs on the
    monitor thread (or the :meth:`check_now` caller's)."""

    #: lock-guarded shared state: strike
    #: counts, the sick latch, the degraded map and the per-backend
    #: counter baselines are written by the monitor thread AND by
    #: check_now()/force_sick()/set_degraded() callers — writes only
    #: under ``self._lock``
    _GUARDED_BY = {"_lock": ("_strikes", "_sick", "_baseline", "_backends",
                             "_stalled_since", "_degraded")}

    def __init__(self, backends: List[Backend],
                 on_sick: Callable[[Backend, str], None], *,
                 policy: Optional[HealthPolicy] = None,
                 metrics=None, clock=None):
        self.policy = policy if policy is not None else HealthPolicy()
        self.on_sick = on_sick
        self._metrics = metrics
        self._clock = clock if clock is not None else time.monotonic
        self._lock = sanitize.lock()
        self._backends: Dict[str, Backend] = {b.name: b for b in backends}
        self._strikes: Dict[str, int] = {}
        self._sick: Dict[str, str] = {}          # name -> latched reason
        self._baseline: Dict[str, Dict[str, int]] = {}
        self._stalled_since: Dict[str, float] = {}  # name -> first flat poll
        #: gray-failure tier between healthy and the sick latch: a
        #: degraded backend (e.g. its circuit breaker is open) still
        #: serves idempotent GETs and keeps its routed sessions, but is
        #: excluded from NEW-session placement until the condition clears
        self._degraded: Dict[str, str] = {}      # name -> reason
        self._stop = sanitize.event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "HealthMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="deap-tpu-router-health", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self) -> None:
        # Event.wait is the loop's only wait: it returns early the
        # instant stop() sets the event (notify-woken, not a nap)
        while not self._stop.wait(self.policy.interval_s):
            self.check_now()

    # -- registry ------------------------------------------------------------

    def add_backend(self, backend: Backend) -> None:
        with self._lock:
            self._backends[backend.name] = backend
            self._strikes.pop(backend.name, None)
            self._sick.pop(backend.name, None)

    def remove_backend(self, name: str) -> None:
        with self._lock:
            self._backends.pop(name, None)
            self._strikes.pop(name, None)
            self._sick.pop(name, None)
            self._baseline.pop(name, None)
            self._stalled_since.pop(name, None)
            self._degraded.pop(name, None)

    def revive(self, name: str) -> None:
        """Clear a sick latch (an operator replaced/restarted the
        instance) — probing resumes next poll."""
        with self._lock:
            self._sick.pop(name, None)
            self._strikes.pop(name, None)
            self._baseline.pop(name, None)
            self._stalled_since.pop(name, None)
            self._degraded.pop(name, None)

    def sick(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._sick)

    def is_sick(self, name: str) -> bool:
        with self._lock:
            return name in self._sick

    # -- degraded tier -------------------------------------------------------

    def set_degraded(self, name: str, reason: str) -> None:
        """Classify a backend *degraded* — NOT the binary sick latch: a
        breaker-open (or otherwise gray-failing) instance keeps serving
        idempotent reads and its existing sessions, but the router stops
        placing NEW sessions on it.  Idempotent by design: the breaker
        re-notifies on every re-open."""
        with self._lock:
            if name not in self._backends:
                return
            self._degraded[name] = str(reason)
        if self._metrics is not None:
            self._metrics.set_gauge("router_backends_degraded",
                                    len(self.degraded()))

    def clear_degraded(self, name: str) -> None:
        with self._lock:
            self._degraded.pop(name, None)
        if self._metrics is not None:
            self._metrics.set_gauge("router_backends_degraded",
                                    len(self.degraded()))

    def degraded(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._degraded)

    def is_degraded(self, name: str) -> bool:
        with self._lock:
            return name in self._degraded

    def force_sick(self, name: str, reason: str = "operator") -> None:
        """Latch a backend sick without waiting for probes (operator
        action, fault drills, tests) — fires the same failover path."""
        with self._lock:
            backend = self._backends.get(name)
            if backend is None or name in self._sick:
                return
            self._sick[name] = reason
        if self._metrics is not None:
            self._metrics.inc("router_backends_sick")
        self.on_sick(backend, reason)

    # -- probing -------------------------------------------------------------

    def probe(self, backend: Backend) -> HealthSample:
        """One out-of-band look at one backend (no state change)."""
        try:
            hz = backend.healthz()
            rec = backend.metrics()
        except (BackendDown, OSError) as e:
            return HealthSample(ok=False, reason=f"unreachable: {e}")
        counters = rec.get("counters", {})
        with self._lock:
            base = self._baseline.get(backend.name, {})
            self._baseline[backend.name] = dict(counters)
        failed_delta = (int(counters.get("failed", 0))
                        - int(base.get("failed", 0))) if base else 0
        sample = HealthSample(
            ok=True,
            queue_depth=float(rec.get("gauges", {}).get("queue_depth", 0.0)),
            failed_delta=failed_delta)
        if hz.get("draining"):
            # draining is a transition the router itself drives, not a
            # sickness — never strike for it
            return sample
        if failed_delta > self.policy.max_failed_delta:
            return HealthSample(ok=False, failed_delta=failed_delta,
                                reason=f"failed counter rose by "
                                       f"{failed_delta} since last poll")
        stall = self._stall_reason(backend.name, counters, base,
                                   sample.queue_depth)
        if stall:
            return HealthSample(ok=False, queue_depth=sample.queue_depth,
                                reason=stall)
        err_spans, stalled = self._trace_signals(backend)
        if err_spans > self.policy.max_error_spans:
            return HealthSample(ok=False, error_spans=err_spans,
                                reason=f"{err_spans} error spans in the "
                                       "recent trace window")
        if stalled:
            return HealthSample(ok=False, reason=stalled)
        return sample

    def _stall_reason(self, name: str, counters: Dict[str, int],
                      base: Dict[str, int], depth: float) -> str:
        """Queue-progress stall: requests queued (``queue_depth`` > 0)
        but nothing completing for longer than ``stall_s``.  Trace spans
        cannot see this (phases are recorded at dispatch, not while
        waiting), so an in-progress wedge would otherwise probe ok."""
        completed_delta = (int(counters.get("completed", 0))
                           - int(base.get("completed", 0))) if base else 0
        now = self._clock()
        with self._lock:
            if depth <= 0 or not base or completed_delta > 0:
                self._stalled_since.pop(name, None)
                return ""
            since = self._stalled_since.setdefault(name, now)
        if now - since > self.policy.stall_s:
            return (f"queue depth {depth:.0f} with no completions for "
                    f"{now - since:.1f}s (> stall_s="
                    f"{self.policy.stall_s}) — dispatch pipeline wedged")
        return ""

    def _trace_signals(self, backend: Backend):
        """(error span count, stall reason) from the backend's joined
        span window; a backend without tracing contributes nothing."""
        try:
            tail = backend.trace_tail(self.policy.trace_window)
        except (BackendDown, OSError):
            return 0, ""            # reachability already probed above
        spans = join_spans({backend.name: tail.get("spans", [])})
        errors = sum(1 for s in spans if (s.get("attrs") or {}).get("error"))
        # walk request roots: a root whose queue_wait child dominates a
        # window older than stall_s is a wedged dispatch pipeline
        for root in span_tree(spans):
            for child in root.get("children", ()):
                if (child.get("name") == "queue_wait"
                        and child.get("duration_s", 0.0)
                        > self.policy.stall_s):
                    return errors, (
                        f"queue_wait span of {child['duration_s']:.1f}s "
                        f"(> stall_s={self.policy.stall_s}) — dispatch "
                        "pipeline wedged")
        return errors, ""

    def check_now(self) -> Dict[str, HealthSample]:
        """One full probe round, synchronously (what the background loop
        runs each interval; tests and the router's on-forward-failure
        path call it directly)."""
        with self._lock:
            live = [(n, b) for n, b in self._backends.items()
                    if n not in self._sick]
        out: Dict[str, HealthSample] = {}
        newly_sick: List[tuple] = []
        for name, backend in live:
            if self._metrics is not None:
                self._metrics.inc("router_health_probes")
            sample = self.probe(backend)
            out[name] = sample
            with self._lock:
                if name not in self._backends or name in self._sick:
                    continue        # removed/latched while probing
                if sample.ok:
                    self._strikes.pop(name, None)
                    continue
                strikes = self._strikes.get(name, 0) + 1
                self._strikes[name] = strikes
                if strikes < self.policy.fail_after:
                    continue
                self._sick[name] = sample.reason
                newly_sick.append((backend, sample.reason))
        for backend, reason in newly_sick:
            if self._metrics is not None:
                self._metrics.inc("router_backends_sick")
            self.on_sick(backend, reason)
        return out
