"""Fleet-wide request tracing: span trees across the serving stack.

Timing *one process's* phases is the profiler's job; the serving fleet
needs the orthogonal axis — ONE request
crossing ``RemoteSession → DTF1 wire → NetServer → BatchDispatcher →
device`` leaves a span in every layer, and without a shared identity
those spans cannot be joined back into the request's story.  This module
is that identity plus the recorder:

* :class:`TraceContext` — a 128-bit ``trace_id`` shared by every span of
  one request, a 64-bit ``span_id`` naming this hop, and the parent hop's
  span id.  Contexts are minted by :class:`~deap_tpu_torch.serve.net.client.
  RemoteService` at submission, ride the DTF1 frame's JSON header
  (``"__trace__"``), are adopted by the server handler, and fan out as
  children through :class:`~deap_tpu_torch.serve.dispatcher.BatchDispatcher`
  into the per-phase spans the service records (queue wait, pad/bucket,
  cache lookup, device execute, response encode);
* :class:`FleetTracer` — the per-process recorder: a **bounded ring**
  (flight recorder) of completed :class:`SpanRecord`\\ s, readable live
  through ``GET /v1/trace`` and dumped through the ordinary sink stack on
  ``drain()`` and on unexpected (HTTP 500) error envelopes, so a
  postmortem starts with the last N spans already on disk;
* a thread-local *current context* (:func:`current` / :func:`use`) — how
  the server handler hands the adopted context to ``service._submit``
  without threading a ``trace=`` argument through every Session method.

Everything here is host-side bookkeeping: the tracer never touches a
tensor, never syncs a device buffer it wasn't handed, and a
disabled tracer (``enabled=False``) reduces every entry point to one
attribute check — the slot programs and the bitwise trajectory are
identical with tracing on or off (held by ``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from .. import sanitize
from .sinks import emit_text

__all__ = ["TraceContext", "SpanRecord", "FleetTracer", "TRACE_KEY",
           "new_trace_id", "new_span_id", "current", "set_current", "use",
           "join_spans", "span_tree"]

#: key the wire protocol stores a trace context under in the DTF1 frame's
#: JSON header (beside ``"body"`` and ``"__tensors__"``)
TRACE_KEY = "__trace__"


# id generation sits on the per-request hot path (several span ids per
# request); uuid4's per-call os.urandom syscall costs ~10-15us on
# containerized hosts — measurably above the --net trace-overhead budget
# — so ids come from a process-local PRNG seeded ONCE from os.urandom.
# Trace ids need uniqueness, not unpredictability.  getrandbits on a
# shared Random is effectively atomic under the GIL, and the worst
# imaginable interleaving still yields well-distributed ids.
_ids = random.Random(int.from_bytes(os.urandom(16), "big"))


def new_trace_id() -> str:
    """Fresh 128-bit trace id (32 hex chars)."""
    return f"{_ids.getrandbits(128):032x}"


def new_span_id() -> str:
    """Fresh 64-bit span id (16 hex chars)."""
    return f"{_ids.getrandbits(64):016x}"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity of one span: which request (``trace_id``), which hop
    (``span_id``), and whose child it is (``parent_id``, ``None`` for a
    root).  Immutable — derive hops with :meth:`child`."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def child(self) -> "TraceContext":
        """A fresh context one level below this span."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def wire(self) -> Dict[str, str]:
        """The JSON-header form carried in a DTF1 frame: the receiver
        adopts ``span_id`` as its *parent*, so only the identity of the
        sending hop travels."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_wire(obj: Any) -> Optional["TraceContext"]:
        """Rebuild the sender's context from a frame header (``None`` on
        anything malformed — a bad trace header must never fail the
        request it annotates)."""
        if not isinstance(obj, dict):
            return None
        tid, sid = obj.get("trace_id"), obj.get("span_id")
        if not (isinstance(tid, str) and tid
                and isinstance(sid, str) and sid):
            return None
        return TraceContext(str(tid), str(sid))


@dataclasses.dataclass
class SpanRecord:
    """One completed span: identity, name, ``[t0, t1]`` bounds on the
    tracer's clock, and free-form ``attrs``."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    t0: float
    t1: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "t0": self.t0, "t1": self.t1,
                "duration_s": self.duration_s,
                **({"attrs": self.attrs} if self.attrs else {})}


# ---------------------------------------------------------------------------
# thread-local current context (how the HTTP handler hands the adopted
# context to service._submit without widening every Session signature)
# ---------------------------------------------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context set on this thread (``None`` outside a request)."""
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as this thread's context; returns the previous one
    so callers can restore it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Scoped :func:`set_current` (restores the previous context on
    exit)."""
    prev = set_current(ctx)
    try:
        yield ctx
    finally:
        set_current(prev)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def join_spans(by_source: Dict[str, List[dict]]) -> List[dict]:
    """Merge span-dict lists from several processes (the router's own
    ring plus each backend's ``GET /v1/trace`` window) into one flat
    list, each span annotated with ``attrs["source"]`` naming the
    process it came from.  The shared ``trace_id`` is what joins a
    request's spans across the fleet — this is the router health loop's
    raw material (and the postmortem view of a cross-instance request)."""
    merged: List[dict] = []
    for source, spans in by_source.items():
        for s in spans:
            s = dict(s)
            attrs = dict(s.get("attrs") or {})
            attrs.setdefault("source", source)
            s["attrs"] = attrs
            merged.append(s)
    merged.sort(key=lambda s: (s.get("trace_id", ""), s.get("t0", 0.0)))
    return merged


def span_tree(spans: List[dict]) -> List[dict]:
    """Nest a flat span-dict list into parent→children trees (each node
    gains a ``"children"`` list; roots are spans whose parent is absent
    from the set — including spans whose parent hop lives on ANOTHER
    process that contributed no ring, the normal case for a router
    joining backend windows).  Children sort by ``t0``.  Used by the
    router's health loop to walk one request's cross-instance story and
    by ``deap-tpu-trace``-style postmortems."""
    nodes = {s["span_id"]: dict(s, children=[]) for s in spans
             if s.get("span_id")}
    roots: List[dict] = []
    for node in nodes.values():
        parent = node.get("parent_id")
        if parent and parent in nodes and parent != node["span_id"]:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda s: s.get("t0", 0.0))
    roots.sort(key=lambda s: s.get("t0", 0.0))
    return roots


class FleetTracer:
    """Bounded, thread-safe span recorder for one process.

    Parameters
    ----------
    capacity:
        Flight-recorder depth — the ring keeps the most recent
        ``capacity`` completed spans (older spans fall off; the ring is
        a postmortem buffer, not a durable store — export durably by
        passing ``sinks``).
    enabled:
        ``False`` turns every entry point into one attribute check —
        the toggle is a plain attribute, so a live service can flip it.
    sinks:
        Default sink list for :meth:`dump`.
    clock:
        Monotonic time source for span bounds; the serving layer passes
        its own so queue timestamps and span bounds share one base.
    dump_min_interval_s:
        Rate limit on automatic :meth:`dump` calls (error-envelope dumps
        must not turn an error storm into a log storm); ``force=True``
        bypasses it.
    """

    #: lock-guarded shared state (``lock-discipline`` lint + runtime
    #: sanitizer): the span ring and dump rate-limit state are shared
    #: between every recording thread and the trace-tail reader.  The
    #: guard is a Condition so :meth:`wait_for_span` can block on span
    #: arrival instead of polling the tail (no-blocking-sleep
    #: discipline); :meth:`record` notifies under the same lock.
    _GUARDED_BY = {"_cv": ("_ring", "_dropped", "_last_dump")}

    def __init__(self, *, capacity: int = 2048, enabled: bool = True,
                 sinks=(), clock=time.monotonic,
                 dump_min_interval_s: float = 60.0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.clock = clock
        self.sinks = list(sinks)
        self.dump_min_interval_s = float(dump_min_interval_s)
        self._cv = sanitize.condition()
        self._ring: "deque[SpanRecord]" = deque(maxlen=int(capacity))
        self._dropped = 0
        self._last_dump: Optional[float] = None

    # -- minting identities --------------------------------------------------

    def context(self, parent: Optional[TraceContext] = None) -> TraceContext:
        """A fresh context: child of ``parent`` when given, else a new
        root (fresh 128-bit trace id)."""
        if parent is not None:
            return parent.child()
        return TraceContext(new_trace_id(), new_span_id(), None)

    def adopt(self, wire_obj: Any) -> Optional[TraceContext]:
        """Context for *this* hop of a trace received over the wire
        (child of the sender's span); ``None`` when disabled or the
        header is absent/malformed."""
        if not self.enabled:
            return None
        remote = TraceContext.from_wire(wire_obj)
        return None if remote is None else remote.child()

    # -- recording -----------------------------------------------------------

    def record(self, name: str, ctx: Optional[TraceContext],
               t0: float, t1: float,
               attrs: Optional[dict] = None) -> Optional[SpanRecord]:
        """Record a completed span whose identity IS ``ctx`` (explicit
        bounds — the queue-wait span is measured by the dispatcher long
        after its ``t0`` happened)."""
        if not self.enabled or ctx is None:
            return None
        rec = SpanRecord(ctx.trace_id, ctx.span_id, ctx.parent_id,
                         name, float(t0), float(t1), dict(attrs or {}))
        with self._cv:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(rec)
            self._cv.notify_all()
        return rec

    def phase(self, name: str, parent: Optional[TraceContext],
              t0: float, t1: float,
              attrs: Optional[dict] = None) -> Optional[SpanRecord]:
        """Record a phase span as a fresh *child* of ``parent`` (the
        per-request phases — queue wait, pad, device — all hang off the
        request's span this way)."""
        if not self.enabled or parent is None:
            return None
        return self.record(name, parent.child(), t0, t1, attrs)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[TraceContext] = None,
             attrs: Optional[dict] = None
             ) -> Iterator[Optional[TraceContext]]:
        """Time a host-side block as a span; yields the span's context so
        the block can parent children on it.  Parent defaults to the
        thread's :func:`current` context."""
        if not self.enabled:
            yield None
            return
        ctx = self.context(parent if parent is not None else current())
        t0 = self.clock()
        try:
            yield ctx
        finally:
            self.record(name, ctx, t0, self.clock(), attrs)

    # -- reading / dumping ---------------------------------------------------

    def recent(self, n: Optional[int] = None,
               trace_id: Optional[str] = None) -> List[dict]:
        """The most recent ``n`` span dicts (oldest first), optionally
        restricted to one trace."""
        with self._cv:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        if n is not None:
            n = max(0, int(n))
            spans = spans[len(spans) - n:]   # n=0 → none, not spans[-0:]
        return [s.to_dict() for s in spans]

    @property
    def dropped(self) -> int:
        """Spans that fell off the ring since construction."""
        with self._cv:
            return self._dropped

    def clear(self) -> None:
        with self._cv:
            self._ring.clear()

    def wait_for_span(self, prefix: str, *,
                      trace_id: Optional[str] = None,
                      timeout: Optional[float] = None) -> bool:
        """Block until the ring holds a span whose name starts with
        ``prefix`` (optionally within one trace); True when one is
        present, False on timeout.  A Condition wait on the recording
        lock, not a poll — the test tail that previously bounded-polled
        :meth:`recent` waits here instead (no-blocking-sleep
        discipline).  Note the ring is bounded: the predicate scans what
        is CURRENTLY buffered, so wait for spans the tail could still
        hold."""
        with self._cv:
            return self._cv.wait_for(
                lambda: any(
                    s.name.startswith(prefix)
                    and (trace_id is None or s.trace_id == trace_id)
                    for s in self._ring),
                timeout=timeout)

    def dump(self, reason: str, sinks=None, *,
             force: bool = False) -> List[dict]:
        """Flight-recorder dump: emit the ring's spans as ONE JSON text
        line through the sink stack (``sinks`` argument, else the
        tracer's own) and return them.  Rate-limited by
        ``dump_min_interval_s`` unless ``force`` — drains force, error
        envelopes don't, so an error storm costs one dump per window."""
        if not self.enabled:
            return []
        now = self.clock()
        with self._cv:
            if (not force and self._last_dump is not None
                    and now - self._last_dump < self.dump_min_interval_s):
                return []
            self._last_dump = now
            spans = [s.to_dict() for s in self._ring]
            dropped = self._dropped
        out = sinks if sinks is not None else self.sinks
        if out:
            emit_text(json.dumps({"flight_recorder": reason,
                                  "nspans": len(spans),
                                  "dropped": dropped,
                                  "spans": spans}), out)
        return spans
