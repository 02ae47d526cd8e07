"""Tenant *enforcement* at the fleet router: quotas and weighted-fair
scheduling.

Each instance attributes its traffic per tenant (labelled counters in
``/v1/metrics``); this module turns attribution into **admission
decisions** at the layer above one instance:

* :class:`TenantQuota` — the per-tenant contract: how many live sessions
  a tenant may hold (``max_sessions``), how deep its queued-request
  backlog may grow (``max_pending``), and its ``weight`` in the fair
  scheduler.  A violated quota raises the typed
  :class:`~deap_tpu_torch.serve.dispatcher.TenantQuotaExceeded`, which travels
  the wire as HTTP 429 and rebuilds typed client-side — an over-quota
  tenant gets an actionable error, not mystery latency;
* :class:`WeightedFairScheduler` — start-time fair queueing (virtual
  time) over the router's forwarding concurrency: each admitted request
  is stamped with a virtual finish tag ``max(V, last[tenant]) +
  cost/weight`` and grants go to the smallest tag whenever an in-flight
  slot frees.  Two saturating tenants with weights 1:3 therefore see
  their throughputs converge to 1:3 regardless of arrival order, and a
  quiet tenant's first request never waits behind a burst from a noisy
  one (its tag starts at the CURRENT virtual time, not the burst's
  backlog).

Every wait is a Condition wait (never a sleep), and the shared state is
declared in ``_GUARDED_BY``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, Optional

from ... import sanitize
from ..dispatcher import ServiceClosed, TenantQuotaExceeded

__all__ = ["TenantQuota", "WeightedFairScheduler", "TenantQuotaExceeded"]


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract.  ``None`` limits are unlimited;
    ``weight`` must be positive (it divides the virtual-time cost).
    ``priority`` is the tenant's load-shedding class (higher = more
    important, default 1): the router stamps it onto every session the
    tenant opens, and under sustained queue pressure the instance
    dispatcher sheds lower-priority admissions first with typed
    :class:`~deap_tpu_torch.serve.dispatcher.ServiceBrownout` — distinct from
    ``weight``, which divides *throughput* under fairness but never
    refuses work."""

    max_sessions: Optional[int] = None
    max_pending: Optional[int] = None
    weight: float = 1.0
    priority: int = 1

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError("TenantQuota.weight must be > 0")
        if int(self.priority) != self.priority or self.priority < 0:
            raise ValueError("TenantQuota.priority must be a "
                             "non-negative integer")


class WeightedFairScheduler:
    """Weighted-fair admission over a bounded forwarding concurrency.

    ``max_inflight`` bounds how many session-mutating requests the
    router forwards concurrently (the fleet's total dispatch
    parallelism); ``quotas`` maps tenant name → :class:`TenantQuota`,
    with ``default`` covering everyone unlisted.  Unnamed tenants
    (``tenant=None``) share one anonymous row.

    The scheduler is deliberately host-only bookkeeping: ``acquire``
    blocks (Condition wait) until the request's virtual-finish tag is
    the smallest among waiters and a slot is free, ``release`` frees the
    slot.  Session-count quota checks (:meth:`session_opened`) sit on
    the create path, backlog quotas on every queued acquire.
    """

    #: lock-guarded shared state: the virtual
    #: clock, per-tenant tags/counters and the waiter heap are written
    #: by every router handler thread — writes only under ``self._cv``
    _GUARDED_BY = {"_cv": ("_virtual", "_last_tag", "_pending", "_sessions",
                           "_waiting", "_inflight", "_granted", "_closed")}

    _ANON = "<anonymous>"

    def __init__(self, *, max_inflight: int = 8,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default: TenantQuota = TenantQuota()):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = int(max_inflight)
        self.quotas = dict(quotas or {})
        self.default = default
        self._cv = sanitize.condition()
        self._virtual = 0.0                      # fair-queueing clock
        self._last_tag: Dict[str, float] = {}    # tenant -> last finish tag
        self._pending: Dict[str, int] = {}       # tenant -> queued acquires
        self._sessions: Dict[str, int] = {}      # tenant -> live sessions
        self._waiting: list = []                 # heap of (tag, seq, tenant)
        self._granted: Dict[int, float] = {}     # seq -> tag (grant latch)
        self._inflight = 0
        self._seq = itertools.count()
        self._closed = False

    def quota_of(self, tenant: Optional[str]) -> TenantQuota:
        return self.quotas.get(tenant or self._ANON, self.default)

    # -- session-count quota (create path) -----------------------------------

    def session_opened(self, tenant: Optional[str]) -> None:
        """Admit one more live session for ``tenant`` or raise the typed
        quota error.  Call :meth:`session_closed` exactly once per
        successful admission."""
        t = tenant or self._ANON
        q = self.quota_of(tenant)
        with self._cv:
            held = self._sessions.get(t, 0)
            if q.max_sessions is not None and held >= q.max_sessions:
                raise TenantQuotaExceeded(
                    f"tenant {t!r} holds {held} live sessions "
                    f"(max_sessions={q.max_sessions}); close one or raise "
                    "the quota")
            self._sessions[t] = held + 1

    def session_closed(self, tenant: Optional[str]) -> None:
        t = tenant or self._ANON
        with self._cv:
            left = self._sessions.get(t, 0) - 1
            if left > 0:
                self._sessions[t] = left
            else:
                self._sessions.pop(t, None)

    def sessions_of(self, tenant: Optional[str]) -> int:
        with self._cv:
            return self._sessions.get(tenant or self._ANON, 0)

    # -- weighted-fair request admission -------------------------------------

    def acquire(self, tenant: Optional[str],
                timeout: Optional[float] = None, cost: float = 1.0) -> None:
        """Block until this request is granted a forwarding slot under
        weighted fairness.  Raises :class:`TenantQuotaExceeded` when the
        tenant's queued backlog is at ``max_pending`` (the admission
        decision — shed at the edge, typed), ``TimeoutError`` when no
        slot frees within ``timeout``."""
        t = tenant or self._ANON
        q = self.quota_of(tenant)
        with self._cv:
            if self._closed:
                raise ServiceClosed("router scheduler is closed")
            backlog = self._pending.get(t, 0)
            if q.max_pending is not None and backlog >= q.max_pending:
                raise TenantQuotaExceeded(
                    f"tenant {t!r} has {backlog} requests queued "
                    f"(max_pending={q.max_pending}); slow down or raise "
                    "the quota")
            # start-time fair queueing: the tag advances the tenant's own
            # finish time but never starts before the global clock, so a
            # returning tenant competes from NOW, with no banked credit
            tag = max(self._virtual, self._last_tag.get(t, 0.0)) \
                + float(cost) / q.weight
            self._last_tag[t] = tag
            seq = next(self._seq)
            self._pending[t] = backlog + 1
            heapq.heappush(self._waiting, (tag, seq, t))
            self._grant_next_locked()       # a free slot grants NOW
            ok = self._cv.wait_for(
                lambda: self._closed or seq in self._granted,
                timeout=timeout)
            if self._closed or not ok:
                # back out — and re-run the grant loop: this waiter may
                # hold a latched slot that must pass to the next tag, or
                # the other waiters stall until an unrelated release
                self._drop_waiter_locked(seq, t)
                self._grant_next_locked()
                if self._closed:
                    raise ServiceClosed("router scheduler is closed")
                raise TimeoutError(
                    f"no forwarding slot within {timeout}s "
                    f"(inflight={self._inflight}/{self.max_inflight})")
            self._virtual = max(self._virtual, self._granted.pop(seq))
            self._drop_waiter_locked(seq, t, in_heap=False)
            self._inflight += 1
            self._grant_next_locked()

    def set_max_inflight(self, n: int) -> None:
        """Resize the forwarding concurrency live (an operator knob —
        e.g. tightened during an incident); waiters re-grant against the
        new bound immediately."""
        if n < 1:
            raise ValueError("max_inflight must be >= 1")
        with self._cv:
            self.max_inflight = int(n)
            self._grant_next_locked()

    def release(self, tenant: Optional[str]) -> None:
        """Free the slot :meth:`acquire` granted."""
        del tenant  # slot accounting is global; tenant kept for symmetry
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            self._grant_next_locked()
            self._cv.notify_all()

    def _drop_waiter_locked(self, seq: int, tenant: str, *,
                            in_heap: bool = True) -> None:
        """Remove a waiter's bookkeeping (granted, timed out, or
        failed).  ``in_heap=False`` is the granted fast path: the grant
        loop already heappopped the entry, so scanning the heap for it
        would rebuild O(n) waiters on EVERY successful acquire."""
        left = self._pending.get(tenant, 0) - 1
        if left > 0:
            self._pending[tenant] = left
        else:
            self._pending.pop(tenant, None)
        self._granted.pop(seq, None)
        if not in_heap:
            return
        if self._waiting and self._waiting[0][1] == seq:
            heapq.heappop(self._waiting)
        else:
            self._waiting = [w for w in self._waiting if w[1] != seq]
            heapq.heapify(self._waiting)

    def _grant_next_locked(self) -> None:
        """Latch grants for the smallest-tag waiters while slots are
        free.  Grants wake every waiter; each checks its own latch."""
        while self._waiting and \
                self._inflight + len(self._granted) < self.max_inflight:
            tag, seq, _t = heapq.heappop(self._waiting)
            self._granted[seq] = tag
        self._cv.notify_all()

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
