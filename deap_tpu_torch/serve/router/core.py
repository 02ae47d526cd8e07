""":class:`FleetRouter` — the control plane above N serving instances.

The router owns four tables (all under one lock): the **routing table**
(session name → backend), the **tenant table** (session → paying
tenant), per-backend :class:`~deap_tpu_torch.serve.router.placement.BackendPlan`
placement state, and the down-set.  Around them it composes the three
fleet behaviors of this package:

* **placement** — create requests pass tenant admission
  (:class:`~deap_tpu_torch.serve.router.tenants.WeightedFairScheduler`) and
  bucket-affinity scoring
  (:class:`~deap_tpu_torch.serve.router.placement.PlacementPolicy`) before the
  router forwards them to the chosen instance;
* **health-driven failover** (:meth:`failover`) — when the
  :class:`~deap_tpu_torch.serve.router.health.HealthMonitor` latches an
  instance sick, the router drives drain→restore automatically:
  drain the sick instance, partition its snapshot across healthy
  instances by toolbox + bucket affinity, restore each part, and
  re-route.  A target that dies **mid-restore** is latched sick itself
  and its part re-placed on a third instance; sessions `h_restore`
  skipped (toolbox not in the target's registry) are likewise re-placed
  instead of dropped.  The drained instance — if still answering — gets
  a redirect (``POST /v1/admin/redirect``) so clients pointed directly
  at it follow the move;
* **tenancy** — every session-mutating forward passes the weighted-fair
  scheduler; over-quota tenants receive the typed
  :class:`~deap_tpu_torch.serve.dispatcher.TenantQuotaExceeded` on the wire.

All state here is host bookkeeping: the router holds no tensor on any
device and never decodes tensor payloads except on the create path (it
needs the genome's shape class to place by affinity).  The instances may
be the port's or the JAX package's ``NetServer``s, in any mix: the wire
is the same, and snapshot keys travel as raw ``uint32`` words.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ... import sanitize
from ...observability.fleettrace import FleetTracer
from ...observability.sinks import emit_text
from ..buckets import _tree_leaves, genome_signature
from ..dispatcher import ServeError, SessionUnknown
from ..metrics import (ServeMetrics, ROUTER_COUNTERS, ROUTER_GAUGES,
                       AUTOSCALE_COUNTERS, AUTOSCALE_GAUGES)
from .backend import Backend, BackendDown, CircuitBreaker
from .health import HealthMonitor, HealthPolicy
from .placement import BackendPlan, PlacementPolicy, fleet_sizes
from .tenants import TenantQuota, WeightedFairScheduler

__all__ = ["FleetRouter"]


class FleetRouter:
    """Session placement, failover and tenant enforcement over a fleet
    of :class:`~deap_tpu_torch.serve.net.server.NetServer` instances (see
    module docstring).

    Parameters
    ----------
    backends:
        :class:`~deap_tpu_torch.serve.router.backend.Backend` handles (or
        ``(name, address)`` pairs) for the instances to front.
    placement:
        :class:`PlacementPolicy`; its ``bucket_policy`` must mirror the
        instances' own, or affinity keys on the wrong grid.
    quotas / default_quota / max_inflight:
        Tenant enforcement — see :class:`WeightedFairScheduler`.
    health:
        :class:`HealthPolicy` for the monitor (``start_health=False``
        leaves the loop unstarted; probes then run only via
        ``check_health()``, which tests and single-threaded callers
        call explicitly).
    drain_timeout:
        Seconds a sick instance gets to flush its queue before the
        failover declares its sessions lost.
    breaker_policy:
        Keyword arguments for the :class:`CircuitBreaker` the router
        attaches to every backend that arrives without one
        (``fail_threshold`` / ``reset_s`` / ``probe_jitter``).  A
        backend constructed with its own breaker keeps it; the router
        only binds its metrics/health observer hooks onto it.  An open
        breaker classifies the backend *degraded*: idempotent GETs
        still route to it (they double as organic recovery probes) and
        its existing sessions stay put, but new sessions place
        elsewhere while any non-degraded candidate exists.
    """

    #: lock-guarded shared state: routing,
    #: tenant and placement tables plus the down-set and the name
    #: counter are written by every handler thread and the health
    #: monitor's failover path — writes only under ``self._lock``
    _GUARDED_BY = {"_lock": ("_routes", "_tenant_of", "_plans", "_down",
                             "_toolboxes_of", "_reserved", "_names")}

    def __init__(self, backends: Sequence, *,
                 placement: Optional[PlacementPolicy] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: TenantQuota = TenantQuota(),
                 max_inflight: int = 16,
                 health: Optional[HealthPolicy] = None,
                 start_health: bool = True,
                 drain_timeout: float = 60.0,
                 breaker_policy: Optional[Dict[str, Any]] = None,
                 tracer: Optional[FleetTracer] = None,
                 sinks: Sequence = (), verbose: bool = False,
                 clock=None):
        self._clock = clock if clock is not None else time.monotonic
        self.backends: Dict[str, Backend] = {}
        for b in backends:
            backend = b if isinstance(b, Backend) else Backend(*b)
            if backend.name in self.backends:
                raise ValueError(f"duplicate backend name {backend.name!r}")
            self.backends[backend.name] = backend
        if not self.backends:
            raise ValueError("a fleet needs at least one backend")
        self.placement = (placement if placement is not None
                          else PlacementPolicy())
        self.scheduler = WeightedFairScheduler(
            max_inflight=max_inflight, quotas=quotas, default=default_quota)
        self.drain_timeout = float(drain_timeout)
        self.metrics = ServeMetrics(
            extra_counters=ROUTER_COUNTERS + AUTOSCALE_COUNTERS,
            extra_gauges=ROUTER_GAUGES + AUTOSCALE_GAUGES)
        self.tracer = (tracer if tracer is not None
                       else FleetTracer(clock=self._clock))
        self.sinks = list(sinks)
        self.verbose = bool(verbose)
        self._lock = sanitize.lock()
        # route-change signal: forwarders retrying a provably-unexecuted
        # request wait here for the failover to move their session (a
        # Condition with its own lock — never held while taking _lock's
        # critical sections, only around notify/wait)
        self._route_cv = sanitize.condition()
        self._routes: Dict[str, str] = {}        # session -> backend name
        self._tenant_of: Dict[str, Optional[str]] = {}
        self._plans: Dict[str, BackendPlan] = {
            n: BackendPlan() for n in self.backends}
        self._toolboxes_of: Dict[str, frozenset] = {}
        self._down: Dict[str, str] = {}          # backend name -> reason
        self._reserved: set = set()              # names mid-create
        self._names = 0
        self.health = HealthMonitor(
            list(self.backends.values()), self._on_sick,
            policy=health, metrics=self.metrics, clock=self._clock)
        # one circuit breaker per backend: transport failures trip it,
        # its state drives the health monitor's degraded tier and the
        # router_breaker_* counters (hooks bound, never stomped — tests
        # pre-attach breakers with injected clocks)
        for b in self.backends.values():
            if b.breaker is None:
                b.breaker = CircuitBreaker(b.name, clock=self._clock,
                                           **dict(breaker_policy or {}))
            b.breaker.bind(on_event=self._on_breaker_event,
                           on_state=self._on_breaker_state)
        # elastic control loop (attach_autoscaler) — None on static fleets
        self.autoscaler = None
        if start_health:
            self.health.start()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self.health.stop()
        self.scheduler.close()
        for b in self.backends.values():
            b.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection -------------------------------------------------------

    def healthy(self) -> List[Backend]:
        with self._lock:
            return [b for n, b in self.backends.items()
                    if n not in self._down]

    def route_of(self, name: str) -> Backend:
        with self._lock:
            bn = self._routes.get(name)
        if bn is None:
            raise SessionUnknown(f"no session named {name!r} routed in "
                                 "this fleet")
        return self.backends[bn]

    def tenant_of(self, name: str) -> Optional[str]:
        with self._lock:
            return self._tenant_of.get(name)

    def _notify_routes(self) -> None:
        with self._route_cv:
            self._route_cv.notify_all()

    def wait_rerouted(self, name: str, old_backend: str,
                      timeout: Optional[float] = None) -> bool:
        """Block until session ``name`` is routed somewhere other than
        ``old_backend`` (failover moved it) or dropped entirely (lost);
        False on timeout.  Condition-based — wakes the moment a
        failover commits its re-routing."""
        def moved() -> bool:
            with self._lock:
                bn = self._routes.get(name)
            return bn != old_backend
        with self._route_cv:
            return self._route_cv.wait_for(moved, timeout=timeout)

    def topology(self) -> dict:
        """The admin view: backends, health, per-backend session counts,
        the fleet-wide learned bucket grid."""
        with self._lock:
            plans = dict(self._plans)
            down = dict(self._down)
            routes = dict(self._routes)
        sizes = fleet_sizes(plans.values())
        degraded = self.health.degraded()
        per_backend: Dict[str, dict] = {}
        for name, backend in self.backends.items():
            plan = plans.get(name)
            per_backend[name] = {
                "url": backend.url,
                "sessions": sum(1 for bn in routes.values() if bn == name),
                "placed_total": plan.sessions if plan else 0,
                "warm_classes": len(plan.warm) if plan else 0,
                "down": down.get(name),
                "degraded": degraded.get(name),
                "breaker": (backend.breaker.state()
                            if backend.breaker is not None else None),
            }
        self.metrics.set_gauge("router_backends_alive",
                               len(self.backends) - len(down))
        self.metrics.set_gauge("router_sessions_routed", len(routes))
        autoscale = (self.autoscaler.describe()
                     if self.autoscaler is not None else None)
        return {"backends": per_backend, "sessions": len(routes),
                "fleet_sizes": list(sizes) if sizes else None,
                "sick": down, "autoscale": autoscale}

    def stats(self):
        """Router-level :class:`MetricRecord` (the RouterServer's
        ``/v1/metrics`` body)."""
        with self._lock:
            alive = len(self.backends) - len(self._down)
            routed = len(self._routes)
        self.metrics.set_gauge("router_backends_alive", alive)
        self.metrics.set_gauge("router_sessions_routed", routed)
        self.metrics.set_gauge("router_inflight", self.scheduler.inflight)
        self.metrics.set_gauge("router_backends_degraded",
                               len(self.health.degraded()))
        return self.metrics.snapshot()

    def check_health(self):
        """One synchronous probe round (the started monitor does this on
        its own interval)."""
        return self.health.check_now()

    def derive_fleet_sizes(self, **kw) -> Optional[Tuple[int, ...]]:
        with self._lock:
            plans = list(self._plans.values())
        return fleet_sizes(plans, **kw)

    def live_fleet_rows(self) -> Tuple[int, ...]:
        """Union of the bucket-row classes the fleet is actually running
        (every plan's warm set).  This — not :meth:`derive_fleet_sizes`,
        which proposes an *ideal* grid for a coordinated whole-fleet
        rebucket — is the grid a scale-out target must be pre-warmed
        with: restore re-buckets under the TARGET's policy, so only the
        rows already in service keep migration/failover bitwise and
        compile-free."""
        with self._lock:
            rows = {r for plan in self._plans.values()
                    for (r, _sig) in plan.warm}
        return tuple(sorted(rows))

    # -- elastic fleet (autoscale) --------------------------------------------

    def attach_autoscaler(self, autoscaler) -> None:
        """Register the autoscaler driving this fleet so :meth:`topology`
        can report its state (duck-typed: anything with ``describe()``;
        the port's autoscaler is queue 1 item 11b (ii) of ROADMAP.md)."""
        self.autoscaler = autoscaler

    def add_backend(self, backend: Backend) -> None:
        """Adopt a freshly-spawned instance into the fleet: register it,
        give it an empty placement plan, put it under health probing and
        attach/bind a circuit breaker.  The scale-out path — new
        sessions may place on it the moment this returns."""
        if backend.breaker is None:
            backend.breaker = CircuitBreaker(backend.name, clock=self._clock)
        backend.breaker.bind(on_event=self._on_breaker_event,
                             on_state=self._on_breaker_state)
        with self._lock:
            if backend.name in self.backends:
                raise ValueError(
                    f"duplicate backend name {backend.name!r}")
            self.backends[backend.name] = backend
            self._plans[backend.name] = BackendPlan()
            self._down.pop(backend.name, None)
        self.health.add_backend(backend)
        emit_text(f"[router] backend {backend.name} joined the fleet "
                  f"({backend.url})", self.sinks)
        self._notify_routes()

    def remove_backend(self, name: str) -> Backend:
        """Forget a drained instance (the scale-in path).  The caller
        must have moved its sessions first (:meth:`failover` does);
        removing a backend that still routes sessions raises."""
        with self._lock:
            backend = self.backends.get(name)
            if backend is None:
                raise ValueError(f"no backend named {name!r}")
            if len(self.backends) == 1:
                raise ValueError("refusing to remove the last backend")
            still = sorted(s for s, bn in self._routes.items()
                           if bn == name)
            if still:
                raise ValueError(
                    f"backend {name!r} still routes sessions {still}; "
                    "drain it first")
            del self.backends[name]
            self._plans.pop(name, None)
            self._down.pop(name, None)
            self._toolboxes_of.pop(name, None)
        self.health.remove_backend(name)
        backend.close()
        emit_text(f"[router] backend {name} left the fleet", self.sinks)
        self._notify_routes()
        return backend

    def revive(self, name: str) -> None:
        """Operator action: clear a failed-over backend's down-mark
        after the instance was restarted or replaced.  It rejoins
        placement (and the autoscaler's healthy count) immediately;
        health probing resumes with a clean slate.  ``failover`` only
        ever retires — without this the fleet can never regrow onto a
        recovered instance short of remove+re-add."""
        with self._lock:
            if name not in self.backends:
                raise ValueError(f"no backend named {name!r}")
            self._down.pop(name, None)
        self.health.revive(name)
        emit_text(f"[router] backend {name} revived", self.sinks)
        self._notify_routes()

    def pick_migration_target(self, snap: dict, *,
                              exclude: Sequence[str] = ()
                              ) -> Optional[Backend]:
        """Bucket-affinity placement for one exported session snapshot
        (the live-migration target choice — same scoring as the
        failover restore path)."""
        return self._pick_restore_target(snap, set(exclude))

    def reroute_session(self, name: str, target: Backend, n: int,
                        sig: tuple) -> None:
        """Atomically rewrite one session's route onto ``target`` (the
        live-migration commit): the placement plans move with it and
        every forwarder blocked in :meth:`wait_rerouted` wakes.  Between
        the source's export and this commit the session is routed at the
        source but rejects work with the migration redirect — the
        forwarder retry path bridges that window."""
        rows = self.placement.bucket_rows(n)
        with self._lock:
            old = self._routes.get(name)
            if old is None:
                raise SessionUnknown(
                    f"no session named {name!r} routed in this fleet")
            self._routes[name] = target.name
            if old in self._plans:
                self._plans[old].forget_session()
            self._plans[target.name].observe_placement(n, rows, sig)
        self._notify_routes()

    # -- toolbox registry model ----------------------------------------------

    def _toolboxes(self, backend: Backend,
                   refresh: bool = False) -> frozenset:
        with self._lock:
            known = self._toolboxes_of.get(backend.name)
        if known is not None and not refresh:
            return known
        try:
            names = frozenset(backend.toolboxes())
        except (BackendDown, OSError):
            return known if known is not None else frozenset()
        with self._lock:
            self._toolboxes_of[backend.name] = names
        return names

    def toolbox_union(self) -> List[str]:
        out: set = set()
        for b in self.healthy():
            out |= self._toolboxes(b)
        return sorted(out)

    # -- placement (create path) ---------------------------------------------

    def admit_session(self, body: dict) -> Tuple[Backend, Optional[str],
                                                 str, int, tuple]:
        """Admission for one create request: tenant session quota,
        global name reservation, affinity placement.  Returns
        ``(backend, tenant, name, n, sig)`` — the caller forwards the
        create and then calls :meth:`commit_session` (with the returned
        ``n``/``sig``) or :meth:`abort_session`."""
        tenant = body.get("tenant")
        tb_name = body.get("toolbox")
        genome = body.get("genome")
        if genome is None:
            raise ValueError("create body carries no genome")
        # the tenant's quota — not the client — decides the session's
        # load-shedding class: stamp it into the create body the router
        # forwards, so the instance dispatcher sheds by contract
        body["priority"] = self.scheduler.quota_of(tenant).priority
        sig = genome_signature(genome)
        n = int(_tree_leaves(genome)[0].shape[0])
        name = body.get("name")
        with self._lock:
            if name is None:
                name = f"fleet-{self._names}"
            self._names += 1
            if name in self._routes or name in self._reserved:
                raise ValueError(f"session name {name!r} already open "
                                 "in this fleet")
            self._reserved.add(name)
        try:
            # session-count quota BEFORE any placement work
            self.scheduler.session_opened(tenant)
            try:
                backend, warm = self._choose_backend(tb_name, n, sig)
            except BaseException:
                self.scheduler.session_closed(tenant)
                raise
        except BaseException:
            with self._lock:
                self._reserved.discard(name)
            raise
        self.metrics.inc("router_sessions_placed")
        if warm:
            self.metrics.inc("router_placements_warm")
        return backend, tenant, name, n, sig

    def _choose_backend(self, tb_name: Optional[str], n: int,
                        sig: tuple) -> Tuple[Backend, bool]:
        candidates = []
        for backend in self.healthy():
            if tb_name is not None and \
                    tb_name not in self._toolboxes(backend):
                continue
            with self._lock:
                plan = self._plans[backend.name]
            candidates.append((backend, plan))
        if not candidates:
            raise SessionUnknown(
                f"no healthy backend holds toolbox {tb_name!r}")
        # degraded backends (breaker open / half-open) are excluded from
        # NEW-session placement while any clean candidate exists; when
        # the whole eligible set is degraded, place anyway — a gray
        # failure must soften placement, never refuse service outright
        clean = [(b, p) for b, p in candidates
                 if not self.health.is_degraded(b.name)]
        return self.placement.choose(clean or candidates, n, sig)

    def commit_session(self, name: str, backend: Backend, n: int,
                       sig: tuple, tenant: Optional[str]) -> None:
        """Record a session the backend acknowledged.  A failover can
        beat this commit (the health loop declares ``backend`` down
        between the create forward succeeding and the handler thread
        reaching here) — never stomp its re-route, and never pin a new
        session to a downed backend."""
        rows = self.placement.bucket_rows(n)
        with self._lock:
            self._reserved.discard(name)
            rerouted = self._routes.get(name)
            down = backend.name in self._down
            if rerouted is None and not down:
                self._routes[name] = backend.name
                self._tenant_of[name] = tenant
                self._plans[backend.name].observe_placement(n, rows, sig)
                return
            if rerouted is not None:
                # the drain snapshot included this just-created session
                # and the failover restored it elsewhere: keep ITS route
                # (the restore path already observed the placement on
                # the new home) — only the tenancy record is ours to add
                self._tenant_of[name] = tenant
                return
        # backend went down pre-commit and no restore re-routed the
        # session: it died with the instance — account it lost and free
        # the tenant's quota slot (same contract as an undrainable loss)
        self.metrics.inc("router_sessions_lost")
        self.scheduler.session_closed(tenant)

    def abort_session(self, name: str, tenant: Optional[str]) -> None:
        """Create forwarding failed after admission — release the quota
        slot and the name reservation."""
        self.scheduler.session_closed(tenant)
        with self._lock:
            self._reserved.discard(name)

    def forget_session(self, name: str) -> None:
        with self._lock:
            bn = self._routes.pop(name, None)
            tenant = self._tenant_of.pop(name, None)
            if bn is not None:
                self._plans[bn].forget_session()
        if bn is not None:
            self.metrics.inc("router_sessions_closed")
            self.scheduler.session_closed(tenant)
            self._notify_routes()

    # -- circuit breakers ----------------------------------------------------

    def _on_breaker_event(self, kind: str) -> None:
        """Breaker observer hook (fired outside the breaker lock) —
        explicit literal counter names, per the metric-discipline
        lint."""
        if kind == "opened":
            self.metrics.inc("router_breaker_opens")
        elif kind == "probe":
            self.metrics.inc("router_breaker_probes")
        elif kind == "shortcircuit":
            self.metrics.inc("router_breaker_rejections")

    def _on_breaker_state(self, name: str, state: str) -> None:
        """Breaker state transitions drive the health monitor's
        degraded tier: an open (or probing half-open) breaker means the
        backend still serves idempotent reads but must not take NEW
        sessions until a probe closes the circuit."""
        if state == "open":
            self.health.set_degraded(name, "circuit open")
        elif state == "half_open":
            self.health.set_degraded(name, "circuit half-open (probing)")
        elif state == "closed":
            self.health.clear_degraded(name)

    # -- health-driven failover ----------------------------------------------

    def _on_sick(self, backend: Backend, reason: str) -> None:
        """HealthMonitor callback — contain failures: the monitor thread
        must survive a failover that throws."""
        try:
            self.failover(backend, reason=reason)
        except Exception as e:  # noqa: BLE001 — reported, never fatal
            self.metrics.inc("router_errors")
            emit_text(f"[router] failover of {backend.name} failed: {e!r}",
                      self.sinks)

    def failover(self, backend: Backend, *,
                 reason: str = "operator") -> dict:
        """Drain ``backend`` and re-place every one of its sessions on
        healthy instances (see module docstring).  Idempotent per
        backend: a second call on an already-down instance is a no-op
        summary."""
        t0 = self._clock()
        with self._lock:
            if backend.name in self._down:
                return {"backend": backend.name, "already_down": True}
            self._down[backend.name] = reason
        self.metrics.inc("router_failovers")
        emit_text(f"[router] failover of {backend.name} ({reason})",
                  self.sinks)
        try:
            snaps = backend.drain(self.drain_timeout)
        except (BackendDown, ServeError, OSError) as e:
            # the instance is gone (or cannot flush): its sessions have
            # no snapshot to move — account them lost and re-route
            # nothing.  This is the one failover shape that loses state;
            # everything drainable below moves bitwise.
            lost = self._forget_backend_sessions(backend.name)
            self.metrics.inc("router_sessions_lost", len(lost))
            emit_text(f"[router] {backend.name} undrainable ({e}); "
                      f"{len(lost)} sessions lost: {sorted(lost)}",
                      self.sinks)
            self._notify_routes()
            return {"backend": backend.name, "reason": reason,
                    "restored": {}, "lost": sorted(lost),
                    "seconds": self._clock() - t0}
        placed, lost = self._replace_sessions(snaps, exclude={backend.name})
        self.metrics.inc("router_failover_sessions", len(placed))
        if lost:
            self.metrics.inc("router_sessions_lost", len(lost))
        # re-route moved sessions; drop lost ones (their tenants' quota
        # slots free up — a lost session must not count against anyone)
        lost_tenants: List[Optional[str]] = []
        with self._lock:
            for sess, target in placed.items():
                self._routes[sess] = target.name
            for sess in lost:
                self._routes.pop(sess, None)
                lost_tenants.append(self._tenant_of.pop(sess, None))
        for tenant in lost_tenants:
            self.scheduler.session_closed(tenant)
        self._notify_routes()
        # point stale direct clients at the majority target (best effort
        # — the drained instance may already be gone)
        if placed:
            counts: Dict[str, int] = {}
            for target in placed.values():
                counts[target.name] = counts.get(target.name, 0) + 1
            majority = self.backends[max(counts, key=counts.get)]
            try:
                backend.set_redirect(majority.url)
            except (BackendDown, ServeError, OSError):
                pass
        seconds = self._clock() - t0
        self.metrics.set_gauge("router_failover_recovery_s", seconds)
        emit_text(f"[router] failover of {backend.name} complete: "
                  f"{len(placed)} sessions moved, {len(lost)} lost, "
                  f"{seconds:.3f}s", self.sinks)
        return {"backend": backend.name, "reason": reason,
                "restored": {s: t.name for s, t in placed.items()},
                "lost": sorted(lost), "seconds": seconds}

    def _forget_backend_sessions(self, backend_name: str) -> List[str]:
        with self._lock:
            gone = [s for s, bn in self._routes.items()
                    if bn == backend_name]
            tenants = [self._tenant_of.pop(s, None) for s in gone]
            for s in gone:
                self._routes.pop(s, None)
        for tenant in tenants:
            self.metrics.inc("router_sessions_closed")
            self.scheduler.session_closed(tenant)
        return gone

    def _replace_sessions(self, snaps: Dict[str, dict],
                          exclude: set) -> Tuple[Dict[str, Backend],
                                                 List[str]]:
        """Place a drained snapshot's sessions on healthy backends:
        partition by (toolbox availability, bucket affinity), restore
        each part, and keep re-placing any part whose target dies
        mid-restore or whose sessions the target skipped — until every
        session is restored somewhere or no candidate remains."""
        remaining = dict(snaps)
        placed: Dict[str, Backend] = {}
        vetoed: Dict[str, set] = {}      # session -> backends ruled out
        first_choice: Dict[str, str] = {}
        while remaining:
            assign: Dict[str, Dict[str, dict]] = {}
            unplaceable: List[str] = []
            for sess, snap in remaining.items():
                target = self._pick_restore_target(
                    snap, exclude | vetoed.get(sess, set()))
                if target is None:
                    unplaceable.append(sess)
                else:
                    assign.setdefault(target.name, {})[sess] = snap
                    first_choice.setdefault(sess, target.name)
            for sess in unplaceable:
                remaining.pop(sess)
            if not assign:
                break
            for target_name, part in assign.items():
                target = self.backends[target_name]
                try:
                    resp = target.restore(part)
                except (BackendDown, OSError) as e:
                    # mid-restore death: the target adopted nothing it
                    # acknowledged — latch it sick and re-place this
                    # part on a third instance next round.  force_sick
                    # fires the full failover for the target (NOT a
                    # pre-emptive _mark_down, which would turn that
                    # failover into an already-down no-op and strand the
                    # target's own native sessions routed but untended)
                    emit_text(f"[router] restore target {target_name} "
                              f"died mid-restore ({e}); re-placing "
                              f"{len(part)} sessions", self.sinks)
                    self.health.force_sick(target_name,
                                           f"died mid-restore: {e}")
                    for sess in part:
                        vetoed.setdefault(sess, set()).add(target_name)
                    continue
                except ServeError as e:
                    # h_restore rejected the WHOLE part (every session
                    # skipped — e.g. the registry lost the toolbox since
                    # the router last looked): the target adopted
                    # nothing; refresh its registry model and re-place
                    # the part on the next instance
                    emit_text(f"[router] {target_name} rejected restore "
                              f"({e}); re-placing {len(part)} sessions",
                              self.sinks)
                    for sess in part:
                        vetoed.setdefault(sess, set()).add(target_name)
                    self._toolboxes(target, refresh=True)
                    continue
                for sess in resp.get("restored", ()):
                    placed[sess] = target
                    remaining.pop(sess, None)
                    if first_choice.get(sess) != target_name:
                        self.metrics.inc("router_orphans_replaced")
                    with self._lock:
                        snap = snaps[sess]
                        self._plans[target_name].observe_placement(
                            int(snap.get("n", 1)),
                            self.placement.bucket_rows(
                                int(snap.get("n", 1))),
                            genome_signature(snap["genome"]))
                for sess, why in (resp.get("skipped") or {}).items():
                    # h_restore skipped the orphan (toolbox not in this
                    # registry) — rule the target out for it and try the
                    # next instance instead of dropping the session
                    emit_text(f"[router] {target_name} skipped {sess} "
                              f"({why}); re-placing", self.sinks)
                    vetoed.setdefault(sess, set()).add(target_name)
                    self._toolboxes(target, refresh=True)
        return placed, sorted(remaining)

    def _pick_restore_target(self, snap: dict,
                             exclude: set) -> Optional[Backend]:
        tb_name = snap.get("toolbox")
        candidates = []
        for backend in self.healthy():
            if backend.name in exclude:
                continue
            if tb_name is not None and \
                    tb_name not in self._toolboxes(backend):
                continue
            with self._lock:
                plan = self._plans[backend.name]
            candidates.append((backend, plan))
        if not candidates:
            return None
        choice, _warm = self.placement.choose(
            candidates, int(snap.get("n", 1)),
            genome_signature(snap["genome"]))
        return choice

    # -- forwarding support (RouterServer) -----------------------------------

    def note_forward_failure(self, backend: Backend, exc: Exception) -> None:
        """A forward to ``backend`` failed at the transport level: run a
        probe round NOW (the strike path — repeated failures latch the
        instance sick and fire failover without waiting out the poll
        interval)."""
        self.metrics.inc("router_errors")
        emit_text(f"[router] forward to {backend.name} failed: {exc}",
                  self.sinks)
        self.health.check_now()
