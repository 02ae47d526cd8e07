"""Host-side service metrics: counters, gauges, latency quantiles, and
per-tenant attribution.

The serving layer's control plane is host threads, so its metrics are
plain (locked) python counters that snapshot into the
:class:`~deap_tpu_torch.observability.sinks.MetricRecord` shape the sink
layer speaks.

Latency is tracked as a bounded reservoir of recent per-request wall times
per request kind; :meth:`ServeMetrics.latency_quantiles` reports p50/p90/p99
over the window (steady-state service quantiles, not all-time).  The
reservoirs are **snapshotted under the lock and sorted outside it** — a
metrics scrape sorting thousands of samples while holding the lock would
stall the dispatch worker's ``observe_latency`` mid-batch.

Per-tenant attribution: :meth:`ServeMetrics.inc_tenant` maintains a
second, session-name-keyed counter table (:data:`TENANT_COUNTERS` — the
SLO set: deadline misses, backpressure rejects, cache hits/misses, ...)
that rides in the snapshot's ``meta["tenants"]`` and becomes labelled
series in the Prometheus exposition (:func:`prometheus_text`, served at
``/v1/metrics?format=prometheus``).  Metric NAMES are static snake_case
identifiers from the registries below; tenant identity lives in the
table key / label, never in the metric name.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, Optional

from .. import sanitize
from ..observability.sinks import MetricRecord, emit_record

__all__ = ["ServeMetrics", "SERVE_COUNTERS", "SERVE_GAUGES", "NET_COUNTERS",
           "ROUTER_COUNTERS", "ROUTER_GAUGES", "TENANT_COUNTERS",
           "AUTOSCALE_COUNTERS", "AUTOSCALE_GAUGES",
           "prometheus_text", "prometheus_fleet_text"]

#: Counters the service maintains (cumulative over the service lifetime).
SERVE_COUNTERS = (
    "requests", "completed", "failed", "cancelled", "deadline_misses",
    "rejected", "batches", "retries", "compiles", "compiles_step",
    "compiles_init", "compiles_ask", "compiles_tell", "compiles_evaluate",
    "steps", "steps_streamed", "evaluations",
    "cache_hits", "cache_misses",
    "cache_evictions", "cache_nan_skipped", "cache_purged", "dedup_rows",
    "quarantined", "rebuckets", "rebuckets_auto", "rebucket_policy_errors",
    "deadline_shed", "brownout_sheds",
)

#: Counters the network frontend (deap_tpu_torch.serve.net) adds on top —
#: maintained in the same ServeMetrics store so one /metrics snapshot
#: covers both the HTTP edge and the device control plane.
NET_COUNTERS = (
    "net_requests", "net_errors", "net_streams",
    "net_bytes_in", "net_bytes_out", "net_bytes_saved",
    "net_frames_compressed",
)

#: Counters of the fleet router (deap_tpu_torch.serve.router) — the
#: control plane ABOVE one instance; the router's ServeMetrics store is
#: constructed with ``extra_counters=ROUTER_COUNTERS``.
ROUTER_COUNTERS = (
    "router_requests", "router_errors", "router_forwards",
    "router_forward_retries", "router_sessions_placed",
    "router_sessions_closed", "router_placements_warm",
    "router_quota_rejections", "router_health_probes",
    "router_backends_sick", "router_failovers", "router_failover_sessions",
    "router_orphans_replaced", "router_sessions_lost",
    "router_breaker_opens", "router_breaker_probes",
    "router_breaker_rejections", "router_deadline_shed",
)

#: Gauges of the fleet router (last-value).
ROUTER_GAUGES = (
    "router_backends_alive", "router_sessions_routed",
    "router_inflight", "router_failover_recovery_s",
    "router_backends_degraded",
)

#: Counters of the elastic-fleet layer (the autoscaler, live migration
#: and the fitness-cache fabric).  The router's store pre-registers them,
#: so its record has the JAX router's key set; nothing in the port counts
#: them yet (queue 1 item 11b (ii) of ROADMAP.md).
AUTOSCALE_COUNTERS = (
    "autoscale_scale_out_events", "autoscale_scale_in_events",
    "autoscale_migrations", "autoscale_migration_failures",
    "autoscale_errors", "autoscale_prewarms",
    "cache_fabric_hits", "cache_fabric_exports", "cache_fabric_imports",
    "cache_fabric_syncs",
)

#: Gauges of the elastic-fleet layer (last-value).
AUTOSCALE_GAUGES = (
    "autoscale_instances", "autoscale_migration_downtime_s",
    "autoscale_last_decision_queue_depth",
)

#: Gauges (last-value).  ``profile_programs`` is the profiler's rollup
#: (per-program records ride the snapshot's ``meta["programs"]`` table
#: and the labelled Prometheus series — a program key must never become
#: part of a metric NAME).  The JAX package's ``profile_flops_total``,
#: ``profile_bytes_accessed_total`` and ``profile_peak_bytes_max`` sum
#: XLA's cost analyses, which the port has no program for: they are
#: absent here, not zero.
SERVE_GAUGES = (
    "queue_depth", "sessions", "sessions_streamed",
    "slot_occupancy", "row_occupancy", "pad_waste", "profile_programs",
)

#: Per-tenant (per-session) counters — the SLO attribution set.  Tenant
#: identity is the table key (and the Prometheus label), NEVER part of a
#: metric name.
TENANT_COUNTERS = (
    "requests", "completed", "failed", "rejected", "deadline_misses",
    "steps", "cache_hits", "cache_misses",
)


class ServeMetrics:
    """Thread-safe counter/gauge/latency store for one
    :class:`~deap_tpu_torch.serve.service.EvolutionService`.

    ``max_tenants`` bounds the per-tenant table: when a fresh tenant
    would exceed it, the oldest tenant's row is evicted (the table is a
    live attribution view, not an accounting ledger — long-lived fleets
    must not leak a row per dead session forever).

    ``extra_counters`` / ``extra_gauges`` pre-register additional name
    families in the snapshot (the router passes
    :data:`ROUTER_COUNTERS`/:data:`ROUTER_GAUGES`) — backend snapshots
    stay free of zero-valued router series."""

    #: lock-guarded shared state (``lock-discipline`` lint + runtime
    #: sanitizer): every counter/gauge/reservoir/tenant table access
    #: is shared between the dispatch worker and scraper threads
    _GUARDED_BY = {"_lock": ("_counters", "_gauges", "_latency",
                             "_tenants")}

    def __init__(self, latency_window: int = 2048, max_tenants: int = 4096,
                 extra_counters: Iterable[str] = (),
                 extra_gauges: Iterable[str] = ()):
        self._lock = sanitize.lock()
        self._counters: Dict[str, int] = {
            k: 0 for k in SERVE_COUNTERS + NET_COUNTERS
            + tuple(extra_counters)}
        self._gauges: Dict[str, float] = {
            k: 0.0 for k in SERVE_GAUGES + tuple(extra_gauges)}
        self._latency: Dict[str, collections.deque] = {}
        self._window = int(latency_window)
        self._tenants: "collections.OrderedDict[str, Dict[str, int]]" = \
            collections.OrderedDict()
        self.max_tenants = int(max_tenants)

    # -- writers -------------------------------------------------------------

    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(value)

    def inc_tenant(self, tenant: Optional[str], name: str,
                   value: int = 1) -> None:
        """Count ``value`` under ``tenant``'s row (no-op for ``None`` —
        requests without a session have no tenant to attribute to)."""
        if tenant is None:
            return
        with self._lock:
            row = self._tenants.get(tenant)
            if row is None:
                while len(self._tenants) >= self.max_tenants:
                    self._tenants.popitem(last=False)
                row = self._tenants[tenant] = {}
            row[name] = row.get(name, 0) + int(value)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe_latency(self, kind: str, seconds: float) -> None:
        with self._lock:
            q = self._latency.get(kind)
            if q is None:
                q = self._latency[kind] = collections.deque(
                    maxlen=self._window)
            q.append(float(seconds))

    # -- readers -------------------------------------------------------------

    def counter(self, name: str) -> int:
        with self._lock:
            return int(self._counters.get(name, 0))

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def tenant_counters(self) -> Dict[str, Dict[str, int]]:
        """``{tenant: {counter: value}}`` snapshot."""
        with self._lock:
            return {t: dict(row) for t, row in self._tenants.items()}

    @staticmethod
    def _quantile(sorted_samples, q: float) -> float:
        if not sorted_samples:
            return 0.0
        i = min(len(sorted_samples) - 1,
                max(0, round(q * (len(sorted_samples) - 1))))
        return sorted_samples[i]

    def latency_quantiles(self, kinds: Optional[Iterable[str]] = None
                          ) -> Dict[str, float]:
        """``{"latency_<kind>_p50_ms": ..., ...}`` over the recent window
        (all kinds pooled under ``latency_p*`` as well).  The reservoirs
        are copied under the lock; the O(n log n) sorts run OUTSIDE it so
        a scrape never stalls ``observe_latency`` on the dispatch
        worker."""
        with self._lock:
            samples = {k: list(v) for k, v in self._latency.items()
                       if (kinds is None or k in kinds) and v}
        for v in samples.values():
            v.sort()
        out: Dict[str, float] = {}
        pooled = sorted(s for v in samples.values() for s in v)
        for label, data in [("", pooled)] + [
                (f"{k}_", v) for k, v in sorted(samples.items())]:
            for q, name in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                out[f"latency_{label}{name}_ms"] = \
                    self._quantile(data, q) * 1e3
        return out

    def snapshot(self, seq: int = 0) -> MetricRecord:
        """Everything as one :class:`MetricRecord` (``gen`` carries the
        batch sequence number — the service's notion of time; per-tenant
        counters ride in ``meta["tenants"]``)."""
        gauges = self.gauges()
        gauges.update(self.latency_quantiles())
        meta: dict = {"source": "serve"}
        tenants = self.tenant_counters()
        if tenants:
            meta["tenants"] = tenants
        return MetricRecord(gen=int(seq), counters=self.counters(),
                            gauges=gauges, meta=meta)

    def emit(self, sinks, seq: int = 0) -> None:
        emit_record(sinks, self.snapshot(seq))


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_PROM_PREFIX = "deap_tpu_serve"

#: ``latency_<kind?>_p<q>_ms`` gauge names (the reservoir snapshot) —
#: exported as the proper ``deap_tpu_latency_seconds`` summary series
#: instead of flat per-quantile gauge names
_LATENCY_GAUGE_RE = re.compile(
    r"\Alatency_(?:(?P<kind>.+)_)?p(?P<q>50|90|99)_ms\Z")
_QUANTILE_OF = {"50": "0.5", "90": "0.9", "99": "0.99"}

#: per-program profile values exported as labelled gauge series (the
#: program key is a label, never a metric name)
_PROGRAM_SERIES = (
    ("calls", "program_calls"),
    ("device_min_s", "program_device_min_seconds"),
    ("compile_s", "program_compile_seconds"),
)


def _prom_label(value: str) -> str:
    """Escape a label value per the Prometheus text format."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _families_of(record: MetricRecord,
                 instance: Optional[str] = None) -> "collections.OrderedDict":
    """``{metric name: (type, [(labels, formatted value), ...])}`` for
    one record — the shared decomposition :func:`prometheus_text`
    renders directly and :func:`prometheus_fleet_text` merges across
    instances (so a fleet exposition declares each TYPE exactly once)."""
    base = {} if instance is None else {"instance": str(instance)}
    fams: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()

    def add(metric: str, typ: str, labels: Dict[str, str],
            value: str) -> None:
        fam = fams.setdefault(metric, (typ, []))
        fam[1].append((dict(base, **labels), value))

    # 0.0.4 text format: a TYPE line must name the SAMPLE's metric
    # exactly, so the counter families carry their _total suffix in both
    for name in sorted(record.counters):
        add(f"{_PROM_PREFIX}_{name}_total", "counter", {},
            str(int(record.counters[name])))
    latency: list = []
    for name in sorted(record.gauges):
        m = _LATENCY_GAUGE_RE.match(name)
        if m is not None:
            latency.append((m.group("kind") or "all",
                            _QUANTILE_OF[m.group("q")],
                            float(record.gauges[name]) / 1e3))
            continue
        add(f"{_PROM_PREFIX}_{name}", "gauge", {},
            f"{float(record.gauges[name]):g}")
    # reservoir quantiles as one summary family, labelled by request
    # kind ("all" = the pooled reservoir) and quantile
    for kind, quantile, seconds in latency:
        add("deap_tpu_latency_seconds", "summary",
            {"kind": kind, "quantile": quantile}, f"{seconds:g}")
    tenants = record.meta.get("tenants") or {}
    by_counter: Dict[str, list] = {}
    for tenant in sorted(tenants):
        for cname, v in sorted(tenants[tenant].items()):
            by_counter.setdefault(cname, []).append((tenant, v))
    for cname in sorted(by_counter):
        for tenant, v in by_counter[cname]:
            add(f"{_PROM_PREFIX}_tenant_{cname}_total", "counter",
                {"tenant": tenant}, str(int(v)))
    # per-program device-phase profiles (meta["programs"], when the
    # service runs with its profiler enabled): program key as a label
    programs = record.meta.get("programs") or {}
    for key in sorted(programs):
        prof = programs[key]
        labels = {"program": key, "kind": str(prof.get("kind", ""))}
        for field, series in _PROGRAM_SERIES:
            v = prof.get(field)
            if v is not None:
                add(f"{_PROM_PREFIX}_{series}", "gauge", labels,
                    f"{float(v):g}")
    add(f"{_PROM_PREFIX}_batches_seq", "gauge", {}, str(int(record.gen)))
    return fams


def _render_families(fams) -> str:
    lines = []
    for metric, (typ, samples) in fams.items():
        lines.append(f"# TYPE {metric} {typ}")
        for labels, value in samples:
            lines.append(f"{metric}{_label_str(labels)} {value}")
    return "\n".join(lines) + "\n"


def prometheus_text(record: MetricRecord,
                    instance: Optional[str] = None) -> str:
    """Render a serve :class:`MetricRecord` in the Prometheus text
    exposition format (version 0.0.4): counters as
    ``deap_tpu_serve_<name>_total``, gauges as
    ``deap_tpu_serve_<name>``, the latency reservoir quantiles as
    summary-style ``deap_tpu_latency_seconds{kind=...,quantile=...}``
    series (seconds, per request kind plus the pooled ``kind="all"``),
    per-tenant SLO counters as
    ``deap_tpu_serve_tenant_<name>_total{tenant="..."}`` and — when the
    record carries the profiler's ``meta["programs"]`` table —
    per-compiled-program ``deap_tpu_serve_program_*{program=...}``
    series.  ``instance`` (optional) adds an ``instance`` label to every
    sample — the fleet exposition's disambiguator."""
    return _render_families(_families_of(record, instance))


def prometheus_fleet_text(records: Dict[str, MetricRecord]) -> str:
    """One exposition covering a whole fleet: ``{instance name:
    record}`` merged so each metric family is declared once and every
    sample carries its ``instance`` label — what the router serves at
    ``GET /v1/admin/fleet?format=prometheus`` (one scrape, N
    instances)."""
    merged: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
    for inst, rec in records.items():
        for metric, (typ, samples) in _families_of(rec, inst).items():
            fam = merged.setdefault(metric, (typ, []))
            fam[1].extend(samples)
    return _render_families(merged)
