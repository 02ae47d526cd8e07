"""``python -m deap_tpu_torch.serve.top`` — the live fleet dashboard.

Operating a router fleet today means curling N ``/v1/metrics``
endpoints by hand and summing counters in your head.  This module is
the one-screen replacement: point it at a router (backends discovered
through ``GET /v1/admin/fleet``) or at explicit instances, and it
renders fleet-aggregate throughput, per-instance queue depth /
pad-waste / compile events, per-tenant SLO counters and latency
quantiles into one refreshing plain-text screen::

    python -m deap_tpu_torch.serve.top --router http://127.0.0.1:8700
    python -m deap_tpu_torch.serve.top --instances 127.0.0.1:8701,127.0.0.1:8702
    python -m deap_tpu_torch.serve.top --router ... --once --json

The instances may be the port's or the JAX package's (the same
endpoints).  Liveness discipline: there are **no polling sleeps**
anywhere.  One tail thread per
instance blocks on the server's ``/v1/metrics?stream=1`` chunked
ND-JSON stream — which the server itself feeds from a Condition wait on
dispatcher activity — and pokes an :class:`threading.Event` the render
loop waits on (with a refresh-interval cap, so gauges re-render even
while traffic is quiet).  An idle fleet costs one blocked socket read
per instance, not a poll.

``--once`` takes one synchronous snapshot instead (no threads) and
exits; with ``--json`` it prints the machine-readable document — the
``fleet.counters`` section is the exact per-counter SUM of the
``instances`` sections (``tests/test_torch_serve_top.py``), so
scripts can alarm on fleet aggregates without re-implementing the
join.

This module's stdout is its interface (sanctioned print site, like
``serve/cli.py``).
"""

from __future__ import annotations

import argparse
import http.client
import json
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import sanitize
from .net.client import _parse_address

__all__ = ["FleetTop", "aggregate", "main"]

#: per-instance counters shown as columns (the rest still sum into the
#: fleet aggregate)
_COLUMNS = ("steps", "requests", "completed", "failed", "rejected",
            "compiles")


def _get_json(url_host: str, url_port: int, path: str,
              timeout: float) -> Any:
    conn = http.client.HTTPConnection(url_host, url_port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status >= 400:
            raise OSError(f"HTTP {resp.status} on {path}: {data[:200]!r}")
        return json.loads(data.decode("utf-8"))
    finally:
        conn.close()


def aggregate(instances: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet rollup over per-instance metric records: counters SUM
    per name (``fleet["counters"][k] == sum(inst[k])`` — the pinned
    contract), summable gauges sum, ratio gauges report their fleet
    maximum under a ``_max`` suffix, per-tenant tables merge by
    summing, and the worst per-instance p99 is surfaced."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    tenants: Dict[str, Dict[str, int]] = {}
    worst_p99 = 0.0
    up = 0
    for rec in instances.values():
        if rec.get("error"):
            continue
        up += 1
        for k, v in (rec.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        g = rec.get("gauges") or {}
        for k in ("queue_depth", "sessions", "sharded_sessions"):
            if k in g:
                gauges[k] = gauges.get(k, 0.0) + float(g[k])
        for k in ("pad_waste", "slot_occupancy", "row_occupancy"):
            if k in g:
                gauges[f"{k}_max"] = max(gauges.get(f"{k}_max", 0.0),
                                         float(g[k]))
        worst_p99 = max(worst_p99, float(g.get("latency_p99_ms", 0.0)))
        for tenant, row in ((rec.get("meta") or {}).get("tenants")
                            or {}).items():
            dst = tenants.setdefault(tenant, {})
            for k, v in row.items():
                dst[k] = dst.get(k, 0) + int(v)
    gauges["latency_p99_ms_max"] = worst_p99
    return {"instances_up": up,
            "instances_total": len(instances),
            "counters": counters,
            "gauges": gauges,
            "tenants": tenants}


class FleetTop:
    """Scraper + aggregator behind the dashboard screen.

    ``router`` is a router URL whose ``/v1/admin/fleet`` names the
    backends; ``instances`` adds (or replaces, router-less) explicit
    ``name=url`` or bare ``url`` targets.  :meth:`collect_once` is the
    synchronous one-shot; :meth:`run_live` starts one stream-tail
    thread per instance and re-renders on activity."""

    #: lock-guarded shared state: the latest
    #: per-instance records are written by every stream-tail thread and
    #: read by the render loop; the live-connection registry is written
    #: by tail threads and drained by close()
    _GUARDED_BY = {"_lock": ("_latest", "_conns")}

    def __init__(self, *, router: Optional[str] = None,
                 instances: Tuple[str, ...] = (),
                 timeout: float = 5.0, clock=time.monotonic):
        if router is None and not instances:
            raise ValueError("need --router or --instances")
        self.router = router
        self.timeout = float(timeout)
        self.clock = clock
        self._explicit = tuple(instances)
        self._lock = sanitize.lock()
        self._latest: Dict[str, Dict[str, Any]] = {}
        self._conns: Dict[str, http.client.HTTPConnection] = {}
        self._wake = sanitize.event()
        self._stop = sanitize.event()
        self._threads: List[threading.Thread] = []
        self._prev: Optional[Tuple[float, Dict[str, int]]] = None

    # -- discovery -----------------------------------------------------------

    def _explicit_targets(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for i, spec in enumerate(self._explicit):
            if "=" in spec:
                name, url = spec.split("=", 1)
            else:
                name, url = spec, spec
            host, port = _parse_address(url)
            out[name.strip() or f"inst{i}"] = f"http://{host}:{port}"
        return out

    def discover(self) -> Tuple[Dict[str, str], Optional[dict]]:
        """``({instance name: url}, router topology | None)`` — backends
        from the router's admin view plus any explicit instances."""
        targets = self._explicit_targets()
        topology = None
        if self.router is not None:
            host, port = _parse_address(self.router)
            topology = _get_json(host, port, "/v1/admin/fleet",
                                 self.timeout)
            for name, info in (topology.get("backends") or {}).items():
                url = info.get("url")
                if url:
                    targets.setdefault(name, url)
        return targets, topology

    # -- one-shot ------------------------------------------------------------

    def _fetch_instance(self, url: str) -> Dict[str, Any]:
        host, port = _parse_address(url)
        try:
            rec = _get_json(host, port, "/v1/metrics", self.timeout)
        except (OSError, ValueError, http.client.HTTPException) as e:
            return {"url": url, "error": f"{type(e).__name__}: {e}"}
        return {"url": url, "error": None,
                "gen": rec.get("gen", 0),
                "counters": rec.get("counters", {}),
                "gauges": rec.get("gauges", {}),
                "meta": rec.get("meta", {}) or {}}

    def collect_once(self) -> Dict[str, Any]:
        """One synchronous fleet snapshot: topology (when routed),
        per-instance records, and the fleet aggregate — the ``--once``
        / ``--json`` document."""
        targets, topology = self.discover()
        instances = {name: self._fetch_instance(url)
                     for name, url in sorted(targets.items())}
        doc: Dict[str, Any] = {
            "instances": instances,
            "fleet": aggregate(instances),
        }
        if topology is not None:
            doc["router"] = {"url": self.router,
                             "sessions": topology.get("sessions"),
                             "sick": topology.get("sick") or {},
                             "fleet_sizes": topology.get("fleet_sizes"),
                             "autoscale": topology.get("autoscale")}
        doc["throughput"] = self._throughput(doc["fleet"]["counters"])
        return doc

    def _throughput(self, counters: Dict[str, int]) -> Dict[str, float]:
        """steps/requests per second since the previous snapshot (first
        snapshot: absent — a rate needs two points)."""
        now = self.clock()
        prev = self._prev
        self._prev = (now, dict(counters))
        if prev is None or now <= prev[0]:
            return {}
        dt = now - prev[0]
        return {f"{k}_per_s": round(
                    max(0, counters.get(k, 0) - prev[1].get(k, 0)) / dt, 2)
                for k in ("steps", "requests", "evaluations")}

    # -- live mode -----------------------------------------------------------

    def _tail_instance(self, name: str, url: str) -> None:
        """Stream-tail thread: block on the instance's chunked ND-JSON
        metrics stream, publish each record, poke the render loop.  On
        stream end/error, wait on the STOP event (not a sleep) before
        reconnecting — an unreachable instance costs one bounded wait
        per attempt, and close() wakes it immediately."""
        host, port = _parse_address(url)
        while not self._stop.is_set():
            conn = http.client.HTTPConnection(host, port,
                                              timeout=max(self.timeout, 30))
            # registered so close() can sever a read blocked in
            # readline() — the stream's quiet window is ~25s and _stop
            # is only checked between records
            with self._lock:
                self._conns[name] = conn
            try:
                conn.request(
                    "GET", "/v1/metrics?stream=1&max=1000000&timeout=25")
                resp = conn.getresponse()
                if resp.status >= 400:
                    raise OSError(f"HTTP {resp.status}")
                while not self._stop.is_set():
                    line = resp.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line.decode("utf-8"))
                    with self._lock:
                        self._latest[name] = {
                            "url": url, "error": None,
                            "gen": rec.get("gen", 0),
                            "counters": rec.get("counters", {}),
                            "gauges": rec.get("gauges", {}),
                            "meta": rec.get("meta", {}) or {}}
                    self._wake.set()
            except (OSError, ValueError, http.client.HTTPException,
                    AttributeError) as e:
                # AttributeError is the expected shutdown shape: close()
                # severs this thread's connection under a blocked
                # readline(), which surfaces as a read on the torn-down
                # response object
                if self._stop.is_set():
                    break
                with self._lock:
                    self._latest[name] = {
                        "url": url, "error": f"{type(e).__name__}: {e}"}
                self._wake.set()
                # bounded reconnect backoff on the STOP event — wakes
                # instantly at close(), never a blind sleep
                self._stop.wait(1.0)
            finally:
                with self._lock:
                    if self._conns.get(name) is conn:
                        del self._conns[name]
                conn.close()

    def start_streams(self) -> Dict[str, str]:
        targets, _ = self.discover()
        for name, url in sorted(targets.items()):
            t = threading.Thread(target=self._tail_instance,
                                 args=(name, url),
                                 name=f"deap-tpu-top-{name}", daemon=True)
            t.start()
            self._threads.append(t)
        return targets

    def snapshot_live(self) -> Dict[str, Any]:
        with self._lock:
            instances = {k: dict(v) for k, v in self._latest.items()}
        doc = {"instances": instances, "fleet": aggregate(instances)}
        doc["throughput"] = self._throughput(doc["fleet"]["counters"])
        return doc

    def run_live(self, *, refresh: float = 2.0,
                 max_refreshes: Optional[int] = None,
                 out=None) -> int:
        """The dashboard loop: render on activity (stream records set
        the wake event) or every ``refresh`` seconds, whichever comes
        first.  ``max_refreshes`` bounds the loop for tests/scripting;
        interactive runs render until interrupted."""
        out = out if out is not None else sys.stdout
        targets = self.start_streams()
        # seed the table so the first frame shows every instance
        for name, url in targets.items():
            rec = self._fetch_instance(url)
            with self._lock:
                self._latest.setdefault(name, rec)
        frames = 0
        try:
            while max_refreshes is None or frames < max_refreshes:
                doc = self.snapshot_live()
                print(render_screen(doc, clear=out.isatty()), file=out)
                frames += 1
                if max_refreshes is not None and frames >= max_refreshes:
                    break
                self._wake.wait(refresh)
                self._wake.clear()
                if self._stop.is_set():
                    break
        except KeyboardInterrupt:
            pass
        finally:
            self.close()
        return 0

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        # sever the live streams: a tail thread blocked in readline()
        # only re-checks _stop between records, and closing the fd does
        # NOT wake a thread parked in recv() — the socket must be
        # shutdown() under it (both directions) to unblock the join
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            try:
                if conn.sock is not None:
                    conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        # keep any thread whose join timed out visible — a "clean"
        # close must not mask a straggler from the caller (or the
        # test-suite thread-leak gate)
        self._threads = [t for t in self._threads if t.is_alive()]


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def render_screen(doc: Dict[str, Any], clear: bool = False) -> str:
    """One plain-text frame of the dashboard."""
    lines: List[str] = []
    if clear:
        lines.append("\x1b[2J\x1b[H" + "")
    fleet = doc.get("fleet", {})
    counters = fleet.get("counters", {})
    gauges = fleet.get("gauges", {})
    thr = doc.get("throughput", {})
    head = (f"deap-tpu-top  instances {fleet.get('instances_up', 0)}/"
            f"{fleet.get('instances_total', 0)}  sessions "
            f"{_fmt(gauges.get('sessions', 0))}  queue "
            f"{_fmt(gauges.get('queue_depth', 0))}  pad-waste(max) "
            f"{_fmt(gauges.get('pad_waste_max', 0))}")
    if "steps_per_s" in thr:
        head += f"  steps/s {_fmt(thr['steps_per_s'])}"
    lines.append(head)
    router = doc.get("router")
    if router:
        sick = router.get("sick") or {}
        lines.append(f"router {router.get('url')}  routed-sessions "
                     f"{router.get('sessions')}  sick "
                     f"{sorted(sick) if sick else 'none'}")
        scale = router.get("autoscale")
        if scale:
            pol = scale.get("policy") or {}
            sig = scale.get("signals") or {}
            lines.append(
                f"autoscale {scale.get('decision', 'hold')}  instances "
                f"{_fmt(sig.get('instances', '?'))} "
                f"[{pol.get('min_instances', '?')}-"
                f"{pol.get('max_instances', '?')}]  queue "
                f"{_fmt(sig.get('queue_depth', 0))}  cooldown "
                f"{_fmt(scale.get('cooldown_remaining_s', 0))}s  "
                f"fabric-hits {counters.get('cache_fabric_hits', 0)}")
    lines.append(
        f"fleet  steps {counters.get('steps', 0)}  requests "
        f"{counters.get('requests', 0)}  completed "
        f"{counters.get('completed', 0)}  failed "
        f"{counters.get('failed', 0)}  compiles "
        f"{counters.get('compiles', 0)}  p99(worst) "
        f"{_fmt(gauges.get('latency_p99_ms_max', 0))}ms")
    cols = "".join(f"{c:>11s}" for c in _COLUMNS)
    lines.append(f"{'instance':16s}{cols}{'queue':>8s}{'pad%':>8s}"
                 f"{'p50ms':>9s}{'p99ms':>9s}")
    for name in sorted(doc.get("instances", {})):
        rec = doc["instances"][name]
        if rec.get("error"):
            lines.append(f"{name:16s}  DOWN: {rec['error']}")
            continue
        c = rec.get("counters", {})
        g = rec.get("gauges", {})
        row = "".join(f"{c.get(col, 0):>11d}" for col in _COLUMNS)
        pad = 100.0 * float(g.get("pad_waste", 0.0))
        lines.append(
            f"{name:16s}{row}{int(g.get('queue_depth', 0)):>8d}"
            f"{pad:>8.1f}{float(g.get('latency_p50_ms', 0.0)):>9.1f}"
            f"{float(g.get('latency_p99_ms', 0.0)):>9.1f}")
    tenants = fleet.get("tenants") or {}
    if tenants:
        lines.append("tenants (top by requests):")
        top = sorted(tenants.items(),
                     key=lambda kv: -kv[1].get("requests", 0))[:8]
        for tenant, row in top:
            lines.append(
                f"  {tenant:24s} req {row.get('requests', 0):>7d}  "
                f"done {row.get('completed', 0):>7d}  "
                f"miss {row.get('deadline_misses', 0):>5d}  "
                f"rej {row.get('rejected', 0):>5d}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# console entry
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deap_tpu_torch.serve.top",
        description="Live dashboard over a deap-tpu serving fleet: "
                    "fleet-aggregate throughput, per-instance queue/"
                    "pad-waste/compiles, per-tenant SLO counters.")
    ap.add_argument("--router", default=None,
                    help="router URL; backends discovered via "
                         "/v1/admin/fleet")
    ap.add_argument("--instances", default=None,
                    help="comma-separated instance URLs (optionally "
                         "name=url) to watch directly")
    ap.add_argument("--once", action="store_true",
                    help="one snapshot, then exit (no stream threads)")
    ap.add_argument("--json", action="store_true", dest="json_out",
                    help="with --once: print the machine-readable "
                         "snapshot (fleet.counters is the exact sum of "
                         "the instances' counters)")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="live mode: max seconds between re-renders "
                         "(activity re-renders sooner)")
    ap.add_argument("--max-refreshes", type=int, default=None,
                    help="live mode: render N frames then exit "
                         "(scripting/tests; default: until interrupted)")
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="per-request HTTP timeout")
    args = ap.parse_args(argv)

    instances = tuple(s.strip() for s in (args.instances or "").split(",")
                      if s.strip())
    if args.json_out and not args.once:
        ap.error("--json requires --once (the live screen is text)")
    try:
        top = FleetTop(router=args.router, instances=instances,
                       timeout=args.timeout)
    except ValueError as e:
        ap.error(str(e))
    if args.once:
        try:
            doc = top.collect_once()
        except (OSError, ValueError, http.client.HTTPException) as e:
            print(f"deap-tpu-top: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
        if args.json_out:
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            print(render_screen(doc))
        return 0 if doc["fleet"]["instances_up"] > 0 else 1
    return top.run_live(refresh=args.refresh,
                        max_refreshes=args.max_refreshes)


if __name__ == "__main__":
    sys.exit(main())
