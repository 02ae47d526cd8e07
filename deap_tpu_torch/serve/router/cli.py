"""``python -m deap_tpu_torch.serve.router.cli`` — front a fleet of
serving instances.

The fleet sibling of ``python -m deap_tpu_torch.serve.cli --listen``:
stand up a :class:`~deap_tpu_torch.serve.router.server.RouterServer` over
N already-running ``NetServer`` instances (the port's or the JAX
package's) and serve the same DTF1 protocol until interrupted — clients
point an unchanged ``RemoteService`` at the router URL.  The router is
host code and takes no device.

    python -m deap_tpu_torch.serve.router.cli --listen 0.0.0.0:8070 \\
        --backend a=10.0.0.1:8077 --backend b=10.0.0.2:8077 \\
        --backend c=10.0.0.3:8077

    # tenant enforcement: gold gets 3x the fair share, 8 sessions max
    python -m deap_tpu_torch.serve.router.cli --listen :8070 \\
        --backend a=:8077 --backend b=:8078 \\
        --quota gold=sessions:8,weight:3 --quota free=sessions:1 \\
        --max-inflight 32

On SIGINT the router reports one JSON summary line (topology + counters)
and exits; exit status is non-zero when every backend is down.  Health
polling, failover and placement knobs map one-to-one onto
:class:`~deap_tpu_torch.serve.router.health.HealthPolicy` /
:class:`~deap_tpu_torch.serve.router.core.FleetRouter`.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

__all__ = ["main", "parse_backend", "parse_quota"]


def parse_backend(spec: str):
    """``name=host:port`` → ``(name, (host, port))``; host defaults to
    127.0.0.1 so ``a=:8077`` fronts a local instance."""
    name, eq, addr = spec.partition("=")
    if not eq or not name:
        raise argparse.ArgumentTypeError(
            f"--backend wants name=host:port, got {spec!r}")
    host, _, port = addr.rpartition(":")
    if not port:
        raise argparse.ArgumentTypeError(
            f"--backend {spec!r} carries no port")
    try:
        return name, (host or "127.0.0.1", int(port))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--backend {spec!r} port is not an integer")


def parse_quota(spec: str):
    """``tenant=sessions:8,pending:4,weight:3`` →
    ``(tenant, TenantQuota)``; omitted fields keep the unlimited/1.0
    defaults."""
    from .tenants import TenantQuota

    tenant, eq, body = spec.partition("=")
    if not eq or not tenant:
        raise argparse.ArgumentTypeError(
            f"--quota wants tenant=field:value[,...], got {spec!r}")
    fields = {"sessions": "max_sessions", "pending": "max_pending",
              "weight": "weight"}
    kw = {}
    for part in filter(None, body.split(",")):
        key, colon, val = part.partition(":")
        if not colon or key not in fields:
            raise argparse.ArgumentTypeError(
                f"--quota field {part!r} not in {sorted(fields)}")
        try:
            kw[fields[key]] = float(val) if key == "weight" else int(val)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"--quota {part!r} value is not numeric")
    try:
        return tenant, TenantQuota(**kw)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deap_tpu_torch.serve.router.cli",
        description="front N deap-tpu serving instances with placement, "
                    "health-driven failover and tenant enforcement "
                    "(clients use the unchanged RemoteService)")
    ap.add_argument("--listen", metavar="HOST:PORT", default="127.0.0.1:0",
                    help="router bind address (default loopback, "
                         "ephemeral port)")
    ap.add_argument("--backend", metavar="NAME=HOST:PORT",
                    type=parse_backend, action="append", required=True,
                    help="one serving instance to front (repeatable; "
                         "at least one)")
    ap.add_argument("--quota", metavar="TENANT=F:V[,F:V...]",
                    type=parse_quota, action="append", default=[],
                    help="per-tenant quota: fields sessions, pending, "
                         "weight (repeatable)")
    ap.add_argument("--max-inflight", type=int, default=16,
                    help="fleet-wide concurrent session-op forwards "
                         "shared weighted-fair across tenants")
    ap.add_argument("--probe-interval", type=float, default=2.0,
                    help="health poll period in seconds")
    ap.add_argument("--fail-after", type=int, default=2,
                    help="consecutive failed probes before failover")
    ap.add_argument("--drain-timeout", type=float, default=60.0,
                    help="seconds a sick instance gets to flush before "
                         "its sessions are declared lost")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-event router log lines")
    args = ap.parse_args(argv)

    from .core import FleetRouter
    from .health import HealthPolicy
    from .server import RouterServer

    names = [n for n, _ in args.backend]
    if len(set(names)) != len(names):
        ap.error(f"duplicate backend names in {names}")

    host, _, port = args.listen.rpartition(":")
    if not port:
        ap.error(f"--listen {args.listen!r} carries no port")
    router = FleetRouter(
        list(args.backend), quotas=dict(args.quota),
        max_inflight=args.max_inflight,
        health=HealthPolicy(interval_s=args.probe_interval,
                            fail_after=args.fail_after),
        drain_timeout=args.drain_timeout, verbose=not args.quiet)
    rc = 0
    with RouterServer(router, host=host or "127.0.0.1", port=int(port),
                      verbose=not args.quiet) as srv:
        print(f"[router] listening on {srv.url} fronting "
              f"{names} (ctrl-c to stop)")
        try:
            threading.Event().wait()      # serve until interrupted
        except KeyboardInterrupt:
            print("[router] shutting down", file=sys.stderr)
        topo = router.topology()
        rec = router.stats()
        if len(topo["sick"]) >= len(router.backends):
            rc = 1
    print(json.dumps({"mode": "router", "url": srv.url,
                      "topology": topo, "counters": rec.counters,
                      "rc": rc}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
