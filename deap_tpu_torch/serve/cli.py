"""``python -m deap_tpu_torch.serve.cli`` — serve over the network, or demo
a session fleet.

Stand up an :class:`~deap_tpu_torch.serve.service.EvolutionService` on the
target device (``--device``, default the card) and either expose it over
HTTP (``--listen``) or drive a mixed-shape fleet of synthetic GA sessions
through it with a live stats view — then print one JSON summary line.

    python -m deap_tpu_torch.serve.cli                 # in-process demo fleet
    python -m deap_tpu_torch.serve.cli --listen 0.0.0.0:8077
    python -m deap_tpu_torch.serve.cli --sessions 8 --pops 100,256 \
        --dims 16,32 --ngen 50
    python -m deap_tpu_torch.serve.cli --compile-cache ~/.cache/kernels
    python -m deap_tpu_torch.serve.cli --smoke --device cpu   # CI smoke run

``--listen`` serves the demo toolbox registry (``demo`` — Rastrigin GA
with ``Quarantine("penalize")``) through
:class:`deap_tpu_torch.serve.net.NetServer` until interrupted; point
:class:`deap_tpu_torch.serve.net.RemoteService` (or the JAX package's, or
curl) at it.  ``--compile-cache DIR`` builds and loads the CUDA kernels
under ``DIR`` (:mod:`deap_tpu_torch.utils.compilecache`), so a restart
does not run ``nvcc`` again; on the card the service builds them when it
is constructed, before it listens, never inside a request.  ``--smoke``
exercises the full loopback network path — client → HTTP → service — and
reads its JSON report back over the ``/v1/metrics`` endpoint, so a smoke
pass certifies the wire stack, not just the in-process API.

Exit status is non-zero when any session fails or goes non-finite — a
smoke gate, not a benchmark.  Without a card, the default ``--device
cuda`` raises :class:`~deap_tpu_torch.NoCudaDevice`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..ops._dispatch import batched_op


def demo_rastrigin(x):
    """The demo's objective: rastrigin over a leading row axis in the
    float32 form XLA compiles the JAX demo's (and its served slot's)
    rastrigin to — each term ``fma(x, x, -(10 cos(2 pi x)))`` with XLA's
    cosine (``_xla_math.cos``), summed by ``_xla_math.row_sum`` — so the
    demo fleet is bitwise to the JAX package's at its widths 16 and 32,
    and the same bits on the card and the CPU.  (``benchmarks.rastrigin``
    is the plain ``torch.cos`` / ``torch.sum`` form: within 3 ulp.)"""
    from ..benchmarks import _f32, _rastrigin_terms
    from .._xla_math import row_sum
    return _f32(10.0 * x.shape[-1]) + row_sum(_rastrigin_terms(x)),


batched_op(demo_rastrigin, demo_rastrigin)


def _build_toolbox():
    from .. import base
    from ..ops import crossover, mutation, selection
    from ..resilience import Quarantine

    tb = base.Toolbox()
    tb.register("evaluate", demo_rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=0.3,
                indpb=0.1)
    tb.register("select", selection.sel_tournament, tournsize=3)
    tb.quarantine = Quarantine("penalize")
    return tb


def demo_population(seed: int, n: int, d: int):
    """``(key, population)`` of demo session ``seed``: the JAX demo's
    ``uniform(PRNGKey(seed), (n, d), float32, -5.12, 5.12)``, on the
    host (the service places it)."""
    import torch
    from .. import base, random

    key = random.PRNGKey(seed, device="cpu")
    genome = random.uniform(key, (n, d), torch.float32, -5.12, 5.12)
    return key, base.Population(
        genome=genome, fitness=base.Fitness.empty(n, (-1.0,), device="cpu"))


def _open_fleet(svc, tb, sessions, pops, dims, seed):
    fleet = []
    for i in range(sessions):
        n, d = pops[i % len(pops)], dims[i % len(dims)]
        key, pop = demo_population(seed + i, n, d)
        fleet.append(svc.open_session(key, pop, tb, cxpb=0.7, mutpb=0.3,
                                      name=f"demo-{i}"))
    return fleet


def _per_kind_quantiles(gauges) -> dict:
    """``{kind: (p50_ms, p99_ms)}`` parsed back out of the
    ``latency_<kind>_p*_ms`` gauges ServeMetrics already reports (the
    pooled ``latency_p*_ms`` keys are excluded)."""
    kinds = {}
    for key in gauges:
        if key.startswith("latency_") and key.endswith("_p50_ms"):
            kind = key[len("latency_"):-len("_p50_ms")]
            if kind:
                kinds[kind] = (gauges[key],
                               gauges.get(f"latency_{kind}_p99_ms", 0.0))
    return kinds


def _stat_line(rec, per_kind: bool = False) -> str:
    c, g = rec.counters, rec.gauges
    line = ("[serve] "
            f"batches={rec.gen} queue={g['queue_depth']:.0f} "
            f"slot_occ={g['slot_occupancy']:.2f} "
            f"compiles={c['compiles']} steps={c['steps']} "
            f"cache_hit={c['cache_hits']}/{c['cache_hits'] + c['cache_misses']} "
            f"p50={g.get('latency_p50_ms', 0.0):.1f}ms "
            f"p99={g.get('latency_p99_ms', 0.0):.1f}ms")
    if per_kind:
        for kind, (p50, p99) in sorted(_per_kind_quantiles(g).items()):
            line += f" {kind}[p50={p50:.1f}ms p99={p99:.1f}ms]"
    return line


def _run_listen(args) -> int:
    """``--listen host:port`` — expose the service over HTTP until
    interrupted."""
    import threading

    from .service import EvolutionService
    from .net import NetServer

    host, _, port = args.listen.rpartition(":")
    if not host:
        host, port = args.listen, "8077"
    tb = _build_toolbox()
    svc = EvolutionService(max_batch=args.max_batch, device=args.device)
    with NetServer(svc, {"demo": tb}, host=host, port=int(port),
                   verbose=True) as srv:
        print(f"[serve] listening on {srv.url} "
              f"(toolboxes: demo; ctrl-c to stop)")
        try:
            threading.Event().wait()          # serve until interrupted
        except KeyboardInterrupt:
            print("[serve] shutting down")
    svc.close()
    return 0


def _run_smoke_net(args) -> int:
    """``--smoke`` — drive a tiny fleet over the LOOPBACK NETWORK PATH
    (client → HTTP → service) and report from the /v1/metrics endpoint."""
    import numpy as np
    from .service import EvolutionService
    from .net import NetServer, RemoteService

    pops = [int(p) for p in args.pops.split(",")]
    dims = [int(d) for d in args.dims.split(",")]
    tb = _build_toolbox()
    t0 = time.perf_counter()
    failures = 0
    with EvolutionService(max_batch=args.max_batch,
                          device=args.device) as svc, \
            NetServer(svc, {"demo": tb}) as srv, \
            RemoteService(srv.url, timeout=300) as cli:
        fleet = []
        for i in range(args.sessions):
            n, d = pops[i % len(pops)], dims[i % len(dims)]
            key, pop = demo_population(args.seed + i, n, d)
            fleet.append(cli.open_session(key, pop, "demo", cxpb=0.7,
                                          mutpb=0.3, name=f"demo-{i}"))
        futures = [(s, s.step(args.ngen)) for s in fleet]
        for s, fs in futures:
            for f in fs:
                exc = f.exception(timeout=300)
                if exc is not None:
                    failures += 1
                    print(f"[serve] {s.name} step failed: {exc!r}",
                          file=sys.stderr)
        wall = time.perf_counter() - t0
        bests = []
        for s in fleet:
            p = s.population()
            bests.append(float(np.asarray(p.fitness.values[:, 0]).min()))
        # the JSON report travels over the metrics endpoint — the smoke
        # certifies the wire stack end to end
        rec = cli.stats()
        report = {
            "mode": "net-smoke", "url": srv.url,
            "device": str(svc.device),
            "sessions": args.sessions, "ngen": args.ngen,
            "pops": pops, "dims": dims, "wall_s": wall,
            "gens_per_sec": args.sessions * args.ngen / wall,
            "counters": rec.counters, "gauges": rec.gauges,
            "best_fitness": bests, "failures": failures,
        }
    print(json.dumps(report))
    if failures or not all(np.isfinite(bests)):
        print("FAILED: session failures or non-finite results",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deap_tpu_torch.serve.cli",
        description="serve an EvolutionService over HTTP (--listen) or "
                    "drive a mixed-shape session fleet with a live stats "
                    "view")
    ap.add_argument("--listen", metavar="HOST:PORT", default=None,
                    help="serve over HTTP instead of running the demo "
                         "fleet (deap_tpu_torch.serve.net.NetServer)")
    ap.add_argument("--device", default="cuda",
                    help="where session state lives and programs run "
                         "(default cuda: raises without a card; cpu to "
                         "serve on the host)")
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--pops", default="100,180",
                    help="comma-separated session population sizes")
    ap.add_argument("--dims", default="16,32",
                    help="comma-separated genome dims")
    ap.add_argument("--ngen", type=int, default=30)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--stats-every", type=int, default=10,
                    help="emit a live stats line every N dispatched batches")
    ap.add_argument("--per-kind", action="store_true",
                    help="append per-request-kind latency quantiles "
                         "(step/ask/tell/evaluate) to every stats line "
                         "instead of only the pooled p50/p99")
    ap.add_argument("--compile-cache", metavar="DIR", default=None,
                    help="build and load the CUDA kernels under DIR "
                         "(deap_tpu_torch.utils.compilecache)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed configuration for CI smoke tests, "
                         "driven over the loopback network path")
    args = ap.parse_args(argv)
    if args.smoke:
        args.sessions, args.pops, args.dims = 2, "12", "6"
        args.ngen, args.stats_every = 3, 2

    if args.compile_cache:
        from ..utils.compilecache import enable_compile_cache
        enable_compile_cache(args.compile_cache)

    if args.listen:
        return _run_listen(args)
    if args.smoke:
        return _run_smoke_net(args)

    import numpy as np
    from ..observability.sinks import StdoutSink
    from .service import EvolutionService

    pops = [int(p) for p in args.pops.split(",")]
    dims = [int(d) for d in args.dims.split(",")]
    tb = _build_toolbox()
    sink = StdoutSink()

    t0 = time.perf_counter()
    failures = 0
    with EvolutionService(max_batch=args.max_batch,
                          device=args.device) as svc:
        fleet = _open_fleet(svc, tb, args.sessions, pops, dims, args.seed)
        futures = {s.name: s.step(args.ngen) for s in fleet}
        last_line = 0
        outstanding = {n: list(fs) for n, fs in futures.items()}
        while outstanding:
            for name in list(outstanding):
                fs = outstanding[name]
                while fs and fs[0].done():
                    exc = fs.pop(0).exception()
                    if exc is not None:
                        failures += 1
                        print(f"[serve] {name} step failed: {exc!r}",
                              file=sys.stderr)
                if not fs:
                    del outstanding[name]
            rec = svc.stats()
            if args.stats_every and rec.gen - last_line >= args.stats_every:
                sink.write_text(_stat_line(rec, per_kind=args.per_kind))
                last_line = rec.gen
            if outstanding:
                next(iter(outstanding.values()))[0].exception(timeout=60)
        wall = time.perf_counter() - t0

        bests = []
        for s in fleet:
            p = s.population()
            bests.append(float(np.asarray(p.fitness.values[:, 0]).min()))
        rec = svc.stats()
        report = {
            "sessions": args.sessions, "ngen": args.ngen,
            "device": str(svc.device),
            "pops": pops, "dims": dims, "wall_s": wall,
            "gens_per_sec": args.sessions * args.ngen / wall,
            "counters": rec.counters, "gauges": rec.gauges,
            "best_fitness": bests, "failures": failures,
        }
    print(json.dumps(report))
    if failures or not all(np.isfinite(bests)):
        print("FAILED: session failures or non-finite results",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
