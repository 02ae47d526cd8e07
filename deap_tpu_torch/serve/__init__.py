"""Serving layer of the port: many concurrent evolution runs multiplexed
onto one device as an async ask/tell service.

The reference frames ``toolbox.map`` as the entire distribution boundary
(doc/tutorials/basic/part4.rst); this package is the *other* half a
production deployment needs — the multi-tenant control plane in front of
the evolution step:

* :mod:`~deap_tpu_torch.serve.service` — :class:`EvolutionService` /
  :class:`Session`: the concurrent ask/tell/step/evaluate API;
* :mod:`~deap_tpu_torch.serve.dispatcher` — bounded request queue with
  backpressure, per-request deadlines, cancellation, retry-wrapped
  microbatch dispatch;
* :mod:`~deap_tpu_torch.serve.buckets` — pad-and-bucket shape selection, so
  the service builds one program per bucket and never rebuilds in
  steady state;
* :mod:`~deap_tpu_torch.serve.cache` — two-tier content-addressed fitness
  cache (device unique dedup within a batch + host LRU across
  sessions);
* :mod:`~deap_tpu_torch.serve.metrics` — host counters/gauges/latency
  quantiles, snapshotting into the observability sink layer;
* :mod:`~deap_tpu_torch.serve.cli` — ``python -m deap_tpu_torch.serve.cli``
  (``--listen`` network mode, ``--smoke``, demo fleet with a live stats
  view);
* :mod:`~deap_tpu_torch.serve.net` — the network frontend (imported explicitly,
  not re-exported here): stdlib HTTP server, binary JSON+tensor wire
  protocol, ``RemoteService``/``RemoteSession`` client, and the
  drain/restore surface behind cross-instance failover;
* :mod:`~deap_tpu_torch.serve.router` — the fleet router in front of
  several instances (placement, tenant quotas, health-driven failover),
  ``python -m deap_tpu_torch.serve.router.cli``;
* :mod:`~deap_tpu_torch.serve.top` — the fleet dashboard,
  ``python -m deap_tpu_torch.serve.top``.

Not ported yet (queue 1 item 11b (ii) of ROADMAP.md): autoscaling
(``serve/autoscale/``), the fitness-cache fabric, the fault-injecting
wire (``net/faultwire.py``) and pop-sharded sessions.
"""

from .buckets import (BucketPolicy, BucketKey, BucketOverflow,  # noqa: F401
                      genome_signature, pad_rows, unpad_rows,
                      pad_population, ShapeHistogram, derive_sizes)
from .cache import FitnessCache, row_digests, rep_indices  # noqa: F401
from .dispatcher import (BatchDispatcher, Request, ServeFuture,  # noqa: F401
                         ServeError, ServiceClosed, ServiceOverloaded,
                         DeadlineExceeded, RequestCancelled,
                         ServiceDraining, SessionUnknown)
from .metrics import (ServeMetrics, SERVE_COUNTERS, SERVE_GAUGES,  # noqa: F401
                      NET_COUNTERS, TENANT_COUNTERS, prometheus_text)
from .rebucket import RebucketPolicy, pad_waste_of  # noqa: F401
from .service import EvolutionService, Session, NEXT_SLICE  # noqa: F401

__all__ = [
    "EvolutionService", "Session",
    "BucketPolicy", "BucketKey", "BucketOverflow", "genome_signature",
    "pad_rows", "unpad_rows", "pad_population",
    "ShapeHistogram", "derive_sizes",
    "FitnessCache", "row_digests", "rep_indices",
    "BatchDispatcher", "Request", "ServeFuture",
    "ServeError", "ServiceClosed", "ServiceOverloaded", "DeadlineExceeded",
    "RequestCancelled", "ServiceDraining", "SessionUnknown",
    "ServeMetrics", "SERVE_COUNTERS", "SERVE_GAUGES", "NET_COUNTERS",
    "TENANT_COUNTERS", "prometheus_text",
    "RebucketPolicy", "pad_waste_of",
]
