"""Fleet control plane: the router tier above N serving instances
(``python -m deap_tpu_torch.serve.router.cli``).

One :class:`~deap_tpu_torch.serve.net.server.NetServer` is a single point
of capacity AND of failure.  This package fronts several, built purely
by *composing* primitives the instances already wire-expose
(drain/restore, redirects, ``/v1/metrics``, ``/v1/trace``, tenant
counters).  It is host code: it holds no tensor on any device, and its
backends may be the port's or the JAX package's instances, in any mix:

* :mod:`~deap_tpu_torch.serve.router.backend` — :class:`Backend`, the raw-frame
  forwarding + control-plane handle on one instance;
* :mod:`~deap_tpu_torch.serve.router.placement` — bucket-histogram-aware
  placement (:class:`PlacementPolicy`): sibling shapes co-locate on
  instances with warm compiled programs;
* :mod:`~deap_tpu_torch.serve.router.health` — :class:`HealthMonitor`: polls
  ``/v1/metrics``, joins ``/v1/trace`` spans, latches sick instances and
  fires automatic drain→restore failover;
* :mod:`~deap_tpu_torch.serve.router.tenants` — quota enforcement + weighted-
  fair forwarding (:class:`WeightedFairScheduler`), the typed
  :class:`TenantQuotaExceeded` admission decision;
* :mod:`~deap_tpu_torch.serve.router.core` — :class:`FleetRouter`, the routing
  table and the failover;
* :mod:`~deap_tpu_torch.serve.router.server` — :class:`RouterServer`, the DTF1
  HTTP frontend clients reach through an unchanged
  :class:`~deap_tpu_torch.serve.net.client.RemoteService`.

The CPU drill, held to the JAX package, lives in
``tests/test_torch_serve_router.py``.
"""

from .backend import Backend, BackendDown  # noqa: F401
from .core import FleetRouter  # noqa: F401
from .health import HealthMonitor, HealthPolicy, HealthSample  # noqa: F401
from .placement import (BackendPlan, PlacementPolicy,  # noqa: F401
                        fleet_sizes)
from .server import RouterServer  # noqa: F401
from .tenants import (TenantQuota, TenantQuotaExceeded,  # noqa: F401
                      WeightedFairScheduler)

__all__ = [
    "Backend", "BackendDown",
    "FleetRouter", "RouterServer",
    "HealthMonitor", "HealthPolicy", "HealthSample",
    "BackendPlan", "PlacementPolicy", "fleet_sizes",
    "TenantQuota", "TenantQuotaExceeded", "WeightedFairScheduler",
]
