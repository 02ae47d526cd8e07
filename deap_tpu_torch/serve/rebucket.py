"""Telemetry-driven automatic bucket-grid refits.

``EvolutionService.rebucket()`` refits the pad-and-bucket grid to
the observed :class:`~deap_tpu_torch.serve.buckets.ShapeHistogram` — but only
when an operator calls it.  :class:`RebucketPolicy` closes the ROADMAP's
control loop: it watches the same telemetry the operator would (histogram
drift since the grid was last fitted, the ``pad_waste`` gauge) and
triggers the refit itself, at the same quiesce point, with the same
zero-unplanned-build guarantee (``warm`` programs are built inside the
quiesce, so steady-state traffic after the fire never builds one —
held by ``tests/test_torch_serve.py``).

The policy runs on the dispatcher's worker thread (the ``after_batch``
hook — after a batch completes, outside the queue lock), which makes the
fire path trivially safe: the worker already owns all device dispatch,
and ``rebucket()``'s pause/resume is re-entrant from that position.

Stability knobs, because a control loop that thrashes is worse than an
operator who never calls it:

* **hysteresis** (``hold``) — the trigger condition must hold for
  ``hold`` consecutive ticks before a fire (one weird batch is noise);
* **cooldown** (``cooldown_s``) — a refit quiesces the fleet and spends
  compiles; never fire twice within the window;
* **no-op suppression** — before firing, the policy derives the grid it
  WOULD install; when that equals the current grid the fire is skipped
  and the baseline re-anchored (drift without a better grid is not
  actionable).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

__all__ = ["RebucketPolicy", "pad_waste_of"]


def pad_waste_of(service) -> float:
    """Fraction of padded rows that carry no live individual, over every
    live session: ``1 - sum(live) / sum(bucket rows)`` (0.0 with no
    sessions).  The gauge the policy watches — high waste means the grid
    no longer fits the traffic."""
    live = rows = 0
    for s in service.sessions().values():
        live += s.pop_size
        rows += s.bucket.rows
    return 0.0 if rows == 0 else 1.0 - live / rows


class RebucketPolicy:
    """Auto-trigger for :meth:`EvolutionService.rebucket` (see module
    docstring).  Install with :meth:`EvolutionService.set_rebucket_policy`
    (or the ``rebucket_policy=`` constructor argument); the service calls
    :meth:`tick` after every dispatched batch.

    Parameters
    ----------
    pad_waste_threshold:
        Fire only while :func:`pad_waste_of` is at or above this (default
        0.25: a quarter of every padded dispatch is dead rows).
    drift_threshold:
        Fire only while the normalized L1 distance between the current
        shape histogram and the one the grid was last fitted to is at or
        above this (0..1; 1.0 = disjoint traffic; a never-fitted policy
        treats any traffic as full drift).
    hold:
        Consecutive qualifying ticks required before a fire (hysteresis).
    cooldown_s:
        Minimum seconds between fires.
    max_buckets / warm:
        Forwarded to :meth:`EvolutionService.rebucket`.
    clock:
        Monotonic time source (injectable for tests).
    """

    def __init__(self, *, pad_waste_threshold: float = 0.25,
                 drift_threshold: float = 0.5, hold: int = 2,
                 cooldown_s: float = 60.0, max_buckets: int = 8,
                 warm: Sequence[str] = ("step",),
                 clock: Callable[[], float] = time.monotonic):
        if hold < 1:
            raise ValueError("hold must be >= 1")
        self.pad_waste_threshold = float(pad_waste_threshold)
        self.drift_threshold = float(drift_threshold)
        self.hold = int(hold)
        self.cooldown_s = float(cooldown_s)
        self.max_buckets = int(max_buckets)
        self.warm = tuple(warm)
        self.clock = clock
        self._fitted: Dict[int, int] = {}
        self._streak = 0
        self._last_fire: Optional[float] = None
        #: summary dict of the most recent fire (operator introspection)
        self.last_fire_info: Optional[dict] = None

    # -- telemetry terms -----------------------------------------------------

    def observe_baseline(self, service) -> None:
        """Anchor the drift baseline to the service's CURRENT histogram —
        called at install time, so drift measures change since the
        operator last knew the traffic, not since the service booted."""
        self._fitted = dict(service.shapes.counts())

    def drift(self, counts: Dict[int, int]) -> float:
        """Normalized L1 distance between ``counts`` and the histogram
        at the last (re)fit: ``0.5 * sum |p - q|`` over the union of
        observed sizes, in [0, 1]."""
        if not counts:
            return 0.0
        if not self._fitted:
            return 1.0
        tot_p = sum(counts.values())
        tot_q = sum(self._fitted.values())
        keys = set(counts) | set(self._fitted)
        return 0.5 * sum(abs(counts.get(k, 0) / tot_p
                             - self._fitted.get(k, 0) / tot_q)
                         for k in keys)

    # -- the control loop ----------------------------------------------------

    def tick(self, service) -> Optional[dict]:
        """One policy evaluation (called by the service after every
        batch).  Returns the :meth:`EvolutionService.rebucket` summary
        when this tick fired, else ``None``.  Always refreshes the
        ``pad_waste`` gauge so the term the policy watches is the one the
        operator sees on ``/v1/metrics``."""
        counts = service.shapes.counts()
        waste = pad_waste_of(service)
        service.metrics.set_gauge("pad_waste", waste)
        if not counts or not service.sessions():
            self._streak = 0
            return None
        if (self._last_fire is not None
                and self.clock() - self._last_fire < self.cooldown_s):
            return None
        if (waste < self.pad_waste_threshold
                or self.drift(counts) < self.drift_threshold):
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.hold:
            return None
        # no-op suppression: derive the grid this fire would install;
        # identical sizes mean the drift is not actionable — re-anchor
        preview = service.shapes.derive_policy(
            max_buckets=self.max_buckets,
            min_rows=service.policy.min_rows,
            max_rows=service.policy.max_rows)
        if tuple(preview.sizes) == tuple(service.policy.sizes):
            self._fitted = counts
            self._streak = 0
            return None
        info = service.rebucket(max_buckets=self.max_buckets,
                                warm=self.warm)
        service.metrics.inc("rebuckets_auto")
        self._fitted = counts
        self._streak = 0
        self._last_fire = self.clock()
        self.last_fire_info = info
        return info
