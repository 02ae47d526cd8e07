"""Bucket-histogram-aware session placement.

The expensive resource in this fleet is not CPU — it is **built
programs**: every ``(bucket rows, genome signature, toolbox)`` class a
backend serves costs it one program build per request kind, and a session
placed on an instance already serving its shape class rides warm
programs from the first step.  Placement therefore thinks in the same
vocabulary as :mod:`deap_tpu_torch.serve.buckets`.  It sees only shapes
and dtypes, never values, so the same create frame lands on the same
backend here as behind the JAX package's router:

* the router mirrors each backend's shape traffic in a
  :class:`~deap_tpu_torch.serve.buckets.ShapeHistogram` (every placement
  observes its row count) and remembers the backend's **warm set** —
  the ``(bucket rows, genome signature)`` classes it has already been
  sent;
* a new session's bucket is computed with the same
  :class:`~deap_tpu_torch.serve.buckets.BucketPolicy` arithmetic the instances
  use, so "sibling shapes" (distinct row counts sharing one padded
  bucket) genuinely co-locate;
* :func:`fleet_sizes` folds all backends' histograms through
  :func:`~deap_tpu_torch.serve.buckets.derive_sizes` — the fleet-wide learned
  grid an operator feeds back into per-instance ``rebucket`` calls.

Scoring (:meth:`PlacementPolicy.choose`) is warmth first, load second:
a warm backend wins unless its session count exceeds the fleet minimum
by more than ``spread`` — the knob trading compile savings against
hot-spotting everything onto one box.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..buckets import BucketPolicy, ShapeHistogram, derive_sizes

__all__ = ["BackendPlan", "PlacementPolicy", "fleet_sizes"]


class BackendPlan:
    """The router's model of one backend's placement state: observed
    shape histogram, warm ``(rows, genome signature)`` classes, and the
    live-session count.  Mutated only by the router under ITS routing
    lock — this object carries no lock of its own."""

    def __init__(self):
        self.histogram = ShapeHistogram()
        self.warm: set = set()
        self.sessions = 0

    def observe_placement(self, n: int, rows: int, sig: tuple) -> None:
        self.histogram.observe(n)
        self.warm.add((int(rows), sig))
        self.sessions += 1

    def forget_session(self) -> None:
        self.sessions = max(0, self.sessions - 1)


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Warmth-first placement with a load-spread guard.

    ``bucket_policy`` must mirror the instances' own policy (the bucket
    a session pads to is a function of the policy, and affinity keyed on
    the wrong grid would co-locate nothing).  ``spread`` is the maximum
    session-count lead a warm backend may hold over the least-loaded
    backend and still win placement; beyond it the cold backend takes
    the session (paying one compile to keep the fleet balanced)."""

    bucket_policy: BucketPolicy = dataclasses.field(
        default_factory=BucketPolicy)
    spread: int = 16

    def bucket_rows(self, n: int) -> int:
        return self.bucket_policy.rows_for(int(n))

    def choose(self, candidates: Sequence[Tuple[object, BackendPlan]],
               n: int, sig: tuple) -> Tuple[object, bool]:
        """Pick a backend for an ``n``-row session with genome signature
        ``sig`` from ``(backend, plan)`` candidates (already filtered to
        healthy instances holding the session's toolbox).  Returns
        ``(backend, warm)`` — ``warm`` says an existing program class
        was hit (the ``router_placements_warm`` counter's source)."""
        if not candidates:
            raise ValueError("no placement candidates")
        rows = self.bucket_rows(n)
        key = (rows, sig)
        floor = min(plan.sessions for _b, plan in candidates)
        warm = [(b, p) for b, p in candidates
                if key in p.warm and p.sessions - floor <= self.spread]
        pool = warm if warm else list(candidates)
        backend, _plan = min(pool, key=lambda bp: bp[1].sessions)
        return backend, bool(warm)


def fleet_sizes(plans: Iterable[BackendPlan], *, max_buckets: int = 8,
                min_rows: int = 8, round_to: int = 1
                ) -> Optional[Tuple[int, ...]]:
    """The fleet-wide learned bucket grid: merge every backend's observed
    shape histogram and fit :func:`~deap_tpu_torch.serve.buckets.derive_sizes`
    over the union (``None`` before any traffic).  Operators feed this
    into per-instance ``rebucket`` calls so the whole fleet converges on
    one grid — a prerequisite for cross-instance failover staying
    bitwise (restore re-buckets under the TARGET's policy)."""
    merged: Dict[int, int] = {}
    for plan in plans:
        for n, c in plan.histogram.counts().items():
            merged[n] = merged.get(n, 0) + c
    if not merged:
        return None
    return derive_sizes(merged, max_buckets=max_buckets, min_rows=min_rows,
                        round_to=round_to)
