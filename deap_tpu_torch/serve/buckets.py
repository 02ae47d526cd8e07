"""Pad-and-bucket shape selection — how the service builds one program per
bucket and never another in steady state.

Every request the :class:`~deap_tpu_torch.serve.dispatcher.BatchDispatcher`
executes runs a program whose shapes come from a SMALL, FIXED set of
buckets, not from whatever population size a client happened to open.  A
session with ``pop=100`` rows is padded (zero rows appended, a ``live``
prefix mask carried as data) up to the enclosing bucket — by default the
next power of two — so every session whose genome structure matches shares
one program per request kind.  Steady-state build count == number of
distinct buckets in use; ``tests/test_torch_serve.py`` holds it via the
service's ``compiles`` counter.

The bucketing policy is deliberately asymmetric:

* the **population (row) axis pads** — a pad row is masked out of
  selection, variation, evaluation and counters by the ``live``-mask
  contract of :func:`deap_tpu_torch.algorithms.ea_step`, so padding is
  semantics-free;
* the **genome (dim) axis does not pad** — a zero-padded genome column
  would flow into the user's evaluate function and change the objective.
  Distinct trailing genome shapes therefore land in distinct buckets: the
  bucket key is effectively a ``(pop_bucket, dim)`` pair (generalized to a
  full genome signature for tuple and dict genomes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import sanitize
from ..base import Population, Fitness, _map

__all__ = ["BucketPolicy", "BucketKey", "BucketOverflow", "genome_signature",
           "pad_rows", "unpad_rows", "pad_population",
           "ShapeHistogram", "derive_sizes"]


class BucketOverflow(ValueError):
    """The requested row count exceeds the policy's largest bucket."""


def _structure(genome: Any):
    """Hashable container structure of a genome tree (a tensor, or nested
    tuples, lists and dicts of tensors): the counterpart of a treedef."""
    if isinstance(genome, dict):
        return ("dict", tuple((k, _structure(genome[k]))
                              for k in sorted(genome)))
    if isinstance(genome, (tuple, list)):
        return (type(genome).__name__,
                tuple(_structure(g) for g in genome))
    return "*"


def _dtype_name(x) -> str:
    """numpy's name of a leaf's dtype (``float32``, ``bool``,
    ``bfloat16``), for tensors and host arrays alike."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(x.dtype)


def genome_signature(genome: Any) -> tuple:
    """Hashable structural identity of a genome tree: its container
    structure plus each leaf's ``(dtype, trailing shape)``.  Two
    populations with equal signatures (and any row counts) can share
    bucket programs."""
    return (_structure(genome),
            tuple((_dtype_name(l), tuple(l.shape[1:]))
                  for l in _tree_leaves(genome)))


def _tree_leaves(genome) -> list:
    """The leaves of a genome tree whose leaves may be tensors or host
    arrays, in :func:`~deap_tpu_torch.base._leaves`' order."""
    if isinstance(genome, dict):
        return [x for k in sorted(genome) for x in _tree_leaves(genome[k])]
    if isinstance(genome, (tuple, list)):
        return [x for g in genome for x in _tree_leaves(g)]
    return [genome]


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """One program shape class: padded row count + genome
    signature + objective structure."""

    rows: int
    genome_sig: tuple
    nobj: int
    weights: tuple

    def describe(self) -> str:
        dims = "/".join("x".join(map(str, s)) or "scalar"
                        for _, s in self.genome_sig[1])
        return f"rows={self.rows} dim={dims} nobj={self.nobj}"


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Row-bucket selection.

    ``sizes`` — explicit ascending bucket grid; a request lands in the
    smallest listed size that fits.  Beyond the largest listed size:
    :class:`BucketOverflow` by default, or — with ``grow_beyond`` — fall
    back to doubling from the largest size (how adaptively derived grids
    stay open to tenants bigger than anything yet observed).  Empty
    ``sizes`` (default): next power of two, floored at ``min_rows``.
    ``max_rows``, when set, caps every path.
    """

    sizes: Tuple[int, ...] = ()
    min_rows: int = 8
    max_rows: Optional[int] = None
    grow_beyond: bool = False

    def __post_init__(self):
        if self.sizes and tuple(sorted(self.sizes)) != tuple(self.sizes):
            raise ValueError("BucketPolicy.sizes must be ascending")

    def rows_for(self, n: int) -> int:
        """Bucketed row count for ``n`` live rows."""
        if n < 1:
            raise ValueError("row count must be >= 1")
        if self.sizes:
            for s in self.sizes:
                if n <= s:
                    if self.max_rows is not None and s > self.max_rows:
                        raise BucketOverflow(
                            f"{n} rows lands in listed bucket {s} > "
                            f"max_rows={self.max_rows}")
                    return int(s)
            if not self.grow_beyond:
                raise BucketOverflow(
                    f"{n} rows exceeds the largest bucket {self.sizes[-1]}")
            rows = int(self.sizes[-1])
        else:
            rows = max(int(self.min_rows), 1)
        while rows < n:
            rows *= 2
        if self.max_rows is not None and rows > self.max_rows:
            raise BucketOverflow(
                f"{n} rows needs bucket {rows} > max_rows={self.max_rows}")
        return rows

    def bucket_for(self, population: Population) -> BucketKey:
        """Bucket of a (live, unpadded) population."""
        return BucketKey(rows=self.rows_for(population.size),
                         genome_sig=genome_signature(population.genome),
                         nobj=population.fitness.nobj,
                         weights=population.fitness.weights)


class ShapeHistogram:
    """Observed request-shape histogram: live row counts → occurrence
    counts.  The service records every admitted shape (session opens,
    restores, ad-hoc evaluate batches) here; at a quiesce point
    :meth:`derive_policy` turns the histogram into an *explicit* bucket
    grid fitted to the traffic actually seen, instead of the a-priori
    power-of-two grid.  Thread-safe (request threads write, rebucket
    reads)."""

    #: lock-guarded shared state (``lock-discipline`` lint +
    #: runtime sanitizer): request threads write, rebucket reads
    _GUARDED_BY = {"_lock": ("_counts",)}

    def __init__(self):
        self._lock = sanitize.lock()
        self._counts: Dict[int, int] = {}

    def observe(self, n: int, weight: int = 1) -> None:
        """Record ``weight`` requests of ``n`` live rows."""
        n = int(n)
        if n < 1:
            raise ValueError("row count must be >= 1")
        with self._lock:
            self._counts[n] = self._counts.get(n, 0) + int(weight)

    def counts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._counts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()

    def derive_policy(self, *, max_buckets: int = 8, min_rows: int = 8,
                      round_to: int = 1,
                      max_rows: Optional[int] = None) -> "BucketPolicy":
        """Fit an explicit :class:`BucketPolicy` grid to the histogram
        (see :func:`derive_sizes`).  Raises when nothing was observed —
        an empty histogram has no traffic to fit.  The derived policy is
        ``grow_beyond=True``: a tenant larger than anything yet observed
        doubles up from the largest learned size instead of being
        rejected (an observability-driven refit must never become an
        admission regression).  ``max_rows`` carries the operator's hard
        admission cap through the refit — a rebucket must never widen
        what the previous policy admitted."""
        sizes = derive_sizes(self.counts(), max_buckets=max_buckets,
                             min_rows=min_rows, round_to=round_to)
        return BucketPolicy(sizes=sizes, min_rows=min_rows,
                            max_rows=max_rows, grow_beyond=True)


def derive_sizes(counts: Dict[int, int], *, max_buckets: int = 8,
                 min_rows: int = 8, round_to: int = 1) -> Tuple[int, ...]:
    """Fit an ascending explicit bucket grid to an observed
    ``{rows: count}`` histogram.

    Every observed row count lands exactly on a grid size (rounded up to
    ``round_to`` and floored at ``min_rows``), then adjacent sizes are
    greedily coalesced until at most ``max_buckets`` remain — each merge
    removes the size whose traffic pays the least total padding by moving
    up to the next size (cost = count × row gap).  The result wastes the
    minimum pad rows this greedy can find while capping the number of
    programs per request kind at ``max_buckets``."""
    if not counts:
        raise ValueError("cannot derive a bucket grid from an empty "
                         "shape histogram")
    if max_buckets < 1:
        raise ValueError("max_buckets must be >= 1")
    if round_to < 1:
        raise ValueError("round_to must be >= 1")

    def snap(n: int) -> int:
        return max(int(min_rows), -(-int(n) // round_to) * round_to)

    weight: Dict[int, int] = {}
    for n, c in counts.items():
        s = snap(n)
        weight[s] = weight.get(s, 0) + int(c)
    sizes = sorted(weight)
    while len(sizes) > max_buckets:
        # merging sizes[i] into sizes[i+1] pads each of its rows' requests
        # up by the gap; drop the cheapest merge each round
        costs = [weight[sizes[i]] * (sizes[i + 1] - sizes[i])
                 for i in range(len(sizes) - 1)]
        i = costs.index(min(costs))
        weight[sizes[i + 1]] += weight.pop(sizes[i])
        del sizes[i]
    return tuple(sizes)


def pad_rows(tree: Any, rows: int):
    """Pad every leaf's leading axis to ``rows`` with zeros (appended, so
    the live rows form a PREFIX — the layout the ``live``-mask contract of
    :func:`deap_tpu_torch.algorithms.ea_step` requires).  Each leaf stays
    on its device; a leaf already ``rows`` long comes back as it is."""
    def pad(x):
        n = x.shape[0]
        if n == rows:
            return x
        if n > rows:
            raise ValueError(f"cannot pad {n} rows down to {rows}")
        out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:n] = x
        return out
    return _map(pad, tree)


def unpad_rows(tree: Any, n: int):
    """Strip pad rows: slice every leaf back to its first ``n`` rows."""
    return _map(lambda x: x[:n], tree)


def pad_population(population: Population, rows: int) -> Population:
    """Pad a population to ``rows``: genome and fitness values get zero
    rows, validity gets ``False`` (pad rows lose every masked comparison
    and are skipped by live-masked evaluation)."""
    return Population(
        genome=pad_rows(population.genome, rows),
        fitness=Fitness(values=pad_rows(population.fitness.values, rows),
                        valid=pad_rows(population.fitness.valid, rows),
                        weights=population.fitness.weights))
