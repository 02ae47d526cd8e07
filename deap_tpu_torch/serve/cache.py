"""Two-tier content-addressed fitness cache.

Tier 1 (device, within a batch): :func:`rep_indices` — a unique over
the raw genome bits maps every row of an evaluation microbatch to the
batch index of its group leader; gathering
evaluated values through that map makes identical genomes return
**bitwise-identical** fitness inside one dispatch even for a
non-deterministic evaluator, and the unique count feeds the ``dedup_rows``
counter.

Tier 2 (host, across batches/sessions): :class:`FitnessCache` — an LRU of
``blake2b(genome row bytes)`` → fitness values, namespaced by evaluator
identity (two sessions sharing an evaluator share entries; different
objectives never collide).  Hits are spliced over the device results, so a
genome evaluated once returns the same bits forever after, from any
session.  **Non-finite values are never inserted** — a quarantined (NaN)
evaluation must be re-attempted, not immortalized (pinned by
``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import collections
import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import sanitize
from ..base import _leaves

__all__ = ["FitnessCache", "row_digests", "rep_indices", "flatten_rows"]


def flatten_rows(genome) -> torch.Tensor:
    """Concatenate a genome tree into one ``(rows, flat_dim)`` tensor
    (the content view both cache tiers hash/compare), on the genome's
    device; mixed leaf dtypes promote as ``jnp.concatenate`` does."""
    leaves = _leaves(genome)
    return torch.cat([l.reshape(l.shape[0], -1) for l in leaves], dim=1)


def _host_rows(rows):
    """``(array, dtype token)`` of host rows: a numpy array, or a tensor
    copied to the host (bfloat16 as its 16-bit pattern, whose numpy
    ``dtype.str`` — ``ml_dtypes``' — is ``<V2``)."""
    if isinstance(rows, torch.Tensor):
        t = rows.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "<V2"
        a = t.numpy()
        return a, a.dtype.str
    a = np.asarray(rows)
    return a, a.dtype.str


def row_digests(rows) -> List[bytes]:
    """Content digest per row: blake2b over the raw row bytes, salted with
    dtype + row shape so equal bytes of different types never collide.
    The salt is numpy's ``dtype.str`` (``<f4``, ``|b1``, ``<V2`` for
    bfloat16) and the bytes little-endian, so a row digests the same here
    and in the JAX package."""
    rows, token = _host_rows(rows)
    rows = np.ascontiguousarray(rows)
    salt = f"{token}:{rows.shape[1:]}".encode()
    return [hashlib.blake2b(salt + r.tobytes(), digest_size=16).digest()
            for r in rows]


def _bit_view(flat: torch.Tensor) -> torch.Tensor:
    """Exact-equality integer view of the rows (floats compared by bit
    pattern, so grouping never hits NaN != NaN semantics)."""
    if flat.dtype == torch.float32:
        return flat.view(torch.int32)
    if flat.dtype in (torch.float16, torch.bfloat16):
        return flat.view(torch.int16)
    if flat.dtype == torch.bool:
        return flat.to(torch.uint8)
    if not flat.is_floating_point() and not flat.is_complex():
        return flat
    raise TypeError(f"no exact bit view for dtype {flat.dtype}")


def rep_indices(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side within-batch dedup: for ``(rows, flat_dim)`` genome
    content, return ``(rep, n_unique)`` where ``rep[i]`` is the batch index
    of the first row whose content equals row ``i`` (its group *leader*),
    and ``n_unique`` counts distinct rows (int32 tensors on ``flat``'s
    device, as the JAX package's).

    ``values[rep]`` then assigns every duplicate its leader's evaluated
    value — bitwise equality of identical genomes by construction."""
    b = _bit_view(flat)
    rows = b.shape[0]
    uniq, inverse = torch.unique(b, dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), rows, dtype=torch.int64,
                       device=b.device).scatter_reduce(
        0, inverse, torch.arange(rows, device=b.device), "amin")
    rep = first[inverse].to(torch.int32)
    return rep, torch.tensor(uniq.shape[0], dtype=torch.int32,
                             device=b.device)


class FitnessCache:
    """Host LRU of genome-content digests → fitness values.

    ``capacity`` bounds the entry count (least-recently-used eviction,
    counted in ``cache_evictions``).  Keys are ``(namespace, digest)`` —
    the service namespaces by evaluator identity + genome signature +
    objective count, so only sessions that share an evaluator share
    entries.  Values are defensive copies of ``(nobj,)`` float arrays.
    Thread-safe (the dispatcher thread writes; stats readers poll)."""

    #: lock-guarded shared state: the LRU map is written by the
    #: dispatcher thread and read by any client/stats thread — every
    #: mutation must hold ``self._lock``
    _GUARDED_BY = {"_lock": ("_entries",)}

    def __init__(self, capacity: int = 4096, metrics=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._metrics = metrics
        self._lock = sanitize.lock()
        self._entries: "collections.OrderedDict[tuple, np.ndarray]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _inc(self, name: str, v: int = 1) -> None:
        if self._metrics is not None and v:
            self._metrics.inc(name, v)

    def lookup(self, namespace, digests: List[bytes]
               ) -> List[Optional[np.ndarray]]:
        """Per-digest hit values (``None`` on miss); hits are refreshed to
        most-recently-used and counted."""
        out: List[Optional[np.ndarray]] = []
        hits = misses = 0
        with self._lock:
            for d in digests:
                k = (namespace, d)
                v = self._entries.get(k)
                if v is None:
                    misses += 1
                else:
                    hits += 1
                    self._entries.move_to_end(k)
                out.append(v)
        self._inc("cache_hits", hits)
        self._inc("cache_misses", misses)
        return out

    def insert(self, namespace, digests: List[bytes],
               values: np.ndarray) -> int:
        """Insert ``digest[i] -> values[i]`` for every FINITE row; NaN/Inf
        rows are skipped (and counted as ``cache_nan_skipped``) — a
        quarantined evaluation is never content-addressable.  Returns the
        number of rows inserted."""
        values = np.asarray(values)
        inserted = skipped = evicted = 0
        with self._lock:
            for d, v in zip(digests, values):
                if not np.all(np.isfinite(v)):
                    skipped += 1
                    continue
                k = (namespace, d)
                if k in self._entries:
                    self._entries.move_to_end(k)
                    continue
                self._entries[k] = np.array(v, copy=True)
                inserted += 1
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    evicted += 1
        self._inc("cache_nan_skipped", skipped)
        self._inc("cache_evictions", evicted)
        return inserted

    def contains(self, namespace, digest: bytes) -> bool:
        with self._lock:
            return (namespace, digest) in self._entries

    def purge_namespace(self, evaluator_id: int) -> int:
        """Drop every entry whose namespace belongs to ``evaluator_id``
        (the leading element of the service's ``(evaluator_id, sig, nobj)``
        namespace tuples).  The service calls this when an evaluator's pin
        refcount hits zero: ``id()`` values recycle, so a later evaluator
        allocated at the same address must never inherit the dead one's
        cached fitness.  Returns the number of entries purged (also counted
        as ``cache_purged``)."""
        with self._lock:
            stale = [k for k in self._entries
                     if isinstance(k[0], tuple) and k[0]
                     and k[0][0] == evaluator_id]
            for k in stale:
                del self._entries[k]
        self._inc("cache_purged", len(stale))
        return len(stale)

    def hit_rate(self) -> float:
        """Lifetime hit fraction (0.0 when nothing was looked up)."""
        if self._metrics is None:
            return 0.0
        h = self._metrics.counter("cache_hits")
        m = self._metrics.counter("cache_misses")
        return h / (h + m) if h + m else 0.0
