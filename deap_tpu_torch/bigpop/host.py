"""Host-resident chunked population store.

A :class:`HostPopulation` keeps the genome matrix in host RAM as a list
of row chunks (CPU tensors) in the toolbox's *storage* dtype (an int8
genome occupies, and streams, a quarter of float32's bytes), while the
small per-row tensors (fitness values, validity) stay whole.  Only a few
genome *slices* are ever on the card at a time: the
:class:`~deap_tpu_torch.bigpop.engine.StreamedEngine` moves them
through a pinned staging ring, so the store itself is ordinary pageable
memory (pinning a store larger than the card's memory can fail or take
seconds).

The store is shared mutable state (a driver thread may read
:meth:`fitness_arrays` or :meth:`to_population` while the engine writes
a generation), so every access to the rows and the fitness happens
under one lock, as ``_GUARDED_BY`` declares.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .._device import resolve_device
from ..base import Fitness, Population
from ..ops.generation import GenomeStorage, storage_of

__all__ = ["HostPopulation", "DEFAULT_CHUNK_ROWS"]

#: default rows per host chunk: large enough that chunk crossings are
#: rare at default slice sizes, small enough that a chunk is an
#: allocator-friendly unit (25 MB of float32 genes at dim 100)
DEFAULT_CHUNK_ROWS = 1 << 16


def _host(x) -> torch.Tensor:
    """A CPU tensor that owns its memory (never a view of the caller's)."""
    x = torch.as_tensor(x)
    return x.detach().to("cpu", copy=True)


class HostPopulation:
    """Chunked host store of one population: genome rows in the storage
    dtype, fitness ``values`` ``(n, nobj)`` float32 and ``valid``
    ``(n,)`` bool whole.

    ``weights`` is the objective-weights tuple; ``storage`` the genome
    residency declaration (``None``: float32).  Row indices are in the
    one flat ``[0, size)`` space: chunking is a storage detail."""

    _GUARDED_BY = {"_lock": ("_chunks", "values", "valid")}

    def __init__(self, chunks, values, valid, weights: tuple, *,
                 storage: Optional[GenomeStorage] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        self._chunks = [c if torch.is_tensor(c) and c.device.type == "cpu"
                        else _host(c) for c in chunks]
        self.values = _host(values).to(torch.float32)
        self.valid = _host(valid).to(torch.bool)
        self.weights = tuple(weights)
        self.storage = storage or GenomeStorage()
        self.chunk_rows = int(chunk_rows)
        self._lock = threading.Lock()
        if any(len(c) != self.chunk_rows for c in self._chunks[:-1]):
            raise ValueError("all chunks but the last must hold exactly "
                             f"chunk_rows={self.chunk_rows} rows")
        if sum(len(c) for c in self._chunks) != len(self.values):
            raise ValueError("genome rows and fitness rows disagree")

    # -- construction --------------------------------------------------------

    @classmethod
    def from_population(cls, population: Population, toolbox=None, *,
                        storage: Optional[GenomeStorage] = None,
                        chunk_rows: int = DEFAULT_CHUNK_ROWS
                        ) -> "HostPopulation":
        """Copy a :class:`Population` (one 2-D genome tensor, already in
        its storage dtype) to the host."""
        g = population.genome
        if not torch.is_tensor(g) or g.ndim != 2:
            raise ValueError("HostPopulation needs a single 2-D tensor "
                             "genome (pop, dim)")
        if storage is None and toolbox is not None:
            storage = storage_of(toolbox)
        g = _host(g)
        return cls(list(g.split(chunk_rows)) or [g],
                   population.fitness.values, population.fitness.valid,
                   population.fitness.weights, storage=storage,
                   chunk_rows=chunk_rows)

    # -- introspection -------------------------------------------------------

    @property
    def size(self) -> int:
        with self._lock:
            return len(self.values)

    @property
    def dim(self) -> int:
        with self._lock:
            return self._chunks[0].shape[1]

    @property
    def genome_dtype(self) -> torch.dtype:
        with self._lock:
            return self._chunks[0].dtype

    @property
    def genome_nbytes(self) -> int:
        with self._lock:
            return sum(c.numel() * c.element_size() for c in self._chunks)

    def fitness_arrays(self):
        """Snapshot ``(values, valid)``: the fitness table the streamed
        selection plan takes to the device."""
        with self._lock:
            return self.values.clone(), self.valid.clone()

    # -- row access ----------------------------------------------------------

    def rows(self, lo: int, hi: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Contiguous genome rows ``[lo, hi)``: a copy, into ``out`` when
        given (a staging buffer of ``hi - lo`` rows)."""
        with self._lock:
            if out is None:
                out = torch.empty((hi - lo, self._chunks[0].shape[1]),
                                  dtype=self._chunks[0].dtype)
            if hi <= lo:
                return out
            R = self.chunk_rows
            for c in range(lo // R, (hi - 1) // R + 1):
                a = max(lo, c * R)
                b = min(hi, c * R + len(self._chunks[c]))
                out[a - lo:b - lo].copy_(self._chunks[c][a - c * R:b - c * R])
            return out

    def gather(self, idx, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Genome rows at ``idx`` (any order, repeats allowed): the host
        half of the streamed parent gather, into ``out`` when given."""
        idx = torch.as_tensor(idx, dtype=torch.int64)
        with self._lock:
            if len(self._chunks) == 1:
                return torch.index_select(self._chunks[0], 0, idx, out=out)
            if out is None:
                # the lock is held: shape and dtype straight off a chunk,
                # not through the self-locking properties
                out = torch.empty((len(idx), self._chunks[0].shape[1]),
                                  dtype=self._chunks[0].dtype)
            R = self.chunk_rows
            cid = idx // R
            for c in torch.unique(cid).tolist():
                at = torch.nonzero(cid == c).flatten()
                out.index_copy_(0, at, self._chunks[c].index_select(
                    0, idx[at] - c * R))
            return out

    # -- mutation (engine / driver only) -------------------------------------

    def set_rows(self, lo: int, rows: torch.Tensor) -> None:
        """Overwrite genome rows ``[lo, lo + len(rows))``."""
        rows = torch.as_tensor(rows)
        with self._lock:
            R = self.chunk_rows
            off = 0
            while off < len(rows):
                c = (lo + off) // R
                a = (lo + off) - c * R
                n = min(len(self._chunks[c]) - a, len(rows) - off)
                self._chunks[c][a:a + n].copy_(rows[off:off + n])
                off += n

    def set_fitness(self, values, valid) -> None:
        values = _host(values).to(torch.float32)
        valid = _host(valid).to(torch.bool)
        with self._lock:
            self.values, self.valid = values, valid

    def swap_genome(self, chunks) -> None:
        """Adopt a fully built next-generation chunk list (the engine's
        double-buffered child store)."""
        chunks = [c if torch.is_tensor(c) and c.device.type == "cpu"
                  else _host(c) for c in chunks]
        if sum(len(c) for c in chunks) != self.size:
            raise ValueError("replacement chunk list has wrong row count")
        with self._lock:
            self._chunks = chunks

    def clone_chunks(self):
        """Deep copy of the genome chunk list (checkpoint snapshots)."""
        with self._lock:
            return [c.clone() for c in self._chunks]

    # -- materialization -----------------------------------------------------

    def to_population(self, device=None) -> Population:
        """The whole store as a :class:`Population` on ``device`` (default
        ``"cuda"``; raises without a card unless ``device="cpu"``).  This
        is the O(pop) residency the engine otherwise avoids: for tests,
        statistics and interop."""
        dev = resolve_device(device)
        with self._lock:
            g = torch.cat(self._chunks, 0) if len(self._chunks) > 1 \
                else self._chunks[0].clone()
            return Population(
                g.to(dev),
                Fitness(values=self.values.to(dev, copy=True),
                        valid=self.valid.to(dev, copy=True),
                        weights=self.weights))
