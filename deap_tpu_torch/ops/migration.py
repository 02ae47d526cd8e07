"""Island migration — the port's counterpart of ``deap_tpu/ops/migration.py``.

* :func:`mig_ring_stacked` — islands stacked on axis 0 of the genome's
  tensors: the exchange is index arithmetic on the device.  A cyclic
  destination mapping (the default ring included) is a ``torch.roll`` of
  the emigrants over the island axis, any other mapping a gather.
* :func:`mig_ring` — the reference signature over a list of
  :class:`~deap_tpu_torch.base.Population`.
* :func:`mig_ring_sharded` — :func:`mig_ring_stacked` when each rank of
  a mesh holds a contiguous block of the islands: the same keys and
  picks, each rank its own islands' emigrants, the cross-rank leg a
  ring exchange (``batch_isend_irecv``) for a cyclic map and one gather
  of the emigrants for any other.

JAX vmaps the selections over the islands; here they run one island at
a time with the same per-island keys, which draws the same numbers under
threefry keys.  (Under rbg keys jax's vmap draws every island's bits from
the first island's key, which such a loop does not follow.)
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .. import random
from ..base import Fitness, Population, _leaves, _map

__all__ = ["mig_ring_stacked", "mig_ring", "mig_ring_sharded"]


def _set_rows(leaf: torch.Tensor, idx: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``leaf[i, idx[i, j]] = values[i, j]`` on a copy, for every island
    ``i``; where one slot is named twice the later ``j`` wins (XLA's
    serial scatter on the CPU), on every device: each slot takes the row
    of its last writer, found by a max-scatter of the positions."""
    n_isl, pop = leaf.shape[:2]
    k = idx.shape[1]
    idx = idx.long()
    writer = torch.full((n_isl, pop), -1, dtype=torch.long,
                        device=leaf.device)
    pos = torch.arange(k, device=leaf.device).expand(n_isl, k)
    writer = writer.scatter_reduce(1, idx, pos, reduce="amax")
    hit = writer >= 0
    src = values.gather(1, writer.clamp(min=0).reshape(
        (n_isl, pop) + (1,) * (leaf.ndim - 2)).expand(
        (n_isl, pop) + leaf.shape[2:]))
    return torch.where(hit.reshape(hit.shape + (1,) * (leaf.ndim - 2)),
                       src, leaf)


def _ring_source(n_isl: int, migarray):
    """``(source, shift)``: the island whose emigrants reach each island,
    and the ring shift when the map is cyclic (else ``None``)."""
    if migarray is None:
        migarray = list(range(1, n_isl)) + [0]
    source = [0] * n_isl
    for frm, to in enumerate(migarray):
        source[to] = frm
    shift = (0 - source[0]) % n_isl
    cyclic = all(source[j] == (j - shift) % n_isl for j in range(n_isl))
    return source, (shift if cyclic else None)


def mig_ring_stacked(key, genomes, fitness_w, k, selection: Callable,
                     replacement: Callable | None = None,
                     migarray: Sequence[int] | None = None):
    """Ring migration over stacked islands.

    ``genomes``: a tensor or a tuple/dict of tensors with leading axes
    ``(n_islands, pop, ...)``; ``fitness_w``: ``(n_islands, pop, nobj)``
    weighted values.  ``selection(key, w, k)`` picks each island's
    emigrants (any selection of :mod:`deap_tpu_torch.ops.selection`).
    Emigrants of island ``i`` replace, in island ``migarray[i]``, that
    island's own emigrants (``replacement is None``, as the reference) or
    the individuals ``replacement`` picks.

    Returns the new genome and the ``(n_islands, k)`` replaced slots."""
    n_isl = fitness_w.shape[0]
    # source[j] = the island whose emigrants arrive at island j
    source, shift = _ring_source(n_isl, migarray)
    cyclic = shift is not None

    keys = random.split(key, 2 * n_isl).reshape(n_isl, 2, -1)
    emig_idx = torch.stack([selection(keys[i, 0], fitness_w[i], k)
                            for i in range(n_isl)])
    if replacement is None:
        repl_idx = emig_idx
    else:
        repl_idx = torch.stack([replacement(keys[i, 1], fitness_w[i], k)
                                for i in range(n_isl)])
    dev = _leaves(genomes)[0].device
    isl = torch.arange(n_isl, device=dev)[:, None]
    src = torch.tensor(source, device=dev)

    def exchange(leaf):
        emigrants = leaf[isl, emig_idx.long()]                 # (isl, k, ...)
        if cyclic:
            incoming = torch.roll(emigrants, shift, dims=0)
        else:
            incoming = emigrants[src]
        return _set_rows(leaf, repl_idx, incoming)

    return _map(exchange, genomes), repl_idx


def mig_ring(key, populations, k, selection, replacement=None,
             migarray=None):
    """Ring migration over a list of populations (reference ``migRing``).
    Replaced individuals keep the immigrants' fitness (they were
    evaluated on their home island)."""
    n_isl = len(populations)
    if migarray is None:
        migarray = list(range(1, n_isl)) + [0]
    keys = random.split(key, 2 * n_isl)
    emig_idx = [selection(keys[2 * i], populations[i].fitness, k)
                for i in range(n_isl)]
    if replacement is None:
        repl_idx = emig_idx
    else:
        repl_idx = [replacement(keys[2 * i + 1], populations[i].fitness, k)
                    for i in range(n_isl)]
    emigrants = [populations[i].take(emig_idx[i]) for i in range(n_isl)]
    out = list(populations)
    for frm, to in enumerate(migarray):
        dst, mig, idx = out[to], emigrants[frm], repl_idx[to][None]

        def put(g, v):
            return _set_rows(g[None], idx, v[None])[0]

        out[to] = Population(
            _map(put, dst.genome, mig.genome),
            Fitness(values=put(dst.fitness.values, mig.fitness.values),
                    valid=put(dst.fitness.valid, mig.fitness.valid),
                    weights=dst.fitness.weights))
    return out


def _incoming(emigrants: torch.Tensor, mesh, i0: int, L: int, source,
              shift) -> torch.Tensor:
    """The emigrants arriving at this rank's ``L`` islands (from island
    ``i0``), from every rank's ``(L, k, ...)`` emigrant block."""
    from ..parallel import collectives
    if shift is None:
        full = collectives.all_gather(emigrants, mesh)
        return full[torch.tensor(source[i0:i0 + L], device=full.device)]
    q, rem = divmod(shift, L)
    near = collectives.ring_shift(emigrants, mesh, q)
    if rem == 0:
        return near
    far = collectives.ring_shift(emigrants, mesh, q + 1)
    return torch.cat([far[L - rem:], near[:L - rem]], 0)


def mig_ring_sharded(key, genomes, fitness_w, k, selection: Callable, mesh,
                     n_islands: int, replacement: Callable | None = None,
                     migarray: Sequence[int] | None = None):
    """:func:`mig_ring_stacked` over islands spread across the ranks of
    ``mesh``: ``genomes`` and ``fitness_w`` hold this rank's ``L =
    n_islands / R`` islands, ``[rank L, (rank + 1) L)``.  Every rank calls
    it together.  Each island draws its picks from the same keys as in
    :func:`mig_ring_stacked`; a cyclic map (the default ring) moves the
    emigrants by ring exchanges, any other by one gather.  Returns this
    rank's new genome and its ``(L, k)`` replaced slots."""
    L = fitness_w.shape[0]
    i0 = mesh.rank * L
    source, shift = _ring_source(n_islands, migarray)
    keys = random.split(key, 2 * n_islands).reshape(n_islands, 2, -1)
    emig_idx = torch.stack([selection(keys[i0 + i, 0], fitness_w[i], k)
                            for i in range(L)])
    if replacement is None:
        repl_idx = emig_idx
    else:
        repl_idx = torch.stack([replacement(keys[i0 + i, 1], fitness_w[i], k)
                                for i in range(L)])
    isl = torch.arange(L, device=emig_idx.device)[:, None]

    def exchange(leaf):
        emigrants = leaf[isl, emig_idx.long()].contiguous()
        incoming = _incoming(emigrants, mesh, i0, L, source, shift)
        return _set_rows(leaf, repl_idx, incoming)

    return _map(exchange, genomes), repl_idx
