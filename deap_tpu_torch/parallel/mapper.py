"""Meshes and the population's row layout — the port's counterpart of
``deap_tpu/parallel/mapper.py``.

The JAX package is single-controller: one process holds a global array
that a ``jax.sharding.Mesh`` splits.  The port is SPMD: one process per
rank, each holding its own block of rows, and every rank of the group
calls the same function at the same time.  So a :class:`Mesh` here is
a ``torch.distributed`` process group, its axis name, its size, this
rank and this rank's ``torch.device``; a mesh of one rank is still a
process group.

Row layout (the counterpart of ``P(axis)``): a population of ``n`` rows
over ``R`` ranks with row quantum ``q`` gives each rank ``n_loc =
ceil(n / (R q)) q`` rows, rank ``r`` holding rows ``[r n_loc, min(n,
(r + 1) n_loc))`` (:func:`population_sharding`).  The pad rows a
sharded function adds to even the blocks out all fall at the end of
the global order, as in the JAX package.  ``q = 1`` is the JAX
package's ``ceil(n / D)``; the xla loops take ``q = 2`` (mating pairs
stay on one rank) and the sharded megakernel ``q = 32`` (its mating
quantum).

``tpu_map`` keeps its ``pad`` semantics: every rank passes the same
global batches, maps its rows, and gets the whole result back.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..base import Fitness, Population, _leaves, _map
from . import collectives

__all__ = ["Mesh", "RowSharding", "ShardedPopulation", "default_mesh",
           "population_sharding", "shard_population", "tpu_map",
           "pad_to_multiple", "check_axis", "DEFAULT_TIMEOUT_S"]

#: seconds a collective may wait before its process group gives up
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: a process group, its axis name, its size, this rank
    (in the group) and this rank's device.  ``backend`` is the group's
    (``"nccl"`` or ``"gloo"``)."""

    group: Any
    axis_name: str
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def transport(self) -> str:
        """``"nccl"``, ``"gloo"`` or ``"gloo, staged through host
        memory"`` (CUDA tensors under gloo)."""
        if collectives.staged(self):
            return "gloo, staged through host memory"
        return self.backend


def _local_rank() -> int:
    import os
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank()


def default_mesh(axis_name: str = "pop", device=None, *,
                 timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A 1-D mesh over every rank of the initialized process group, on a
    process group of its own (``dist.new_group`` over all ranks, with
    ``timeout``).  Every rank must call it.  ``device`` is this rank's:
    ``None`` means ``cuda:{local_rank % cards}`` (and raises without a
    card, as every entry point does); pass ``"cpu"`` to run on the host."""
    if not dist.is_initialized():
        raise RuntimeError("default_mesh needs an initialized process "
                           "group: call parallel.initialize_cluster() "
                           "(or torch.distributed.init_process_group) "
                           "first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    world = dist.get_world_size()
    group = dist.new_group(list(range(world)),
                           timeout=datetime.timedelta(seconds=timeout))
    return Mesh(group=group, axis_name=axis_name, size=world,
                rank=dist.get_rank(group), device=dev,
                backend=str(dist.get_backend(group)))


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Rank ``rank``'s rows ``[start, stop)`` of ``n``, in blocks of
    ``n_loc`` (``n_pad = n_loc * size`` rows with the pad)."""

    n: int
    n_loc: int
    size: int
    rank: int

    @property
    def start(self) -> int:
        return min(self.n, self.rank * self.n_loc)

    @property
    def stop(self) -> int:
        return min(self.n, (self.rank + 1) * self.n_loc)

    @property
    def rows(self) -> int:
        return self.stop - self.start

    @property
    def n_pad(self) -> int:
        return self.n_loc * self.size

    @property
    def row_base(self) -> int:
        """The global index of this rank's first row, pad included."""
        return self.rank * self.n_loc


def check_axis(mesh: Optional[Mesh], axis: Optional[str]) -> None:
    """The JAX functions name the mesh axis they shard over; the port's
    meshes have one.  ``None`` means that axis; another name than the
    mesh's is refused."""
    if axis is not None and mesh is not None and axis != mesh.axis_name:
        raise ValueError(f"axis {axis!r}: the mesh's one axis is "
                         f"{mesh.axis_name!r}")


def population_sharding(mesh: Mesh, n: int, quantum: int = 1,
                        axis_name: Optional[str] = None) -> RowSharding:
    """The row layout of an ``n``-row population over ``mesh`` (module
    docstring): the counterpart of ``NamedSharding(mesh, P(axis))``."""
    check_axis(mesh, axis_name)
    if quantum < 1:
        raise ValueError("quantum must be >= 1")
    unit = mesh.size * quantum
    n_loc = -(-int(n) // unit) * quantum
    return RowSharding(n=int(n), n_loc=n_loc, size=mesh.size, rank=mesh.rank)


@dataclasses.dataclass(frozen=True)
class ShardedPopulation(Population):
    """This rank's block of a population of ``n`` rows laid out over
    ``mesh`` with row quantum ``quantum``: ``genome`` and ``fitness``
    hold the rank's rows only."""

    mesh: Any = None
    n: int = 0
    quantum: int = 1

    @property
    def sharding(self) -> RowSharding:
        return population_sharding(self.mesh, self.n, self.quantum)

    def local(self) -> Population:
        return Population(self.genome, self.fitness)

    def with_local(self, local: Population) -> "ShardedPopulation":
        return ShardedPopulation(local.genome, local.fitness, self.mesh,
                                 self.n, self.quantum)


def _slice_rows(x: torch.Tensor, sh: RowSharding, device) -> torch.Tensor:
    return x[sh.start:sh.stop].to(device)


def shard_population(population: Population, mesh: Mesh,
                     axis_name: Optional[str] = None,
                     quantum: int = 1) -> ShardedPopulation:
    """This rank's rows of ``population`` (the same global population on
    every rank), on the mesh's device: the counterpart of placing it
    with a pop-axis sharding."""
    check_axis(mesh, axis_name)
    n = population.size
    sh = population_sharding(mesh, n, quantum)
    f = population.fitness
    return ShardedPopulation(
        _map(lambda x: _slice_rows(x, sh, mesh.device), population.genome),
        Fitness(values=_slice_rows(f.values, sh, mesh.device),
                valid=_slice_rows(f.valid, sh, mesh.device),
                weights=f.weights),
        mesh, n, quantum)


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``x`` with ``fill`` rows appended up to ``rows``."""
    pad = rows - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)], 0)


def pad_to_multiple(batch, multiple: int, fill=0):
    """Pad the leading axis of every leaf up to the next multiple of
    ``multiple`` (``fill`` rows appended) and return ``(padded, n)`` with
    ``n`` the original row count.  The appended rows exist only to make
    the leading axis divisible; the caller discards what a mapped
    function computes for them (slice back with ``[:n]``)."""
    if multiple < 1:
        raise ValueError("multiple must be >= 1")
    leaves = _leaves(batch)
    if not leaves:
        raise TypeError("pad_to_multiple needs at least one array leaf")
    n = leaves[0].shape[0]
    rows = -(-n // multiple) * multiple

    def one(x):
        x = torch.as_tensor(x)
        if x.shape[0] != n:
            raise ValueError(
                f"inconsistent leading axis: {x.shape[0]} vs {n}")
        return _pad_rows(x, rows, fill)
    return _map(one, batch), n


def _vmapped(fn: Callable):
    from ..algorithms import _batched_form
    batched = _batched_form(fn)
    if batched is not None:
        return batched
    return torch.func.vmap(fn)


def tpu_map(fn: Callable, *batches, mesh: Optional[Mesh] = None,
            axis_name: Optional[str] = None, pad: bool | int = True):
    """``toolbox.map`` replacement: apply a per-individual ``fn`` over
    stacked argument tensors (vmapped, or its batched form when it has
    one).  With a mesh, every rank passes the same global batches, maps
    its own block of rows, and the blocks are gathered back in rank
    order, so the result is the whole map on every rank.

    ``pad`` as in the JAX package: ``True`` (default) pads every batch to
    the next multiple of the mesh size with zero rows, maps, and slices
    the result back to the true row count — outputs for pad rows are
    discarded, never returned; an int pads to that multiple instead;
    ``False`` raises when the rows do not divide by the mesh size.
    Without a mesh, only an explicit int pads."""
    check_axis(mesh, axis_name)
    if not batches:
        raise TypeError(
            "tpu_map needs at least one batched argument; to register a "
            'mapper use toolbox.register("map", tpu_map, mesh=mesh)')
    multiple = 0
    if isinstance(pad, bool):
        if pad and mesh is not None:
            multiple = mesh.size
    else:
        multiple = int(pad)
    n = _leaves(batches[0])[0].shape[0]
    if multiple > 1:
        batches = tuple(pad_to_multiple(b, multiple)[0] for b in batches)
    rows = _leaves(batches[0])[0].shape[0]
    mapped = _vmapped(fn)
    if mesh is None:
        out = mapped(*batches)
        return _map(lambda x: x[:n], out) if rows != n else out
    if rows % mesh.size:
        raise ValueError(
            f"tpu_map: {rows} rows do not divide by the {mesh.size}-rank "
            "mesh (pad=False); pad=True pads them")
    n_loc = rows // mesh.size
    lo = mesh.rank * n_loc
    local = tuple(_map(lambda x: x[lo:lo + n_loc].to(mesh.device), b)
                  for b in batches)
    out = mapped(*local)
    out = _map(lambda x: collectives.all_gather(x, mesh), out)
    return _map(lambda x: x[:n], out) if rows != n else out
