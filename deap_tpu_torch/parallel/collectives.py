"""The collectives every sharded path of the port uses, on a
:class:`~deap_tpu_torch.parallel.mapper.Mesh`'s process group.

They stand in for the JAX package's in-program collectives:

* :func:`all_gather` — ``lax.all_gather(tiled=True)``: one gather of
  equal blocks, concatenated in rank order;
* :func:`gather_sum` — ``lax.psum``: the per-rank values gathered and
  summed in rank order on every rank.  NCCL's all-reduce order is not
  fixed, so an all-reduce would not give one bit pattern everywhere;
* :func:`ring_shift` — ``ppermute`` on a ring: ``batch_isend_irecv``;
* :func:`barrier` — a gather of one word (NCCL's ``barrier`` needs a
  device id; this needs nothing).

Transport is chosen by the group's backend, never by trying one and
catching a failure: under NCCL the tensors stay on the card; under gloo
a CUDA tensor is staged through pinned host memory (gloo's CUDA support
covers ``broadcast`` and ``all_reduce`` only), and a CPU tensor goes as
it is.  A bool tensor travels as uint8.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "gather_sum", "ring_shift", "barrier",
           "broadcast_int", "staged"]


def staged(mesh) -> bool:
    """Does this mesh stage CUDA tensors through host memory?"""
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def _to_wire(x: torch.Tensor, mesh) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if x.is_cuda and mesh.backend == "gloo":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_cuda and not x.is_cuda:
        x = x.to(like.device, non_blocking=False)
    if like.dtype == torch.bool:
        x = x.view(torch.bool)
    return x


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0 in
    rank order, on every rank, on ``x``'s device."""
    wire = _to_wire(x, mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return _from_wire(torch.cat(parts, 0), x)


def gather_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``x``, added in rank order on every rank:
    the same bits everywhere, whatever the transport."""
    parts = all_gather(x.reshape((1,) + tuple(x.shape)), mesh)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def ring_shift(x: torch.Tensor, mesh, shift: int = 1) -> torch.Tensor:
    """``x`` of rank ``r - shift`` (mod the mesh size), received while
    this rank's ``x`` goes to rank ``r + shift``: one
    ``batch_isend_irecv`` pair.  A shift that is a multiple of the mesh
    size returns a copy."""
    size = mesh.size
    shift %= size
    if shift == 0:
        return x.clone()
    wire = _to_wire(x, mesh)
    buf = torch.empty_like(wire)
    dst = dist.get_global_rank(mesh.group, (mesh.rank + shift) % size)
    src = dist.get_global_rank(mesh.group, (mesh.rank - shift) % size)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, dst, group=mesh.group),
        dist.P2POp(dist.irecv, buf, src, group=mesh.group)])
    for req in reqs:
        req.wait()
    return _from_wire(buf, x)


def broadcast_int(value: int, mesh) -> int:
    """Rank 0's ``value`` on every rank."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    return int(all_gather(t, mesh)[0].item())


def barrier(mesh) -> None:
    """Return once every rank of the mesh has called it."""
    all_gather(torch.zeros((1,), dtype=torch.int32, device=mesh.device),
               mesh)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
