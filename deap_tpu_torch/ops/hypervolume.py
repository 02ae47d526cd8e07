"""Device-native blocked hypervolume — the PyTorch counterpart of
``deap_tpu/ops/hypervolume.py``.

Algorithm (``d == 3``, implicit minimization, reference point ``ref``):
the dimension sweep sliced along the third objective.  Sort the clipped
points by ``z``; the dominated volume is

    HV = sum_k (z_{k+1} - z_k) * A_k,         z_{n+1} = ref_z,

where ``A_k`` is the 2-D staircase area (with respect to ``(ref_x,
ref_y)``) of the first ``k`` points.  Every prefix area is one masked
running minimum over the x-sorted view — points outside the prefix mask
to ``+inf`` and contribute no height.  Clipping to ``ref`` subsumes the
strict-dominance filter of the host tier exactly: a point at or beyond
``ref`` on any axis contributes zero width, height or depth to every
strip it touches.

* :func:`hypervolume_3d` is the plain PyTorch version: the prefixes in
  ``block``-sized slabs, one ``(block, n)`` masked ``cummin`` and strip
  sum per slab.  It serves CPU tensors and the tests, and is what
  ``chip_smoke.py`` holds the kernel against; nothing on a card path
  calls it.
* :func:`hypervolume_3d_cuda` is K5's entry: torch does the two sorts,
  the CUDA kernel (``deap_tpu_torch/kernels/hypervolume.cu``, replacing
  ``_hv3d_pallas_call``) the O(n²) sweep, one launch per hypervolume.
  It computes in the input dtype, float32 or float64.  The running
  minima are exact; the sums are taken in another order than the plain
  version's, so the two agree to rounding (float32: relative 1e-4 at
  n = 10⁵ is the stated bound, float64: 1e-11), not bit for bit.
* :func:`hypervolume_device` routes 2 or 3 objectives by the points'
  device; :func:`hypervolume` is the per-dimension router behind the
  default ``toolbox.hypervolume`` slot.

``d == 2`` reuses the closed-form staircase
(:func:`deap_tpu_torch.ops.hv.hypervolume_2d`); ``d >= 4`` stays on the
host (:func:`deap_tpu_torch.ops.hv.hypervolume`).
:func:`hypervolume_sharded` is the mesh-sharded form: one gather of the
points, each rank sweeping its own contiguous range of prefix slabs (K5
at a first-prefix offset on the card), the partial volumes added in rank
order.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..base import _sort_key
from .hv import hypervolume as hypervolume_host, hypervolume_2d

__all__ = ["hypervolume_3d", "hypervolume_3d_cuda", "hypervolume_device",
           "hypervolume_sharded", "hypervolume"]


def _as_points(points, ref):
    """``(pts, ref)`` as tensors of the points' floating dtype (float32
    for integers) on the points' device, the points clipped to ``ref``."""
    pts = torch.as_tensor(points)
    if not pts.is_floating_point():
        pts = pts.to(torch.float32)
    ref = torch.as_tensor(ref, dtype=pts.dtype, device=pts.device)
    return torch.minimum(pts, ref), ref


def _hv3d_prep(pts: torch.Tensor, ref: torch.Tensor):
    """Shared sweep precomputation on the clipped point set: z-sorted
    strip depths and the x-sorted staircase view.  Returns ``(xs, ys,
    zr, dz, width)`` where ``zr[j]`` is the z-rank of the point at
    x-position ``j`` (x-position ``j`` belongs to prefix ``k`` iff
    ``zr[j] < k``) and ``width[j]`` is the strip ``x_{j+1} - x_j`` (the
    last strip runs to ``ref_x``).  Both sorts are stable."""
    p = pts[torch.argsort(_sort_key(pts[:, 2]), stable=True)]   # z-ascending
    z = p[:, 2]
    dz = torch.cat([z[1:], ref[2:3]]) - z             # (n,) >= 0
    xord = torch.argsort(_sort_key(p[:, 0]), stable=True)  # x-ascending view
    xs = p[xord, 0]
    ys = p[xord, 1]
    zr = xord.to(torch.int32)                         # z-rank per x-slot
    width = torch.cat([xs[1:], ref[0:1]]) - xs        # (n,) >= 0
    return xs, ys, zr, dz, width


def _prefix_areas(ys, zr, width, ref_y, k0: int, blk: int) -> torch.Tensor:
    """2-D staircase areas ``A_k`` of the ``blk`` prefixes ``k = k0+1 ..
    k0+blk``: one masked inclusive running minimum over the x-sorted
    heights per prefix, then the strip sum.  ``(blk, n)``
    intermediates."""
    ks = k0 + 1 + torch.arange(blk, dtype=torch.int32, device=ys.device)
    masked = torch.where(zr[None, :] < ks[:, None], ys[None, :],
                         float("inf"))
    ymin = torch.cummin(masked, dim=1).values
    h = torch.clamp(ref_y - ymin, min=0.0)
    return torch.sum(h * width[None, :], dim=1)       # (blk,)


def _slab_volumes(points, ref, block: int = 128, k_begin: int = 0,
                  count=None) -> torch.Tensor:
    """The plain sweep's partial volume of every slab of ``block``
    prefixes, ``sum_k A_k * dz_k`` over the slab, for the prefixes
    ``k_begin < k <= k_begin + count`` (default: all ``n``; prefixes past
    ``n`` add nothing): ``(ceil(count / block),)``.  K5 writes the same
    partials, one per thread block.  Ranges that start on slab
    boundaries give the whole sweep's slabs, bit for bit."""
    pts, ref = _as_points(points, ref)
    n = pts.shape[0]
    _, ys, zr, dz, width = _hv3d_prep(pts, ref)
    blk = min(block, n)
    count = n - k_begin if count is None else int(count)
    nb = -(-count // blk)
    k_end = k_begin + nb * blk
    dz_pad = torch.cat([dz, dz.new_zeros(max(0, k_end - n))])  # k > n
    dz_rng = dz_pad[k_begin:k_end].clone()
    dz_rng[count:] = 0                      # past the range: another's
    return torch.stack([
        torch.sum(_prefix_areas(ys, zr, width, ref[1], k_begin + b * blk,
                                blk) * dz_rng[b * blk:(b + 1) * blk])
        for b in range(nb)])


def hypervolume_3d(points, ref, block: int = 128) -> torch.Tensor:
    """Exact 3-D hypervolume, the plain PyTorch version: the blocked
    prefix-staircase sweep, O(n²/block) slabs of ``(block, n)`` work, in
    the points' dtype on the points' device, the slabs' volumes added in
    slab order.  Points at or beyond ``ref`` contribute exactly their
    clipped part."""
    parts = _slab_volumes(points, ref, block)
    acc = parts.new_zeros(())
    for p in parts.unbind():
        acc = acc + p
    return acc


def hypervolume_3d_cuda(points, ref, block: int = 128) -> torch.Tensor:
    """Exact 3-D hypervolume of CUDA points through K5: torch sorts
    twice, the kernel sweeps the n² pairs with ``block`` prefixes per
    thread block (rounded up to a warp multiple) and writes one partial
    volume per block, and ``torch.sum`` adds the partials.  float32 or
    float64, as the points are.  Raises on CPU points: the plain
    version is :func:`hypervolume_3d`."""
    ref_in = ref
    pts, ref = _as_points(points, ref)
    if not pts.is_cuda:
        raise ValueError(f"hypervolume_3d_cuda needs CUDA points (got "
                         f"{pts.device}); hypervolume_3d is the plain version")
    if pts.shape[0] == 0:
        return pts.new_zeros(())
    # the kernel's scalar comes from the caller's ref: no device read
    # when that lives on the host
    ref_y = float(torch.as_tensor(ref_in, dtype=pts.dtype).reshape(-1)[1])
    return torch.sum(_hv3d_cuda_partials(pts, ref, ref_y, block))


def _hv3d_cuda_partials(pts, ref, ref_y: float, block: int,
                        k_begin: int = 0, count=None) -> torch.Tensor:
    """K5's launch on clipped CUDA points: one partial volume per block
    of ``block`` prefixes (rounded up to a warp multiple) of the
    prefixes ``k_begin < k <= k_begin + count`` (default all)."""
    _, ys, zr, dz, width = _hv3d_prep(pts, ref)
    from .. import kernels
    threads = min(1024, max(32, -(-int(block) // 32) * 32))
    return kernels.launch_hv3d_sweep(
        ys.contiguous(), zr.contiguous(), width.contiguous(),
        dz.contiguous(), ref_y, threads=threads, k_begin=k_begin,
        count=count)


def hypervolume_device(points, ref, block: int = 128) -> torch.Tensor:
    """Device hypervolume for 2 or 3 objectives, on the points' device
    and in their dtype: the closed-form staircase at ``d == 2``; at
    ``d == 3`` K5 for CUDA points and the plain sweep for CPU points.
    ``d >= 4`` has no device form — use :func:`hypervolume`."""
    pts = torch.as_tensor(points)
    d = pts.shape[-1]
    if d == 2:
        if not pts.is_floating_point():
            pts = pts.to(torch.float32)
        return hypervolume_2d(pts, ref)
    if d == 3:
        if pts.is_cuda:
            return hypervolume_3d_cuda(pts, ref, block=block)
        return hypervolume_3d(pts, ref, block=block)
    raise ValueError(
        f"hypervolume_device supports 2 or 3 objectives, got {d}; use "
        "deap_tpu_torch.ops.hypervolume.hypervolume (host WFG) for d >= 4")


def hypervolume_sharded(points, ref, mesh, axis: str | None = None,
                        block: int = 128, *, n=None, quantum: int = 1):
    """Mesh-sharded exact hypervolume.  ``points`` is this rank's block of
    rows (the layout of :func:`deap_tpu_torch.parallel.
    population_sharding` for ``n`` rows, default the block's rows times
    the mesh size); the result comes back equal on every rank.

    The blocks are padded with ``ref`` copies (they clip to zero
    contribution) and gathered.  At ``d == 3`` rank ``r`` sweeps the
    prefixes of its ``nb_loc`` slabs of ``blk = min(block, n_loc)``,
    ``[r nb_loc blk, (r + 1) nb_loc blk)``: K5 at that first-prefix
    offset on the card (its partials added by ``torch.sum``), the plain
    slabs added in order on the CPU; the per-rank volumes are gathered
    and added in rank order.  ``d == 2`` is the replicated staircase on
    the gathered points."""
    from ..parallel import collectives
    from ..parallel.mapper import check_axis, population_sharding
    check_axis(mesh, axis)
    pts = torch.as_tensor(points)
    if not pts.is_floating_point():
        pts = pts.to(torch.float32)
    d = pts.shape[-1]
    if d not in (2, 3):
        raise ValueError(
            f"hypervolume_sharded supports 2 or 3 objectives, got {d}")
    ref_t = torch.as_tensor(ref, dtype=pts.dtype, device=pts.device)
    n = pts.shape[0] * mesh.size if n is None else int(n)
    sh = population_sharding(mesh, n, quantum)
    if pts.shape[0] != sh.rows:
        raise ValueError(f"rank {mesh.rank} holds {pts.shape[0]} points; "
                         f"the layout gives it {sh.rows}")
    local = torch.cat([pts, ref_t.expand(sh.n_loc - sh.rows, d)], 0)
    p_full = torch.minimum(collectives.all_gather(local.contiguous(), mesh),
                           ref_t)
    if d == 2:
        return hypervolume_2d(p_full, ref_t)
    blk = min(block, sh.n_loc)
    nb_loc = -(-sh.n_loc // blk)
    k_begin = mesh.rank * nb_loc * blk
    count = min(nb_loc * blk, sh.n_pad - k_begin)
    acc = p_full.new_zeros(())
    if count > 0:
        if p_full.is_cuda:
            ref_y = float(torch.as_tensor(ref, dtype=pts.dtype).reshape(-1)[1])
            acc = torch.sum(_hv3d_cuda_partials(p_full, ref_t, ref_y, blk,
                                                k_begin, count))
        else:
            for part in _slab_volumes(p_full, ref_t, blk, k_begin,
                                      count).unbind():
                acc = acc + part
    return collectives.gather_sum(acc, mesh)


def hypervolume(pointset, ref, block: int = 128, device=None) -> float:
    """Exact hypervolume with per-dimension routing — the contract of
    :func:`deap_tpu_torch.ops.hv.hypervolume`, and the default
    ``toolbox.hypervolume`` slot.  ``d == 2`` stays on the host
    staircase; ``d == 3`` runs the blocked sweep in float64 on
    ``device``: K5 on the card (``device=None`` means ``"cuda"`` and
    raises without one, as every entry point of the package), the plain
    sweep for ``device="cpu"``; ``d >= 4`` runs the host WFG/native
    sweep.  ``pointset`` is a tensor (it stays on its device until it is
    needed elsewhere) or anything numpy reads."""
    if isinstance(pointset, torch.Tensor):
        pts = pointset.detach()
    else:
        pts = torch.from_numpy(np.asarray(pointset, np.float64))
    if pts.ndim == 1:
        pts = pts.reshape(1, -1)
    elif pts.ndim != 2:
        pts = pts.reshape(-1, pts.shape[-1])
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().cpu().numpy()
    ref = np.asarray(ref, np.float64)
    if pts.shape[1] == 3 and len(pts):
        pts = pts.to(device=resolve_device(device), dtype=torch.float64)
        return float(hypervolume_device(pts, ref, block=block))
    return hypervolume_host(pts, ref)
