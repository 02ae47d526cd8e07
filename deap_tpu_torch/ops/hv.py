"""Exact hypervolume, host tier — the counterpart of
``deap_tpu/ops/hv.py``.

``hypervolume(pointset, ref)`` (implicit minimization) is the contract
of the reference's ``hv.hypervolume``, in three tiers:

1. ``d == 2``: the closed-form staircase sweep, as numpy on the host
   and as a tensor function (:func:`hypervolume_2d`) for on-device
   metrics;
2. the native C++ WFG sweep (``deap_tpu_torch/native/hv.cpp``), built at
   first use by the host compiler and bound with ctypes;
3. a pure-numpy WFG (While-Bradstreet-Barone) recursion for any
   dimension, when the native library cannot be built.

Every tier computes the exact volume of the region dominated by
``pointset`` and bounded by ``ref``; points that do not strictly
dominate ``ref`` are discarded first.  :func:`host_tier` says which of
tiers 2 and 3 answers in this process.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hypervolume", "hypervolume_2d", "host_tier"]


def hypervolume_2d(points: torch.Tensor, ref) -> torch.Tensor:
    """Exact 2-D hypervolume as tensor code, in the points' dtype and on
    their device: sort by the first objective and sum the staircase
    strips.  Dominated points contribute zero through the running
    minimum (``torch.cummin`` equals XLA's prefix minimum bit for bit;
    the final sum runs in torch's order)."""
    ref = torch.as_tensor(ref, dtype=points.dtype, device=points.device)
    pts = torch.minimum(points, ref)                  # clip to the box
    order = torch.argsort(pts[:, 0], stable=True)
    x = pts[order, 0]
    y = pts[order, 1]
    ymin = torch.cummin(y, 0).values                  # best y seen so far
    next_x = torch.cat([x[1:], ref[0:1]])
    strip = torch.clamp(ref[1] - ymin, min=0.0) * torch.clamp(next_x - x,
                                                              min=0.0)
    return torch.sum(strip)


def _nds_min(points: np.ndarray) -> np.ndarray:
    """Keep the non-dominated subset (minimization)."""
    n = len(points)
    if n <= 1:
        return points
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        dominated = np.all(points[i] <= points, axis=1) & np.any(
            points[i] < points, axis=1)
        dominated[i] = False
        keep &= ~dominated
    return points[keep]


def _wfg(points: np.ndarray, ref: np.ndarray) -> float:
    """WFG exclusive-hypervolume recursion (While, Bradstreet & Barone
    2012), written from the published description."""
    n, d = points.shape
    if n == 0:
        return 0.0
    if d == 1:
        return float(ref[0] - points[:, 0].min())
    if d == 2:
        pts = points[np.argsort(points[:, 0])]
        total = 0.0
        ymin = ref[1]
        for x, y in pts:
            if y < ymin:
                total += (ref[0] - x) * (ymin - y)
                ymin = y
        return float(total)
    # sort worst-first on the last objective so limit sets shrink quickly
    order = np.argsort(-points[:, -1])
    pts = points[order]
    total = 0.0
    for k in range(n):
        p = pts[k]
        inclusive = float(np.prod(ref - p))
        rest = pts[k + 1:]
        if len(rest):
            limited = np.maximum(rest, p)
            total += inclusive - _wfg(_nds_min(limited), ref)
        else:
            total += inclusive
    return total


def host_tier() -> str:
    """``"native"`` when the C++ sweep answers ``d >= 3`` in this
    process, else ``"numpy"``."""
    from ..native import hv as native_hv
    return "native" if native_hv.load() is not None else "numpy"


def hypervolume(pointset, ref) -> float:
    """Exact hypervolume of ``pointset`` (tensor or array, ``(n, d)``)
    with respect to the reference point ``ref``, implicit minimization,
    in float64 on the host."""
    if isinstance(pointset, torch.Tensor):
        pointset = pointset.detach().cpu().numpy()
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().cpu().numpy()
    pts = np.asarray(pointset, np.float64)
    ref = np.asarray(ref, np.float64)
    if pts.ndim == 1:
        pts = pts.reshape(1, -1)          # a single d-dim point
    elif pts.ndim != 2:
        pts = pts.reshape(-1, pts.shape[-1])
    # discard points that do not strictly dominate the reference point
    pts = pts[np.all(pts < ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    if pts.shape[1] == 2:
        order = np.lexsort((pts[:, 1], pts[:, 0]))
        x = pts[order, 0]
        y = pts[order, 1]
        ymin = np.minimum.accumulate(y)
        next_x = np.append(x[1:], ref[0])
        return float(np.sum(np.maximum(ref[1] - ymin, 0.0)
                            * np.maximum(next_x - x, 0.0)))
    if host_tier() == "native":
        from ..native import hv as native_hv
        return native_hv.hypervolume(pts, ref)
    return _wfg(_nds_min(pts), ref)
