"""Multi-objective selection — the PyTorch counterpart of the NSGA-II part
of ``deap_tpu/ops/emo.py``: dominator counts, the count-peeling front
sort (``nondominated_ranks(method="peel")``), crowding distance and
``sel_nsga2``.

Front peeling works on dominator *counts*: one O(M·N²) pass counts, for
every point, the points that dominate it; each round peels the points
whose count is zero and subtracts their dominance from the survivors'
counts, front members taken ``front_chunk`` at a time.  Both passes are
:func:`~deap_tpu_torch.ops.dominance.rows_dominate_counts`, which is K4
on the card.  Counts and ranks are integers and equal the JAX package's
exactly; the crowding distance repeats its float operations in order
and equals it bit for bit.

The peel's loop conditions are host reads (PyTorch has no device-side
``while``): one per round, the size of the front that ``nonzero``
fixes.  Of ``nondominated_ranks``' methods only ``peel`` is ported: a
method that resolves to ``staircase``, ``sweep2d``, ``grid`` or
``densegrid`` raises :class:`MethodNotPorted` instead of running the
peel in its place — ``method="auto"``
(``sel_nsga2(nd="standard")``) resolves to ``staircase`` at two
objectives and to ``grid`` at three or more objectives and n ≥ 16384.
"""

from __future__ import annotations

import torch

from ..base import Fitness, dominates, lexsort
from .dominance import rows_dominate_counts

__all__ = ["MethodNotPorted", "nondominated_ranks", "assign_crowding_dist",
           "sel_nsga2"]

_METHODS = ("auto", "staircase", "sweep2d", "peel", "grid", "densegrid")


class MethodNotPorted(NotImplementedError):
    """The non-dominated sorting method resolves, but only ``peel`` is
    ported to deap_tpu_torch yet."""


def _wv_values(fitness):
    if isinstance(fitness, Fitness):
        return fitness.masked_wvalues(), fitness.values
    return fitness, fitness


def _dominator_counts(w: torch.Tensor, active: torch.Tensor,
                      chunk: int = 1024) -> torch.Tensor:
    """``counts[j] = #{i : active[i] and w[i] dominates w[j]}``.  On the
    card this is one K4 launch with rows ``where(active, w, -inf)``
    against every column; on the CPU the JAX package's column-chunked
    broadcast."""
    if w.is_cuda:
        rows = torch.where(active[:, None], w, float("-inf")).contiguous()
        return rows_dominate_counts(rows, w.contiguous())
    n = w.shape[0]
    return torch.cat([
        (dominates(w[:, None, :], w[None, s:s + chunk, :])
         & active[:, None]).sum(0, dtype=torch.int32)
        for s in range(0, n, chunk)])


def _make_exact_subtract(w: torch.Tensor, c: int):
    """The chunked exact front subtraction: the front's members (their
    indices, in index order) ``c`` at a time, each chunk's dominance
    subtracted from the counts by ``rows_dominate_counts``.  K4 and the
    plain version take any number of rows, so no chunk is padded."""
    w = w.contiguous()

    def subtract_front_exact(counts, idx):
        for s in range(0, idx.numel(), c):
            counts = counts - rows_dominate_counts(w[idx[s:s + c]], w)
        return counts

    return subtract_front_exact


def _peel_from_counts(w: torch.Tensor, counts: torch.Tensor,
                      stop_at_k, front_chunk: int):
    """Peel the zero-count front, subtract its dominance, repeat, until
    every point is ranked or ``stop_at_k`` are.  Unpeeled points keep the
    sentinel rank ``n``.  Returns ``(ranks, n_fronts)``."""
    n = w.shape[0]
    subtract = _make_exact_subtract(w, front_chunk)
    stop = n if stop_at_k is None else min(int(stop_at_k), n)
    ranks = torch.full((n,), n, dtype=torch.int32, device=w.device)
    active = torch.ones((n,), dtype=torch.bool, device=w.device)
    n_active, r = n, 0
    while n_active > 0 and n - n_active < stop:
        idx = torch.nonzero(active & (counts == 0)).reshape(-1)
        if idx.numel() == 0:
            raise RuntimeError("front peel made no progress: no active "
                               "point has a zero dominator count")
        ranks[idx] = r
        active[idx] = False
        counts = subtract(counts, idx)
        n_active -= idx.numel()
        r += 1
    return ranks, r


def nondominated_ranks(w: torch.Tensor, valid=None, front_chunk: int = 1024,
                       method: str = "auto", stop_at_k=None):
    """Pareto front index of every point (0 = first front) as an int32
    tensor, and the number of fronts peeled: ``(ranks, n_fronts)``.
    Invalid rows (``valid`` false) read ``-inf`` and land in the last
    fronts.  ``stop_at_k`` stops once ``k`` points are ranked (the front
    holding the k-th is completed); the rest keep rank ``n``.

    The method dispatch is the JAX package's; only ``peel`` is ported,
    and a call that resolves to another method raises
    :class:`MethodNotPorted`."""
    n, m = w.shape
    if valid is not None:
        w = torch.where(valid[:, None], w, float("-inf"))
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method in ("staircase", "sweep2d") and m != 2:
        raise ValueError(f"{method} requires exactly 2 objectives")
    if method == "sweep2d":
        resolved = "sweep2d"
    elif m == 2 and method in ("auto", "staircase"):
        resolved = "staircase"
    elif method == "densegrid":
        resolved = "densegrid"
    elif method == "grid" or (method == "auto" and m >= 3 and n >= 16384):
        resolved = "grid"
    else:
        resolved = "peel"
    if resolved != "peel":
        raise MethodNotPorted(
            f"nondominated_ranks: method {method!r} resolves to "
            f"{resolved!r} at nobj={m}, n={n}, which is not ported to "
            "deap_tpu_torch yet; pass method='peel' (sel_nsga2(nd='peel'))")
    counts = _dominator_counts(w, torch.ones((n,), dtype=torch.bool,
                                             device=w.device))
    return _peel_from_counts(w, counts, stop_at_k, min(front_chunk, n))


def assign_crowding_dist(values: torch.Tensor,
                         ranks: torch.Tensor) -> torch.Tensor:
    """Crowding distance within each front: per objective, sort each
    front, add the normalised gap between each point's neighbours;
    boundary points get ``+inf``.  Segment extremes are
    ``scatter_reduce`` over ``n + 1`` segments (the sentinel rank ``n``
    included); the scatters by the sort order have unique indices, so
    the result is deterministic on every device."""
    n, nobj = values.shape
    seg = ranks.long()
    dist = torch.zeros(n, dtype=values.dtype, device=values.device)
    boundary = torch.zeros(n, dtype=torch.int32, device=values.device)
    one = torch.ones(1, dtype=torch.bool, device=values.device)
    for j in range(nobj):
        v = values[:, j]
        order = lexsort([v, ranks])       # primary: rank, secondary: v
        rv, vv = ranks[order], v[order]
        step = rv[1:] != rv[:-1]
        is_first = torch.cat([one, step])
        is_last = torch.cat([step, one])
        prev = torch.cat([vv[:1], vv[:-1]])
        nxt = torch.cat([vv[1:], vv[-1:]])
        seg_max = torch.full((n + 1,), float("-inf"), dtype=v.dtype,
                             device=v.device).scatter_reduce(
            0, seg, v, "amax", include_self=False)
        seg_min = torch.full((n + 1,), float("inf"), dtype=v.dtype,
                             device=v.device).scatter_reduce(
            0, seg, v, "amin", include_self=False)
        norm_row = (nobj * (seg_max - seg_min))[rv.long()]
        contrib = torch.where(norm_row > 0, (nxt - prev) / norm_row, 0.0)
        by_row = torch.empty_like(dist)
        by_row[order] = contrib
        dist = dist + by_row
        edge = torch.empty_like(boundary)
        edge[order] = (is_first | is_last).to(torch.int32)
        boundary = torch.maximum(boundary, edge)
    return torch.where(boundary > 0, float("inf"), dist)


def sel_nsga2(key, fitness, k, nd="standard", front_chunk: int = 1024):
    """NSGA-II selection: whole Pareto fronts in order, the split front
    cut by descending crowding distance — one sort by (rank ascending,
    crowding descending).  ``key`` is unused.  ``nd`` is
    ``"standard"``/``"log"`` (``method="auto"``) or a method name;
    ``front_chunk`` is the peel's chunk of front rows."""
    del key
    method = "auto" if nd in ("standard", "log") else nd
    w, values = _wv_values(fitness)
    ranks, _ = nondominated_ranks(w, method=method, front_chunk=front_chunk,
                                  stop_at_k=k)
    dist = assign_crowding_dist(values, ranks)
    return lexsort([-dist, ranks])[:k]
