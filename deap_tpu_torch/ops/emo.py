"""Multi-objective selection — the PyTorch counterpart of the NSGA-II part
of ``deap_tpu/ops/emo.py``: dominator counts, every method of
``nondominated_ranks`` (``peel``, ``grid``, ``densegrid``, ``staircase``,
``sweep2d`` and the ``auto`` dispatch), crowding distance, ``sel_nsga2``
and the list-of-fronts wrappers.

Front peeling works on dominator *counts*: each round peels the points
whose count is zero and updates the survivors' counts.  The counts come
from one O(M·N²) pass (``peel``: K4 on the card with C = n), from the
sub-quadratic grid decomposition (``grid``) or from a dense value-rank
histogram (``densegrid``); a peeled front is subtracted exactly,
``front_chunk`` rows at a time, by
:func:`~deap_tpu_torch.ops.dominance.rows_dominate_counts` (K4 on the
card), or — in the grid's hybrid peel, for a fat front — the counts are
recomputed against the remaining rows by one source-masked grid pass.
Two objectives have their own methods: the parallel staircase peel
(``staircase``, one prefix minimum per front) and the serial sweep
(``sweep2d``).  Counts and ranks are integers and equal the JAX
package's exactly, whatever the method; the crowding distance repeats
its float operations in order and equals it bit for bit.

The loop conditions of the peels are host reads (PyTorch has no
device-side ``while``): one per round, the size of the front that
``nonzero`` fixes (the hybrid peel branches on that same number) or the
count of unranked points.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..base import Fitness, dominates, lexsort
from .dominance import rows_dominate_counts

__all__ = ["nondominated_ranks", "sort_nondominated",
           "sort_log_nondominated", "assign_crowding_dist", "sel_nsga2"]

_METHODS = ("auto", "staircase", "sweep2d", "peel", "grid", "densegrid")
#: elements of one (slabs, T, T) compare block of the grid's band pass
_BAND_BLOCK = 1 << 26


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
                      stop_at_k, front_chunk: int, subtract_front=None):
    """Peel the zero-count front, update the survivors' counts, repeat,
    until every point is ranked or ``stop_at_k`` are.  Unpeeled points
    keep the sentinel rank ``n``.  ``subtract_front(counts, idx,
    active)`` gets the front's indices and the rows still active after
    it; the default is the chunked exact subtraction.  Returns ``(ranks,
    n_fronts)``."""
    n = w.shape[0]
    if subtract_front is None:
        exact = _make_exact_subtract(w, front_chunk)
        subtract_front = lambda counts, idx, active: exact(counts, idx)
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
        counts = subtract_front(counts, idx, active)
        n_active -= idx.numel()
        r += 1
    return ranks, r


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """``argsort`` of a permutation: where each index sits in it."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), dtype=perm.dtype,
                             device=perm.device)
    return inv


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """int32 sums per segment id (integers: any order gives the same
    sums, so the scatter is deterministic on the card too)."""
    return torch.zeros((num_segments,), dtype=torch.int32,
                       device=values.device).index_add_(0, seg, values)


def _suffix_sums(h: torch.Tensor) -> torch.Tensor:
    """Suffix-inclusive int32 sums along every axis of a histogram."""
    for ax in range(h.ndim):
        h = torch.flip(torch.cumsum(torch.flip(h, (ax,)), ax,
                                    dtype=torch.int32), (ax,))
    return h


def _dup_groups(w: torch.Tensor):
    """Exact-duplicate row groups: ``(full_ord, gid, inv_full)`` where
    ``full_ord`` is the full-row lexicographic order (first objective
    primary), ``gid`` labels each row of ``w[full_ord]`` with its
    duplicate group and ``inv_full`` maps back to the original order."""
    m = w.shape[1]
    full_ord = lexsort([w[:, c] for c in range(m - 1, -1, -1)])
    ws = w[full_ord]
    new_grp = torch.cat([
        torch.ones((1,), dtype=torch.int64, device=w.device),
        (ws[1:] != ws[:-1]).any(-1).to(torch.int64)])
    gid = torch.cumsum(new_grp, 0) - 1
    return full_ord, gid, _inverse(full_ord)


def _grid_views(w: torch.Tensor, bucket_cells: int = 2 ** 24) -> dict:
    """Source-independent precomputation of the grid dominator counts:
    per-axis sort orders (ties broken by the full-row lexicographic
    rank), positions, buckets, the padded slab views and the
    duplicate-group structure.  Built once and reused for every source
    mask of the hybrid peel."""
    n, m = w.shape
    # buckets per axis: capped by bucket_cells, scaled down with n
    # (cells ~ 128 n) so small inputs pay no 2^24-cell histogram
    B = max(2, min(int(round(bucket_cells ** (1.0 / m))),
                   int(round((128.0 * n) ** (1.0 / m)))))
    T = -(-n // B)                                    # slab size
    pad = B * T - n
    full_ord, gid, inv_full = _dup_groups(w)
    # strict per-axis total order; pos[c] = rank of each point on axis c
    perm = [lexsort([inv_full, w[:, c]]) for c in range(m)]
    pos = torch.stack([_inverse(p) for p in perm])    # (m, n), distinct
    b = pos // T                                      # (m, n) buckets
    lin, lin_up = b[0], b[0] + 1
    for c in range(1, m):
        lin = lin * B + b[c]
        lin_up = lin_up * (B + 1) + (b[c] + 1)

    def slabs(x, c):                                  # (B, T, m), pad -1
        v = x[:, perm[c]].T.to(torch.int32)
        v = torch.cat([v, v.new_full((pad, m), -1)], 0)
        return v.reshape(B, T, m)

    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=w.device), gid[1:] != gid[:-1]])
    return dict(n=n, m=m, B=B, T=T, pad=pad, perm=perm, pos=pos, lin=lin,
                lin_up=lin_up, Pv=[slabs(pos, c) for c in range(m)],
                Bv=[slabs(b, c) for c in range(m)], full_ord=full_ord,
                gid=gid, inv_full=inv_full, is_start=is_start)


def _grid_counts_from_views(v: dict, src: torch.Tensor) -> torch.Tensor:
    """Dominator counts among the rows ``src`` marks, for every row,
    from :func:`_grid_views`' output.  Three exact parts (see
    :func:`_grid_dominator_counts`): the strictly-greater-bucket region
    by a histogram and suffix sums, the same-slab bands by slab-local
    position compares, and the duplicates' correction."""
    n, m, B, T = v["n"], v["m"], v["B"], v["T"]
    src32 = src.to(torch.int32)
    # strictly greater bucket on every axis: histogram + suffix sums,
    # read one cell up (index B on an axis: nothing above)
    H = _suffix_sums(_segment_sum(src32, v["lin"], B ** m)
                     .reshape((B,) * m))
    Hp = torch.nn.functional.pad(H, (0, 1) * m)
    counts = Hp.reshape(-1)[v["lin_up"]]
    # same slab on axis c: position compares within the slab, counted
    # once, at the first axis whose buckets are equal
    step = max(1, _BAND_BLOCK // (T * T))
    for c in range(m):
        Sv = torch.cat([src[v["perm"][c]],
                        src.new_zeros((v["pad"],))]).reshape(B, T)
        band = torch.empty((B, T), dtype=torch.int32, device=src.device)
        for s0 in range(0, B, step):
            tp = v["Pv"][c][s0:s0 + step]             # (slabs, T, m)
            tb = v["Bv"][c][s0:s0 + step]
            hit = Sv[s0:s0 + step, None, :]           # source j on axis 2
            for a in range(m):
                hit = hit & (tp[:, None, :, a] >= tp[:, :, None, a])
            for a in range(c):
                hit = hit & (tb[:, None, :, a] != tb[:, :, None, a])
            band[s0:s0 + step] = hit.sum(2, dtype=torch.int32)
        counts = counts + band.reshape(-1)[v["pos"][c]]
    # exact-equal rows satisfy >= everywhere but dominate nothing: take
    # off each row's equals that sort at or after it (itself included)
    s_sorted = src32[v["full_ord"]]
    pref = torch.cumsum(s_sorted, 0, dtype=torch.int32)
    gtotal = _segment_sum(s_sorted, v["gid"], n)[v["gid"]]
    base = torch.cummax(torch.where(v["is_start"], pref - s_sorted, 0),
                        0).values
    suffix_ge = gtotal - (pref - base) + s_sorted
    return counts - suffix_ge[v["inv_full"]]


def _grid_dominator_counts(w: torch.Tensor, src=None,
                           bucket_cells: int = 2 ** 24) -> torch.Tensor:
    """Sub-quadratic dominator counts for any number of objectives,
    exact for every input — continuous, discrete, duplicated, ±inf.

    Give every point a strict total order per objective, ``pos_c``
    (sorted by ``(w_c, L)`` with ``L`` the full-row lexicographic rank),
    and cut each axis into ``B`` equal *position* slabs (``B^nobj ≈
    min(bucket_cells, 128·n)``).  For distinct rows ``w_j ≥ w_i``
    everywhere iff ``pos_j > pos_i`` on every axis, so for a pair (j, i)
    either every bucket of j is strictly above i's — counted by one
    ``B^nobj`` histogram, suffix sums and one lookup per point — or
    some bucket is equal — counted by position compares inside that
    slab, at the first such axis; exact-equal rows, which satisfy ≥ on
    every axis but dominate nothing, are taken off by their duplicate
    group.  O(N·(nobj·N/B + log N) + B^nobj) against the count peel's
    O(nobj·N²).

    ``src`` (bool ``(n,)``) restricts the *sources*: the counts become
    "dominators among the marked rows" for every row."""
    if src is None:
        src = torch.ones((w.shape[0],), dtype=torch.bool, device=w.device)
    return _grid_counts_from_views(_grid_views(w, bucket_cells), src)


def _grid_recount_ranks(w: torch.Tensor, stop_at_k, front_chunk: int = 1024,
                        bucket_cells: int = 2 ** 24,
                        recount_min_front=None):
    """The grid's hybrid front peel: carried dominator counts, each
    round's update chosen by the width of the peeled front (a host
    branch on the count the peel already reads):

    * a thin front (< ``recount_min_front``, default 4·``front_chunk``)
      is subtracted exactly, ``front_chunk`` rows at a time (K4 on the
      card), at a cost proportional to its width;
    * a fat front triggers one source-masked grid pass over the rows
      still active, flat in the front's width.

    Both rules leave counts-against-active for every active point, so
    they compose freely from round to round."""
    n = w.shape[0]
    c = min(front_chunk, n)
    if recount_min_front is None:
        recount_min_front = 4 * c
    views = _grid_views(w, bucket_cells)
    counts0 = _grid_counts_from_views(
        views, torch.ones((n,), dtype=torch.bool, device=w.device))
    exact = _make_exact_subtract(w, c)

    def hybrid_subtract(counts, idx, active):
        if idx.numel() >= recount_min_front:
            return _grid_counts_from_views(views, active)
        return exact(counts, idx)

    return _peel_from_counts(w, counts0, stop_at_k, c, hybrid_subtract)


def _sorted_distinct(col: torch.Tensor):
    """A column sorted, and the running count of distinct values in it
    (``dense[i]`` = dense rank of ``sv[i]``)."""
    sv = torch.sort(col + 0.0).values                 # -0.0 reads as 0.0
    newv = torch.cat([torch.zeros((1,), dtype=torch.int64,
                                  device=col.device),
                      (sv[1:] != sv[:-1]).to(torch.int64)])
    return sv, torch.cumsum(newv, 0)


def _dense_value_ok(w: torch.Tensor, vmax: int) -> bool:
    """The dense grid's exactness precondition: every axis has at most
    ``vmax`` distinct values.  One host read."""
    most = torch.stack([_sorted_distinct(w[:, c])[1][-1]
                        for c in range(w.shape[1])]).max()
    return bool(most < vmax)


def _dense_value_grid_counts(w: torch.Tensor, vmax: int) -> torch.Tensor:
    """Exact dominator counts for *discrete* objectives by one dense
    value-rank histogram: rank every point per axis by dense value rank
    (ties share a rank), histogram the points over the ``vmax^nobj``
    grid and take suffix-inclusive sums over every axis — a cell then
    counts the points ≥ everywhere, and taking off the point's own cell
    (≥ and equal everywhere: not dominating) leaves the dominator count.
    O(N + vmax^nobj), exact for any tie structure provided every axis
    has at most ``vmax`` distinct values (:func:`_dense_value_ok`)."""
    n, m = w.shape
    lin = None
    for c in range(m):
        sv, dense = _sorted_distinct(w[:, c])
        first = torch.searchsorted(sv, (w[:, c] + 0.0).contiguous())
        rank = torch.clamp(dense[first], 0, vmax - 1)
        lin = rank if lin is None else lin * vmax + rank
    hist = _segment_sum(torch.ones((n,), dtype=torch.int32,
                                   device=w.device), lin, vmax ** m)
    S = _suffix_sums(hist.reshape((vmax,) * m))
    return S.reshape(-1)[lin] - hist[lin]


def _sorted_min_space(w: torch.Tensor):
    """Shared 2-objective preamble: flip to minimization, make ±inf
    finite, sort by (f1 asc, f2 asc).  Returns ``(order, f1s, f2s)``."""
    big = torch.finfo(w.dtype).max
    f = torch.clamp(-w, -big, big)
    order = lexsort([f[:, 1], f[:, 0]])
    return order, f[order, 0], f[order, 1]


def _nondominated_ranks_2d_sweep(w: torch.Tensor):
    """Exact 2-objective ranks in O(n log n) *serial* steps: in (f1 asc,
    f2 asc)-sorted minimization space keep ``best[r]``, the least f2 of
    front ``r`` so far (non-decreasing in ``r``); a point's front is the
    first ``r`` with ``best[r] > f2``, one bisection.  Exact duplicates
    share the run head's front and do not update the staircase.

    The n steps are sequential, so this method sorts on the card and
    then runs as a Python loop over a host copy, wherever ``w`` lives:
    it is the explicit choice for adversarially deep data (F ≈ N
    fronts), not a path to time."""
    n = w.shape[0]
    order, f1s, f2s = _sorted_min_space(w)
    f1h, f2h = f1s.cpu().numpy(), f2s.cpu().numpy()
    rs = np.empty((n,), np.int32)
    best: list = []
    pf1 = pf2 = float("nan")
    r = 0
    for i in range(n):
        f1, f2 = f1h[i], f2h[i]
        if not (f1 == pf1 and f2 == pf2):
            r = bisect.bisect_right(best, f2)
            if r == len(best):
                best.append(f2)
            else:
                best[r] = f2
        rs[i] = r
        pf1, pf2 = f1, f2
    ranks = torch.zeros((n,), dtype=torch.int32, device=w.device)
    ranks[order] = torch.from_numpy(rs).to(w.device)
    return ranks, int(rs.max()) + 1 if n else 0


def _nondominated_ranks_2d(w: torch.Tensor, stop_at_k=None):
    """Exact 2-objective ranks as a *parallel* staircase peel: one round
    per front, each one prefix minimum.

    In (f1 asc, f2 asc)-sorted minimization space only an earlier point
    can dominate a later one, and ``j`` dominates ``i`` iff ``(f2_j,
    f1_j) <_lex (f2_i, f1_i)`` (equal pairs are duplicates, which never
    dominate).  So a point is in the current front iff no active earlier
    point has a lex-smaller key: one *exclusive prefix lexicographic
    minimum* over the active points.  ``torch.cummin`` gives the prefix
    minimum of f2; the f1 that goes with it is the least f1 among the
    earlier active points attaining that f2, and since f1 ascends with
    the position that is the f1 at the first position attaining it —
    the start of the run of equal prefix minima, found by a running
    maximum of run-start positions (``cummin``'s own index says nothing
    about ties by contract).  O(F·n) work; one host read a round."""
    n = w.shape[0]
    order, f1s, f2s = _sorted_min_space(w)
    dev = w.device
    inf = float("inf")
    stop = n if stop_at_k is None else min(int(stop_at_k), n)
    ranks_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    arange = torch.arange(n, device=dev)
    head = torch.full((1,), inf, dtype=f1s.dtype, device=dev)
    unranked, r = n, 0
    while unranked > 0 and n - unranked < stop:
        active = ranks_s < 0
        k2 = torch.where(active, f2s, inf)
        k1 = torch.where(active, f1s, inf)
        m2 = torch.cummin(k2, 0).values
        new_run = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                             m2[1:] < m2[:-1]])
        start = torch.cummax(torch.where(new_run, arange, 0), 0).values
        m1 = k1[start]
        m2 = torch.cat([head, m2[:-1]])               # exclusive prefix
        m1 = torch.cat([head, m1[:-1]])
        dominated = (m2 < f2s) | ((m2 == f2s) & (m1 < f1s))
        ranks_s = torch.where(active & ~dominated, r, ranks_s)
        unranked = int((ranks_s < 0).sum())
        r += 1
    ranks_s = torch.where(ranks_s < 0, n, ranks_s)    # unpeeled: sentinel
    ranks = torch.zeros((n,), dtype=torch.int32, device=dev)
    ranks[order] = ranks_s.to(torch.int32)
    return ranks, r


def nondominated_ranks(w: torch.Tensor, valid=None, front_chunk: int = 1024,
                       method: str = "auto", stop_at_k=None):
    """Pareto front index of every point (0 = first front) as an int32
    tensor, and the number of fronts peeled: ``(ranks, n_fronts)``.
    Invalid rows (``valid`` false) read ``-inf`` and land in the last
    fronts.  ``stop_at_k`` stops once ``k`` points are ranked (the front
    holding the k-th is completed); the rest keep rank ``n``
    (``sweep2d`` ranks everything and ignores it).

    Methods, identical partitions: ``staircase`` and ``sweep2d`` (two
    objectives only), ``peel`` (count peel, any number of objectives),
    ``grid`` (the hybrid recompute peel on grid counts) and
    ``densegrid`` (discrete objectives: dense value-rank counts, falling
    back to the count peel's counts when an axis has too many distinct
    values).  ``auto`` takes the staircase at two objectives, the grid
    at three or more with n ≥ 16384, else the count peel — by shape,
    never by the data, as in the JAX package."""
    n, m = w.shape
    if valid is not None:
        w = torch.where(valid[:, None], w, float("-inf"))
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method in ("staircase", "sweep2d") and m != 2:
        raise ValueError(f"{method} requires exactly 2 objectives")
    if method == "sweep2d":
        return _nondominated_ranks_2d_sweep(w)
    if m == 2 and method in ("auto", "staircase"):
        return _nondominated_ranks_2d(w, stop_at_k)
    c = min(front_chunk, n)
    everyone = torch.ones((n,), dtype=torch.bool, device=w.device)
    if method == "densegrid":
        vmax = max(2, min(512, int(round((2 ** 24) ** (1.0 / m)))))
        if _dense_value_ok(w, vmax):
            counts = _dense_value_grid_counts(w, vmax)
        else:
            counts = _dominator_counts(w, everyone)
        return _peel_from_counts(w, counts, stop_at_k, c)
    if method == "grid" or (method == "auto" and m >= 3 and n >= 16384):
        return _grid_recount_ranks(w, stop_at_k, c)
    return _peel_from_counts(w, _dominator_counts(w, everyone), stop_at_k, c)


def sort_nondominated(fitness, k, first_front_only=False):
    """The reference's list-of-fronts return: fronts as numpy index
    arrays covering at least the first ``k`` individuals."""
    w, _ = _wv_values(fitness)
    ranks, nf = nondominated_ranks(w, stop_at_k=int(k))
    ranks = ranks.cpu().numpy()
    fronts = []
    total = 0
    for r in range(int(nf)):
        idx = np.nonzero(ranks == r)[0]
        fronts.append(idx)
        total += len(idx)
        if first_front_only or total >= k:
            break
    return fronts


def sort_log_nondominated(fitness, k, first_front_only=False):
    """The reference's ``sortLogNondominated`` entry point; the same
    partition by the same dispatch as :func:`sort_nondominated`."""
    return sort_nondominated(fitness, k, first_front_only)


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
