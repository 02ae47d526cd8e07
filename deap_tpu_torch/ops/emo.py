"""Multi-objective selection — the PyTorch counterpart of
``deap_tpu/ops/emo.py``: dominator counts, every method of
``nondominated_ranks`` (``peel``, ``grid``, ``densegrid``, ``staircase``,
``sweep2d`` and the ``auto`` dispatch), crowding distance, ``sel_nsga2``,
the list-of-fronts wrappers, the dominance/crowding tournament
``sel_tournament_dcd``, NSGA-III (``uniform_reference_points``,
``sel_nsga3``, ``SelNSGA3WithMemory``) and SPEA2 (``sel_spea2``,
``sel_spea2_staged`` and its two stages).

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

NSGA-III and SPEA2 repeat the float32 forms XLA's CPU backend compiles
for the JAX package (read off its optimized IR): a multiply whose only
use is an add is one fused multiply-add (:func:`_xla_math.fma`), a
division by a constant is a multiply by its float32 reciprocal, and the
intercepts' ``jnp.linalg.solve`` is LAPACK's ``sgetrf``/``strsm`` as
the CPU's OpenBLAS runs them (:func:`_solve_ones`).  Up to four
objectives every float is then bitwise the JAX package's on the CPU,
and the same on the card; SPEA2's raw fitness is summed exactly, which
JAX's float32 sums equal while they stay below 2**24.
Where the law is sequential over small vectors (NSGA-III's integer
water-filling over the reference points, SPEA2's batch acceptance over
64 candidates) it runs on the host after one read.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from .. import random
from .._xla_math import fma, fma_product, sqrt
from ..base import Fitness, dominates, lexsort
from .dominance import rows_dominate_counts

__all__ = ["nondominated_ranks", "sort_nondominated",
           "sort_log_nondominated", "assign_crowding_dist", "sel_nsga2",
           "sel_tournament_dcd", "uniform_reference_points", "sel_nsga3",
           "SelNSGA3WithMemory", "sel_spea2", "sel_spea2_staged"]

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


def sel_tournament_dcd(key, fitness, k):
    """Dominance/crowding binary tournament: pairs from ``ceil(2k / n)``
    random permutations (the keys of ``split(key, nperm + 1)``); the
    dominating individual wins, else the one of higher crowding distance,
    else a coin (``bernoulli`` on the last key)."""
    w, values = _wv_values(fitness)
    n = w.shape[0]
    ranks, _ = nondominated_ranks(w)
    dist = assign_crowding_dist(values, ranks)
    nperm = -(-2 * k // n)
    keys = random.split(key, nperm + 1)
    perms = torch.cat([random.permutation(keys[i], n).long()
                       for i in range(nperm)])
    a, b = perms[0:2 * k:2], perms[1:2 * k:2]
    a_dom = dominates(w[a], w[b])
    b_dom = dominates(w[b], w[a])
    a_crowd = dist[a] > dist[b]
    b_crowd = dist[b] > dist[a]
    coin = random.bernoulli(keys[-1], 0.5, (k,))
    pick_a = a_dom | (~b_dom & (a_crowd | (~b_crowd & coin)))
    return torch.where(pick_a, a, b)


# ---------------------------------------------------------------------------
# NSGA-III
# ---------------------------------------------------------------------------


def uniform_reference_points(nobj: int, p: int, scaling=None) -> np.ndarray:
    """Das–Dennis simplex-lattice reference points (host numpy: a
    constant of the selection)."""
    def gen(ref, left, total, depth):
        points = []
        if depth == nobj - 1:
            ref = ref.copy()
            ref[depth] = left / total
            return [ref]
        for i in range(left + 1):
            r = ref.copy()
            r[depth] = i / total
            points.extend(gen(r, left - i, total, depth + 1))
        return points

    ref_points = np.array(gen(np.zeros(nobj), p, p, 0))
    if scaling is not None:
        ref_points *= scaling
        ref_points += (1 - scaling) / nobj
    return ref_points


def _fma_sum(terms):
    """``sum(a * b)`` over ``terms`` ``[(a, b), ...]`` as XLA's CPU
    backend compiles a short reduce of products: the first product
    rounded, each later one fused into the running sum."""
    (a0, b0), *rest = terms
    acc = a0 * b0
    for a, b in rest:
        acc = fma(a, b, acc)
    return acc


def _sq_dist_pairs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum((x - y) ** 2, -1)`` (broadcast) in XLA's float32 form: each
    difference rounded, the squares fused into the running sum in
    objective order.  The squares are exact in float64."""
    acc = None
    for j in range(x.shape[-1]):
        e = (x[..., j] - y[..., j]).double()
        acc = (e * e).float() if acc is None else fma_product(e * e, acc)
    return acc


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(c, n)`` squared distances of the rows ``a`` to the rows ``b``,
    XLA's form (:func:`_sq_dist_pairs`)."""
    return _sq_dist_pairs(a[:, None, :], b[None, :, :])


def _find_extreme_points(obj_t: torch.Tensor, cand: torch.Tensor,
                         prior_extreme=None) -> torch.Tensor:
    """Per-axis achievement-scalarising minimisers (first index on ties)
    on ideal-translated objectives; ``prior_extreme`` joins the
    candidates (the memory variant)."""
    nobj = obj_t.shape[1]
    if prior_extreme is not None:
        obj_t = torch.cat([obj_t, prior_extreme], 0)
        cand = torch.cat([cand, torch.ones(nobj, dtype=torch.bool,
                                           device=cand.device)])
    eye = torch.eye(nobj, dtype=torch.bool, device=obj_t.device)
    asf_w = torch.where(eye, 1.0, 1e6).to(obj_t.dtype)
    asf = torch.amax(obj_t[:, None, :] * asf_w[None, :, :], -1)
    asf = torch.where(cand[:, None], asf, float("inf"))
    return obj_t[torch.argmin(asf, 0)]


def _solve_ones(a: torch.Tensor) -> torch.Tensor:
    """``x`` with ``a @ x = 1`` for a small float32 ``(m, m)`` matrix, as
    ``jnp.linalg.solve`` computes it on the CPU: OpenBLAS's ``sgetrf``
    (the left-looking ``getf2``: a column's upper part by dot products
    summed from the last term, its lower part by a matrix-vector
    product, pivot the first largest magnitude, scale by the pivot's
    float32 reciprocal) and two ``strsm`` (its kernels' blocks of 1, 2,
    4 and 8 rows, the diagonal as a float32 reciprocal, every
    multiply-add fused), written as float32 tensor ops so the card
    computes what the CPU does.  Bitwise to jax 0.9.0 with its OpenBLAS
    0.3.30 at m = 2, 3 and 4; within 2 ulp at 5 and 8 (measured on
    near-diagonal matrices); m up to 15."""
    m = a.shape[0]
    if m > 15:
        raise ValueError(f"the intercept solve takes up to 15 objectives, "
                         f"not {m}")
    a = a.clone()
    perm = torch.arange(m, device=a.device)
    for j in range(m):
        for i in range(1, j):                   # upper: b[i] -= dot
            a[i, j] = a[i, j] - _fma_sum([(a[i, q], a[q, j])
                                          for q in range(i - 1, -1, -1)])
        if j:                                   # lower: b[j:] -= A b
            a[j:, j] = a[j:, j] - _fma_sum([(a[j:, q], a[q, j])
                                            for q in range(j)])
        p = j + torch.argmax(a[j:, j].abs())
        swap = torch.arange(m, device=a.device)
        swap[j], swap[p] = p, j
        a, perm = a[swap], perm[swap]
        piv = a[j, j]
        lower = torch.where(piv.abs() >= _FLT_MIN, a[j + 1:, j] * (1.0 / piv),
                            a[j + 1:, j] / piv)
        a[j + 1:, j] = torch.where(piv != 0, lower, a[j + 1:, j])
    inv = 1.0 / torch.diagonal(a)
    c = torch.ones(m, dtype=a.dtype, device=a.device)[perm]
    # forward, unit lower: blocks of 8, 4, 2, 1 rows from the top
    done = 0
    for size in (8, 4, 2, 1):
        if not m & size:
            continue
        rows = slice(done, done + size)
        if done:
            c[rows] = c[rows] - _fma_sum([(a[rows, q], c[q])
                                          for q in range(done)])
        for i in range(done, done + size):
            for r in range(i + 1, done + size):
                c[r] = fma(-c[i], a[r, i], c[r])
        done += size
    # backward, upper: blocks of 1, 2, 4, 8 rows from the bottom
    done = m
    for size in (1, 2, 4, 8):
        if not m & size:
            continue
        rows = slice(done - size, done)
        if done < m:
            c[rows] = c[rows] - _fma_sum([(a[rows, q], c[q])
                                          for q in range(done, m)])
        for i in range(done - 1, done - size - 1, -1):
            c[i] = c[i] * inv[i]
            for r in range(done - size, i):
                c[r] = fma(-c[i], a[r, i], c[r])
        done -= size
    return c


_FLT_MIN = 1.1754943508222875e-38
_F32_1EM12 = float(np.float32(1e-12))


def _find_intercepts(extreme_t: torch.Tensor, obj_t: torch.Tensor,
                     cand: torch.Tensor) -> torch.Tensor:
    """Hyperplane intercepts in translated space: ``(extreme_t + 1e-12
    I) x = 1``, intercepts ``1 / x``, the worst point where they are not
    finite or not positive, 1 where below 1e-12."""
    nobj = extreme_t.shape[0]
    eye = torch.eye(nobj, dtype=extreme_t.dtype, device=extreme_t.device)
    x = _solve_ones(extreme_t + eye * _F32_1EM12)
    intercepts = 1.0 / torch.where(x.abs() > _F32_1EM12, x, float("inf"))
    worst = torch.amax(torch.where(cand[:, None], obj_t, float("-inf")), 0)
    bad = ~torch.isfinite(intercepts).all() | (intercepts < _F32_1EM12).any()
    intercepts = torch.where(bad, worst, intercepts)
    return torch.where(intercepts > _F32_1EM12, intercepts, 1.0)


def _associate_to_niche(obj, rp, ideal, intercepts_t, traced: bool):
    """Nearest reference line of every point in normalised objective
    space: ``(niche, distance)``.  The dot products and the squared
    distances are XLA's fused sums (:func:`_fma_sum`, the point's
    offset from its projection fused into the multiply by the line).
    Reference points that are a constant of the JAX program (``traced``
    false) have their squared norms folded as XLA's constant folding
    does, the rounded squares summed in float64 and rounded once, and
    the projection divides by multiplying with their float32
    reciprocals; traced ones (``SelNSGA3WithMemory``) have fused norms
    and a true division."""
    norm_obj = (obj - ideal) / (intercepts_t + _F32_1EM12)
    nobj = obj.shape[1]
    if traced:
        n2 = _fma_sum([(rp[:, j], rp[:, j]) for j in range(nobj)])
        proj = _fma_sum([(norm_obj[:, None, j], rp[None, :, j])
                         for j in range(nobj)]) / torch.where(n2 > 0, n2, 1.0)
    else:
        rph = rp.cpu().numpy()
        n2 = (rph * rph).astype(np.float64).sum(1).astype(np.float32)
        inv = np.float32(1) / np.where(n2 > 0, n2, np.float32(1))
        proj = _fma_sum([(norm_obj[:, None, j], rp[None, :, j])
                         for j in range(nobj)]) * torch.from_numpy(
            inv).to(rp.device)
    d2 = None
    for j in range(nobj):
        e = fma(-proj, rp[None, :, j], norm_obj[:, None, j]).double()
        d2 = (e * e).float() if d2 is None else fma_product(e * e, d2)
    niche = torch.argmin(d2, 1)
    d = sqrt(torch.gather(d2, 1, niche[:, None])[:, 0])
    return niche, d


def _seg_positions(groups_sorted: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal group ids."""
    n = groups_sorted.shape[0]
    pos = torch.arange(n, device=groups_sorted.device)
    newg = torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=pos.device),
                      groups_sorted[1:] != groups_sorted[:-1]])
    return pos - torch.cummax(torch.where(newg, pos, 0), 0).values


def _water_fill(counts0, total, k_fill: int, k: int, u_tie) -> np.ndarray:
    """The per-niche pick counts on the host (int64): counts rise
    together to the level ``L* = max{L : sum clip(L - counts0, 0,
    total) <= k_fill}`` (32 bisection steps, as in the JAX package), and
    the remainder goes to the eligible niches of the largest ``u_tie``
    (stable order on ties)."""
    c0 = counts0.astype(np.int64)
    tot = total.astype(np.int64)
    lo, hi = 0, int(k) + int(c0.max()) + 2
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        if int(np.clip(mid - c0, 0, tot).sum()) <= k_fill:
            lo = mid
        else:
            hi = mid
    taken = np.clip(lo - c0, 0, tot)
    r = k_fill - int(taken.sum())
    elig = (c0 <= lo) & (taken < tot)
    score = np.where(elig, -u_tie, np.float32(np.inf)).astype(np.float32)
    extra = np.zeros(len(c0), np.int64)
    extra[np.argsort(score, kind="stable")] = np.arange(len(c0)) < r
    return taken + np.where(elig, extra, 0)


def _f32(x, dev) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(dev)


def sel_nsga3(key, fitness, k, ref_points, ideal_override=None,
              prior_extreme=None, return_memory=False, *,
              traced_ref_points: bool = False):
    """NSGA-III selection: whole fronts below the split front, whose
    members are normalised (ideal point, extreme points, intercepts),
    associated with the nearest Das–Dennis reference line, and picked by
    niche: each niche's order is its closest candidate first when the
    niche starts empty, then uniform random (``fold_in(key, 0x9e3)``);
    the per-niche counts are integer water-filling over the reference
    points, on the host.

    ``ideal_override`` / ``prior_extreme`` carry the memory variant's
    state; ``return_memory`` also returns ``(ideal, extreme points)``.
    ``traced_ref_points`` takes the float forms XLA compiles when the
    reference points are an argument of the jitted JAX program, not a
    constant (:class:`SelNSGA3WithMemory`)."""
    w, _ = _wv_values(fitness)
    dev = w.device
    rp = _f32(ref_points, dev)
    n = w.shape[0]
    obj = -w
    ranks, _ = nondominated_ranks(w, stop_at_k=k)
    L = torch.sort(ranks).values[k - 1]
    base = ranks < L
    candidates = ranks == L
    considered = ranks <= L
    inf = float("inf")
    ideal = torch.amin(torch.where(considered[:, None], obj, inf), 0)
    if ideal_override is not None:
        ideal = torch.minimum(ideal, _f32(ideal_override, dev))
    obj_t = obj - ideal
    prior_t = (_f32(prior_extreme, dev) - ideal
               if prior_extreme is not None else None)
    extreme_t = _find_extreme_points(obj_t, considered, prior_t)
    intercepts = _find_intercepts(extreme_t, obj_t, considered)
    niche, niche_dist = _associate_to_niche(obj, rp, ideal, intercepts,
                                            traced_ref_points)
    nref = rp.shape[0]
    counts0 = _segment_sum(base.to(torch.int32), niche, nref)
    k_order, k_loop = random.split(random.fold_in(key, 0x9e3))
    # each niche's candidates by (distance, index): position 0 is the
    # closest, the lowest index on ties
    pos_idx = torch.arange(n, device=dev)
    niche_c = torch.where(candidates, niche, nref)
    ord1 = lexsort([pos_idx, torch.where(candidates, niche_dist, inf),
                    niche_c])
    is_closest = ((_seg_positions(niche_c[ord1]) == 0)
                  & candidates[ord1])[_inverse(ord1)]
    # the pick order within a niche: the closest first iff the niche
    # starts empty, then uniform keys (uniform without replacement)
    special = candidates & is_closest & (counts0[niche] == 0)
    key1 = torch.where(special, -1.0, random.uniform(k_order, (n,)))
    ord2 = lexsort([key1, niche_c])
    pick_rank = _seg_positions(niche_c[ord2])[_inverse(ord2)]
    total = _segment_sum(candidates.to(torch.int32), niche, nref)
    u_tie = random.uniform(k_loop, (nref,))
    host = torch.cat([counts0.long(), total.long(), base.sum()[None],
                      u_tie.view(torch.int32).long()]).cpu().numpy()
    c0, tot = host[:nref], host[nref:2 * nref]
    k_fill = int(k) - int(host[2 * nref])
    u = host[2 * nref + 1:].astype(np.int32).view(np.float32)
    taken = torch.from_numpy(_water_fill(c0, tot, k_fill, k, u)).to(dev)
    selected = base | (candidates & (pick_rank < taken[niche]))
    order = lexsort([(~selected).to(torch.int8)])[:k]
    if return_memory:
        return order, (ideal, extreme_t + ideal)
    return order


class SelNSGA3WithMemory:
    """NSGA-III with the best-so-far ideal point and the previous
    generation's extreme points carried across calls, as host numpy
    state (``best_point``, ``extreme_points``; see
    :func:`deap_tpu_torch.interop.nsga3_memory_to_torch`).  The
    reference points enter as the JAX package's jitted selection takes
    them, an argument (``traced_ref_points``)."""

    def __init__(self, ref_points, nd="standard"):
        self.ref_points = np.asarray(ref_points)
        nobj = self.ref_points.shape[1]
        self.best_point = np.full(nobj, np.inf)
        self.extreme_points = None
        self._nd = nd

    def __call__(self, key, fitness, k):
        with_memory = (bool(np.all(np.isfinite(self.best_point)))
                       and self.extreme_points is not None)
        idx, (ideal, extreme) = sel_nsga3(
            key, fitness, k, self.ref_points,
            ideal_override=self.best_point if with_memory else None,
            prior_extreme=self.extreme_points if with_memory else None,
            return_memory=True, traced_ref_points=True)
        self.best_point = ideal.cpu().numpy()
        self.extreme_points = extreme.cpu().numpy()
        return idx


# ---------------------------------------------------------------------------
# SPEA2
# ---------------------------------------------------------------------------


def _row_chunks(n: int, chunk: int):
    """``(start, stop)`` of the row blocks of ``min(chunk, n)`` rows (the
    last one shorter: no padding rows)."""
    c = max(1, min(chunk, n))
    return [(s, min(s + c, n)) for s in range(0, n, c)]


def _top_k_smallest_blocked(d2: torch.Tensor, kk: int):
    """Per row the ``kk`` smallest values of ``d2`` ``(c, n)`` and their
    column indices, ascending by (value, index) — ``lax.top_k``'s order,
    the lower index first on ties, which the JAX package's blocked
    reduction keeps (its blocks are ascending index ranges).  The
    threshold comes from ``torch.topk`` (whose choice among ties is
    unspecified); the kept set is every value below it and the
    lowest-index ones equal to it.  A NaN (the distance between two
    ``-inf`` rows) reads as ``+inf``."""
    c, n = d2.shape
    d2 = torch.nan_to_num(d2, nan=float("inf"))
    kth = torch.topk(d2, kk, dim=1, largest=False).values[:, -1:]
    below = d2 < kth
    tie = d2 == kth
    room = kk - below.sum(1, keepdim=True)
    keep = below | (tie & (torch.cumsum(tie.to(torch.int32), 1) <= room))
    cols = torch.nonzero(keep)[:, 1].reshape(c, kk)
    vals = torch.gather(d2, 1, cols)
    o = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, o), torch.gather(cols, 1, o)


#: the unfused float32 squared distance (the squares summed in torch's
#: own order, fused or not) is within a few roundings of XLA's fused
#: one; these bound the gap far above that: ``|unfused - fused| <=
#: _REL * value + _ABS``
_REL, _ABS = 2.0 ** -16, 2.0 ** -100
#: candidates taken beyond the ``kk`` nearest by the unfused distance
_EXTRA = 64


def _nearest_candidates(w: torch.Tensor, rows: torch.Tensor, kk: int,
                        alive=None):
    """For each row ``w[rows]``: the XLA-form squared distances ``(c, K)``
    to its ``K = kk + 64`` nearest columns by the unfused float32
    distance (itself and, given ``alive``, dead columns read ``+inf``),
    those columns, and which rows they certainly cover —
    every column whose XLA-form distance is at most the row's kk-th
    smallest is among them whenever the K-th unfused distance lies
    beyond the error bound of the kk-th.  The other rows (ties across
    the bound, NaN) take the XLA-form distance to every column
    (:func:`_nearest_exact`).  One pass over the ``(c, n)`` block in
    float32 instead of the emulated fused sums in float64."""
    n = w.shape[0]
    a = w[rows]
    approx = None
    for j in range(w.shape[1]):
        e = a[:, None, j] - w[None, :, j]
        approx = e * e if approx is None else approx.addcmul_(e, e)
    if alive is not None:
        approx.masked_fill_(~alive[None, :], float("inf"))
    approx[torch.arange(rows.numel(), device=w.device), rows] = float("inf")
    K = min(n, kk + _EXTRA)
    av, ai = torch.topk(approx, K, dim=1, largest=False)
    lim = (av[:, kk - 1] + _ABS) * ((1 + _REL) / (1 - _REL)) + _ABS
    sure = ((K == n) | (av[:, -1] > lim)) & ~approx.isnan().any(1)
    bad = ai == rows[:, None]
    if alive is not None:
        bad = bad | ~alive[ai]
    ev = torch.where(bad, float("inf"), _sq_dist_pairs(a[:, None, :], w[ai]))
    return ev, ai, sure


def _nearest_exact(w: torch.Tensor, rows: torch.Tensor, alive=None):
    """XLA-form squared distances of ``w[rows]`` to every column, itself
    (and dead columns) ``+inf``."""
    cols = torch.arange(w.shape[0], device=w.device)
    bad = rows[:, None] == cols[None, :]
    if alive is not None:
        bad = bad | ~alive[None, :]
    return torch.where(bad, float("inf"), _sq_dist(w[rows], w))


def _kth_smallest(d2: torch.Tensor, kth: int) -> torch.Tensor:
    """Per-row (kth+1)-smallest value."""
    return torch.topk(d2, kth + 1, dim=1, largest=False).values[:, -1]


def _weighted_dominated(rows: torch.Tensor, weight: torch.Tensor,
                        w: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """``out[j] = sum of weight[r] over the rows r dominating w[j]``,
    exact, as float64: the nonnegative integer weights (below
    ``2**weight_bits``) split into digits of at most 11 bits, each
    summed over the block by one float32 product with the 0/1 dominance
    matrix — every digit exact in TF32 too, every partial sum an integer
    below 2**24, so exact in any order — then recombined."""
    ge = gt = None
    for j in range(w.shape[1]):
        a, b = rows[:, None, j], w[None, :, j]
        ge = a >= b if ge is None else ge & (a >= b)
        gt = a > b if gt is None else gt | (a > b)
    dom = (ge & gt).to(torch.float32)
    width = min(11, 24 - rows.shape[0].bit_length())
    shifts = range(0, max(1, weight_bits), width)
    weight = weight.long()
    digits = torch.stack([((weight >> sh) & ((1 << width) - 1))
                          .to(torch.float32) for sh in shifts])
    sums = (digits @ dom).double()
    return sum(sums[i] * float(1 << sh) for i, sh in enumerate(shifts))


def _spea2_fitness_stage(w: torch.Tensor, chunk: int, kth_method: str):
    """SPEA2 stage 1: strength, raw fitness and the k-NN density →
    ``(spea_fit, nondominated)``.

    * strength ``s[i] = #{j : w[i] dominates w[j]}`` is K4 with the roles
      swapped: ``i`` dominates ``j`` exactly when ``-w[j]`` dominates
      ``-w[i]``, so ``s = rows_dominate_counts(-w, -w)`` (masked ``-inf``
      rows become ``+inf``, which the count handles alike);
    * raw ``r[j] = sum of s[i] over i dominating j`` is summed exactly
      (integers in float64, any order) and rounded once to float32: the
      JAX package's chunked float32 product equals it while its partial
      sums stay below 2**24 (every pool of up to 4096 points), above
      that it depends on its summation order;
    * the density reads the (sqrt(n)+1)-th smallest squared distance in
      XLA's fused form, self-pairs excluded, among each row's nearest
      candidates (:func:`_nearest_candidates`), which hold every distance
      up to it.  The JAX package's two ``kth_method``s (``blocked``,
      ``bisect``) return the same value, so both take it by ``topk``."""
    if kth_method not in ("blocked", "bisect"):
        raise ValueError(f"kth_method {kth_method!r}")
    n = w.shape[0]
    kth = min(int(np.sqrt(n)), n - 1) if n > 1 else 0
    nw = (-w).contiguous()
    strength = rows_dominate_counts(nw, nw)
    raw = torch.zeros(n, dtype=torch.float64, device=w.device)
    ids = torch.arange(n, device=w.device)
    cand = torch.empty((n, min(n, kth + 1 + _EXTRA)), dtype=w.dtype,
                       device=w.device)
    sure = torch.empty(n, dtype=torch.bool, device=w.device)
    for s0, s1 in _row_chunks(n, chunk):
        cand[s0:s1], _, sure[s0:s1] = _nearest_candidates(w, ids[s0:s1],
                                                          kth + 1)
        raw += _weighted_dominated(w[s0:s1], strength[s0:s1], w,
                                   max(1, n - 1).bit_length())
    kth_dist = _kth_smallest(cand, kth)         # every row in one pass
    redo = torch.nonzero(~sure).reshape(-1)
    for s0, s1 in _row_chunks(redo.numel(), chunk):
        rows = redo[s0:s1]
        kth_dist[rows] = _kth_smallest(_nearest_exact(w, rows), kth)
    raw = raw.float()
    density = 1.0 / (sqrt(kth_dist) + 2.0)
    return raw + density, raw < 1


def _spea2_select_stage(w: torch.Tensor, spea_fit: torch.Tensor,
                        nondom: torch.Tensor, k: int, chunk: int = 1024):
    """SPEA2 stage 2: too few nondominated points → fill with the best
    dominated by SPEA2 fitness; too many → truncate them by iterated
    nearest-neighbour removal (``_spea2_truncate``).  One host read
    picks the branch."""
    n = w.shape[0]
    n_nondom = int(nondom.sum())
    if n_nondom < k:
        fill_order = lexsort([torch.where(nondom, float("inf"), spea_fit)])
        selected = nondom.clone()
        selected[fill_order[:k - n_nondom]] = True
    elif n_nondom > k:
        selected = _spea2_truncate(w, nondom, k, chunk)
    else:
        selected = nondom
    return lexsort([(~selected).to(torch.int8)])[:k]


def _nearest(w: torch.Tensor, rows: torch.Tensor, alive: torch.Tensor,
             tb: int):
    """Ascending ``(len(rows), tb)`` XLA-form distances and indices of
    each row's nearest alive points, itself excluded, the lower index
    first on ties: from the candidates (:func:`_nearest_candidates`, in
    column order), else from every column."""
    ev, ai, sure = _nearest_candidates(w, rows, tb, alive)
    by_col = torch.sort(ai, dim=1).indices
    ai = torch.gather(ai, 1, by_col)
    dist, pos = _top_k_smallest_blocked(torch.gather(ev, 1, by_col), tb)
    idx = torch.gather(ai, 1, pos)
    if not bool(sure.all()):
        redo = torch.nonzero(~sure).reshape(-1)
        dist[redo], idx[redo] = _top_k_smallest_blocked(
            _nearest_exact(w, rows[redo], alive), tb)
    return dist, idx


def _lex_first(rows: torch.Tensor, count: int) -> torch.Tensor:
    """The first ``count`` indices of the stable lexicographic order of
    ``rows`` (first column primary; ``jnp.lexsort`` of the columns): they
    all lie among the rows whose first column is at most its
    ``count``-th smallest value, so only those are sorted."""
    col0 = rows[:, 0]
    bound = torch.kthvalue(col0, min(count, col0.numel())).values
    near = torch.nonzero(col0 <= bound).reshape(-1)
    sub = rows[near]
    return near[lexsort([sub[:, j] for j in range(rows.shape[1] - 1, -1,
                                                   -1)])][:count]


def _spea2_truncate(w: torch.Tensor, nondom: torch.Tensor, k: int,
                    chunk: int) -> torch.Tensor:
    """Truncate the nondominated set to ``k`` points, the JAX package's
    incremental batch form: each point's ``tb = min(n - 1, 8)`` nearest
    alive neighbours (distances and indices), then rounds that take the
    longest prefix of the lexicographic victim order (of the lists'
    distance vectors, the smallest first) in which no candidate's live
    neighbour list holds a victim accepted before it.  The acceptance
    scan over the round's ``W = min(n, 64)`` candidates runs on the host
    after one read; victims leave every list (a stable row re-sort), and
    a row left with fewer than ``(tb + 1) // 2`` live entries is
    rebuilt, ``rc = min(n, 64)`` rows a pass."""
    n = w.shape[0]
    dev = w.device
    tb = min(n - 1, 8) if n > 1 else 1
    min_valid = (tb + 1) // 2
    rc = min(n, 64)
    W = min(n, 64)
    alive = nondom.clone()
    ids = torch.arange(n, device=dev)
    parts = [_nearest(w, ids[s0:s1], alive, tb)
             for s0, s1 in _row_chunks(n, chunk)]
    dist = torch.cat([p[0] for p in parts])
    idx = torch.cat([p[1] for p in parts])
    n_alive = int(alive.sum())
    inf = float("inf")
    while n_alive > k:
        cands = _lex_first(torch.where(alive[:, None], dist, inf), W)
        # one read: each candidate, whether it is alive, its list's
        # distances and indices (all exact in float64)
        read = torch.cat([cands[:, None].double(),
                          alive[cands, None].double(), dist[cands].double(),
                          idx[cands].double()], 1).cpu().numpy()
        budget = n_alive - k
        accepted: set = set()
        for row in read:
            cand, c_alive = int(row[0]), row[1] > 0
            c_dist, c_idx = row[2:2 + tb], row[2 + tb:]
            live = np.isfinite(c_dist)
            conflict = any(int(i) in accepted for i in c_idx[live])
            if conflict or not c_alive or len(accepted) >= budget:
                break
            accepted.add(cand)
        acc = torch.zeros(n, dtype=torch.bool, device=dev)
        acc[torch.tensor(sorted(accepted), dtype=torch.long,
                         device=dev)] = True
        alive = alive & ~acc
        n_alive -= len(accepted)
        dist = torch.where(acc[idx], inf, dist)
        o = torch.sort(dist, dim=1, stable=True).indices
        dist, idx = torch.gather(dist, 1, o), torch.gather(idx, 1, o)
        full = min(min_valid, n_alive - 1)
        need = torch.nonzero(alive & (torch.isfinite(dist).sum(1) < full)
                             ).reshape(-1)
        for s0 in range(0, need.numel(), rc):
            rows = need[s0:s0 + rc]
            dist[rows], idx[rows] = _nearest(w, rows, alive, tb)
    return alive


def sel_spea2(key, fitness, k, chunk: int = 1024,
              kth_method: str = "blocked"):
    """SPEA2 environmental selection: strength and raw fitness from the
    dominance structure, k-NN density, then either fill with the best
    dominated individuals or truncate the nondominated set.  Pairwise
    structures are taken in ``(chunk, n)`` row blocks.  ``key`` is
    unused.  ``kth_method``: ``"blocked"`` or ``"bisect"`` (the same
    values; see :func:`_spea2_fitness_stage`)."""
    del key
    w, _ = _wv_values(fitness)
    spea_fit, nondom = _spea2_fitness_stage(w, chunk, kth_method)
    return _spea2_select_stage(w, spea_fit, nondom, k, chunk)


def sel_spea2_staged(key, fitness, k, chunk: int = 1024):
    """SPEA2 as the JAX package's two dispatches: stage 1 with the
    ``bisect`` kth method, then stage 2 (each stage is callable alone, as
    ``bench_nsga2.py``'s ``BENCH_STAGED=1`` calls them)."""
    del key
    w, _ = _wv_values(fitness)
    spea_fit, nondom = _spea2_fitness_stage(w, chunk, "bisect")
    return _spea2_select_stage(w, spea_fit, nondom, int(k), chunk)
