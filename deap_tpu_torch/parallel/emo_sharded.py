"""Sharded multi-objective selection — the port's counterpart of
``deap_tpu/parallel/emo_sharded.py``.

Each rank holds a contiguous block of the population's rows (its
*columns* of the dominator counts) and calls these functions together
with the other ranks of the mesh:

* **columns sharded, rows gathered once** — one all-gather of the
  weighted fitness gives every rank the ``(n_pad, m)`` table ``w_full``;
  the rank counts its ``n_loc`` columns' dominators among all rows, K4
  (``rows_dominate_counts``) on the card, the plain count on the CPU.
* **the peel, ``exchange="indices"``** (default) — each subtraction
  round all-gathers a compacted int32 payload per rank, ``[remaining
  front rows, c global indices]``; every rank decodes the same payload,
  so every loop condition is uniform with no reduction, and the front's
  rows are looked up in the resident ``w_full``.
* **the peel, ``exchange="rows"``** — the row-block protocol: each round
  all-gathers ``c`` front rows a rank, with one gather-sum a front
  (width, survivors) and one a sub-round.
* **``method="grid"``** — the sub-quadratic grid counts of
  :func:`deap_tpu_torch.ops.emo._grid_views`, the views built on every
  rank from ``w_full``, the histogram region replicated, the same-slab
  band passes split by slab range (one stacked int32 band payload
  gathered a counts call), and the hybrid peel: thin fronts subtracted
  as in the indices peel, a fat one (global width ``>= 4 c R``)
  recounted against the active set.
* **the crowding tail, ``tail="sharded"``** — each rank runs the
  crowding program of ``ceil(nobj / R)`` objectives over the gathered
  population; one stacked payload gathered; every rank adds the
  contributions in objective order, the float association of
  :func:`~deap_tpu_torch.ops.emo.assign_crowding_dist`.

Rows are padded with ``-inf`` up to ``n_pad`` (pads dominate nothing,
are dominated by every real row, and peel last).  Every integer output
— counts, ranks, front count, selected indices — equals the single-card
:func:`~deap_tpu_torch.ops.emo.nondominated_ranks` /
:func:`~deap_tpu_torch.ops.emo.sel_nsga2` exactly, whatever the rank
count.

Every function takes the rank's block and ``n`` (the global row count;
default: the block's rows times the mesh size) and ``quantum`` (the
layout's row quantum, :func:`~deap_tpu_torch.parallel.mapper.
population_sharding`).  Per-row outputs are the rank's block; ``n_fronts``
and the selected indices are replicated.
"""

from __future__ import annotations

import torch

from ..base import Fitness, lexsort
from ..ops.dominance import rows_dominate_counts
from ..ops.emo import (_segment_sum, _suffix_sums, _BAND_BLOCK, _grid_views,
                       assign_crowding_dist)
from . import collectives
from .mapper import _pad_rows, check_axis, population_sharding

__all__ = ["nondominated_ranks_sharded", "sel_nsga2_sharded",
           "dominance_counts_sharded"]


def _layout(x: torch.Tensor, mesh, n, quantum: int):
    n = x.shape[0] * mesh.size if n is None else int(n)
    sh = population_sharding(mesh, n, quantum)
    if x.shape[0] != sh.rows:
        raise ValueError(f"rank {mesh.rank} holds {x.shape[0]} rows; the "
                         f"layout of {n} rows over {mesh.size} ranks "
                         f"(quantum {quantum}) gives it {sh.rows}")
    return sh


def _wv(fitness):
    if isinstance(fitness, Fitness):
        return fitness.masked_wvalues(), fitness.values
    return fitness, fitness


def _initial_counts(w_local, mesh, sh):
    """One population all-gather, then this rank's columns' dominator
    counts against every row.  Returns ``(counts, w_full, w_loc)``,
    ``w_loc`` the block padded to ``n_loc``."""
    w_loc = _pad_rows(w_local.to(torch.float32), sh.n_loc,
                      float("-inf")).contiguous()
    w_full = collectives.all_gather(w_loc, mesh)
    return rows_dominate_counts(w_full, w_loc), w_full, w_loc


def dominance_counts_sharded(w_local, mesh, axis: str | None = None, *,
                             n=None, quantum: int = 1) -> torch.Tensor:
    """Per-point dominator counts (``#{i : w[i] dominates w[j]}``) of
    this rank's rows against all ``n`` rows: one gather, one K4 launch
    on the card.  The JAX function's ``row_chunk`` has no counterpart:
    K4 and the plain count take any number of rows."""
    check_axis(mesh, axis)
    sh = _layout(w_local, mesh, n, quantum)
    counts, _, _ = _initial_counts(w_local, mesh, sh)
    return counts[:sh.rows]


def _compact_payload(todo, c: int, d_off: int, n_pad: int):
    """This rank's round payload ``[remaining, c global indices]`` (int32,
    sentinel ``n_pad``) and the local indices it names."""
    idx = torch.nonzero(todo).reshape(-1)[:c]
    gidx = torch.full((c,), n_pad, dtype=torch.int32, device=todo.device)
    gidx[:idx.numel()] = (idx + d_off).to(torch.int32)
    n_rem = todo.sum(dtype=torch.int32).reshape(1)
    return torch.cat([n_rem, gidx]), idx


def _indices_round(todo, mesh, c, sh, d_off):
    """One indices sub-round: ``(rem (R,) host list, cidx (real rows,
    gathered order), idx (local indices sent))``."""
    payload, idx = _compact_payload(todo, c, d_off, sh.n_pad)
    g = collectives.all_gather(payload, mesh).reshape(mesh.size, c + 1)
    flat = g[:, 1:].reshape(-1)
    cidx = flat[flat < sh.n_pad]                  # real rows first, in order
    return g[:, 0].tolist(), cidx, idx


def _subtract_rows(counts, w_full, cidx, w_loc, c: int):
    for b in range(0, cidx.numel(), c):
        rows = w_full[cidx[b:b + c].long()].contiguous()
        counts = counts - rows_dominate_counts(rows, w_loc)
    return counts


def _peel_indices(counts, w_full, w_loc, mesh, sh, c: int, stop: int):
    """The indices peel (module docstring)."""
    n = sh.n
    dev = w_loc.device
    d_off = sh.row_base
    ranks = torch.full((sh.n_loc,), n, dtype=torch.int32, device=dev)
    active = torch.ones((sh.n_loc,), dtype=torch.bool, device=dev)
    n_active, r = sh.n_pad, 0
    while n_active > 0 and sh.n_pad - n_active < stop:
        front = active & (counts == 0)
        ranks[front] = r
        todo, front_total, t = front.clone(), 0, 0
        while True:
            rem, cidx, idx = _indices_round(todo, mesh, c, sh, d_off)
            if t == 0:
                front_total = sum(rem)
            counts = _subtract_rows(counts, w_full, cidx, w_loc, c)
            todo[idx] = False
            t += 1
            if not any(x > c for x in rem):
                break
        if front_total == 0:
            raise RuntimeError("front peel made no progress: no active "
                               "point has a zero dominator count")
        active &= ~front
        n_active -= front_total
        r += 1
    return ranks, r


def _peel_rows(counts, w_loc, mesh, sh, c: int, stop: int):
    """The row-block peel (module docstring)."""
    n = sh.n
    dev = w_loc.device
    m = w_loc.shape[1]
    wp_local = torch.cat([w_loc, torch.full((1, m), float("-inf"),
                                            device=dev)], 0)
    ranks = torch.full((sh.n_loc,), n, dtype=torch.int32, device=dev)
    active = torch.ones((sh.n_loc,), dtype=torch.bool, device=dev)
    n_active, r = sh.n_pad, 0
    while n_active > 0 and sh.n_pad - n_active < stop:
        front = active & (counts == 0)
        ranks[front] = r
        active_new = active & ~front
        tot = collectives.gather_sum(torch.stack([
            front.sum(dtype=torch.int32),
            active_new.sum(dtype=torch.int32)]), mesh).tolist()
        if tot[0] == 0:
            raise RuntimeError("front peel made no progress: no active "
                               "point has a zero dominator count")
        todo, n_todo = front.clone(), tot[0]
        while n_todo > 0:
            idx = torch.nonzero(todo).reshape(-1)[:c]
            sel = torch.full((c,), sh.n_loc, dtype=torch.long, device=dev)
            sel[:idx.numel()] = idx
            rows = collectives.all_gather(wp_local[sel].contiguous(), mesh)
            counts = counts - rows_dominate_counts(rows, w_loc)
            todo[idx] = False
            n_todo = int(collectives.gather_sum(
                todo.sum(dtype=torch.int32), mesh))
        active = active_new
        n_active = tot[1]
        r += 1
    return ranks, r


def _grid_counts_local(v, src, mesh, sh):
    """Dominator counts among the rows ``src`` marks (replicated bool
    ``(n_pad,)``) for this rank's rows: the histogram region replicated,
    this rank's slab range of the band passes, one stacked band payload
    gathered, the duplicate correction replicated."""
    m, B, T = v["m"], v["B"], v["T"]
    R = mesh.size
    lo, hi = sh.row_base, sh.row_base + sh.n_loc
    src32 = src.to(torch.int32)
    H = _suffix_sums(_segment_sum(src32, v["lin"], B ** m)
                     .reshape((B,) * m))
    Hp = torch.nn.functional.pad(H, (0, 1) * m)
    counts = Hp.reshape(-1)[v["lin_up"][lo:hi]]

    B_loc = -(-B // R)
    s_lo, s_hi = min(B, mesh.rank * B_loc), min(B, (mesh.rank + 1) * B_loc)
    step = max(1, _BAND_BLOCK // (T * T))
    payload = torch.zeros((m, B_loc, T), dtype=torch.int32, device=src.device)
    for c in range(m):
        Sv = torch.cat([src[v["perm"][c]],
                        src.new_zeros((v["pad"],))]).reshape(B, T)
        for s0 in range(s_lo, s_hi, step):
            s1 = min(s_hi, s0 + step)
            tp = v["Pv"][c][s0:s1]
            tb = v["Bv"][c][s0:s1]
            hit = Sv[s0:s1, None, :]
            for a in range(m):
                hit = hit & (tp[:, None, :, a] >= tp[:, :, None, a])
            for a in range(c):
                hit = hit & (tb[:, None, :, a] != tb[:, :, None, a])
            payload[c, s0 - s_lo:s1 - s_lo] = hit.sum(2, dtype=torch.int32)
    g = collectives.all_gather(payload[None], mesh)    # (R, m, B_loc, T)
    bands = g.permute(1, 0, 2, 3).reshape(m, R * B_loc * T)[:, :B * T]
    for c in range(m):
        counts = counts + bands[c][v["pos"][c][lo:hi]]
    s_sorted = src32[v["full_ord"]]
    pref = torch.cumsum(s_sorted, 0, dtype=torch.int32)
    gtotal = _segment_sum(s_sorted, v["gid"], v["n"])[v["gid"]]
    base = torch.cummax(torch.where(v["is_start"], pref - s_sorted, 0),
                        0).values
    suffix_ge = gtotal - (pref - base) + s_sorted
    return counts - suffix_ge[v["inv_full"][lo:hi]]


def _peel_grid(w_full, w_loc, mesh, sh, c: int, stop: int):
    """The grid's hybrid peel under the indices discipline (module
    docstring)."""
    n = sh.n
    dev = w_loc.device
    views = _grid_views(w_full)
    recount_min = 4 * c * mesh.size
    counts = _grid_counts_local(
        views, torch.ones((sh.n_pad,), dtype=torch.bool, device=dev), mesh,
        sh)
    d_off = sh.row_base
    ranks = torch.full((sh.n_loc,), n, dtype=torch.int32, device=dev)
    active_full = torch.ones((sh.n_pad,), dtype=torch.bool, device=dev)
    n_active, r = sh.n_pad, 0
    while n_active > 0 and sh.n_pad - n_active < stop:
        act_loc = active_full[d_off:d_off + sh.n_loc]
        front = act_loc & (counts == 0)
        ranks[front] = r
        todo, front_total, fat, t = front.clone(), 0, False, 0
        while True:
            rem, cidx, idx = _indices_round(todo, mesh, c, sh, d_off)
            if t == 0:
                front_total = sum(rem)
                fat = front_total >= recount_min
            active_full[cidx.long()] = False
            if not fat:
                counts = _subtract_rows(counts, w_full, cidx, w_loc, c)
            todo[idx] = False
            t += 1
            if not any(x > c for x in rem):
                break
        if front_total == 0:
            raise RuntimeError("front peel made no progress: no active "
                               "point has a zero dominator count")
        if fat:
            counts = _grid_counts_local(views, active_full, mesh, sh)
        n_active -= front_total
        r += 1
    return ranks, r


def nondominated_ranks_sharded(w_local, mesh, axis: str | None = None,
                               front_chunk: int = 256,
                               stop_at_k: int | None = None,
                               exchange: str = "indices",
                               method: str = "peel", *, n=None,
                               quantum: int = 1):
    """Pareto-front ranks with the dominance work sharded over the mesh:
    ``(ranks of this rank's rows, n_fronts)``, unpeeled rows at the
    sentinel ``n`` — the contract of
    :func:`deap_tpu_torch.ops.emo.nondominated_ranks`.  ``method`` is
    ``"peel"`` (``exchange`` ``"indices"`` or ``"rows"``) or ``"grid"``
    (always the indices discipline); see the module docstring.  No
    ``row_chunk``: see :func:`dominance_counts_sharded`."""
    check_axis(mesh, axis)
    if exchange not in ("indices", "rows"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if method not in ("peel", "grid"):
        raise ValueError(f"unknown method {method!r}")
    sh = _layout(w_local, mesh, n, quantum)
    stop = sh.n if stop_at_k is None else min(int(stop_at_k), sh.n)
    c = max(1, min(front_chunk, sh.n_loc))
    if method == "grid":
        w_loc = _pad_rows(w_local.to(torch.float32), sh.n_loc,
                          float("-inf")).contiguous()
        w_full = collectives.all_gather(w_loc, mesh)
        ranks, nf = _peel_grid(w_full, w_loc, mesh, sh, c, stop)
    else:
        counts, w_full, w_loc = _initial_counts(w_local, mesh, sh)
        if exchange == "indices":
            ranks, nf = _peel_indices(counts, w_full, w_loc, mesh, sh, c,
                                      stop)
        else:
            ranks, nf = _peel_rows(counts, w_loc, mesh, sh, c, stop)
    return ranks[:sh.rows], nf


def _crowding_tail_sharded(ranks_local, values_local, mesh, sh):
    """Crowding distance and the final ``(rank, -crowding)`` order with
    the per-objective programs split over the ranks: the whole order on
    every rank, bitwise the single-card tail's for the ranked rows (pad
    rows carry the sentinel rank ``n`` and never reach the front of
    it)."""
    n = sh.n
    nobj = values_local.shape[1]
    R = mesh.size
    r_full = collectives.all_gather(
        _pad_rows(ranks_local, sh.n_loc, n).contiguous(), mesh)
    v_full = collectives.all_gather(
        _pad_rows(values_local, sh.n_loc, 0.0).contiguous(), mesh)
    m_loc = -(-nobj // R)
    n_pad = sh.n_pad
    dev = v_full.device
    seg = r_full.long()
    one = torch.ones(1, dtype=torch.bool, device=dev)
    rows = []
    for jj in range(m_loc):
        j = min(mesh.rank * m_loc + jj, nobj - 1)
        v = v_full[:, j]
        order = lexsort([v, r_full])
        rv, vv = r_full[order], v[order]
        step = rv[1:] != rv[:-1]
        is_first = torch.cat([one, step])
        is_last = torch.cat([step, one])
        prev = torch.cat([vv[:1], vv[:-1]])
        nxt = torch.cat([vv[1:], vv[-1:]])
        seg_max = torch.full((n + 1,), float("-inf"), dtype=v.dtype,
                             device=dev).scatter_reduce(
            0, seg, v, "amax", include_self=False)
        seg_min = torch.full((n + 1,), float("inf"), dtype=v.dtype,
                             device=dev).scatter_reduce(
            0, seg, v, "amin", include_self=False)
        norm_row = (nobj * (seg_max - seg_min))[rv.long()]
        contrib = torch.where(norm_row > 0, (nxt - prev) / norm_row, 0.0)
        by_row = torch.empty((n_pad,), dtype=v.dtype, device=dev)
        by_row[order] = contrib
        edge = torch.empty((n_pad,), dtype=v.dtype, device=dev)
        edge[order] = (is_first | is_last).to(v.dtype)
        rows += [by_row, edge]
    payload = torch.stack(rows)                       # (2 m_loc, n_pad)
    gp = collectives.all_gather(payload[None], mesh)  # (R, 2 m_loc, n_pad)
    dist = torch.zeros((n_pad,), dtype=v_full.dtype, device=dev)
    boundary = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
    for j in range(nobj):
        d, jj = divmod(j, m_loc)
        dist = dist + gp[d, 2 * jj]
        boundary = torch.maximum(boundary,
                                 (gp[d, 2 * jj + 1] > 0).to(torch.int32))
    dist = torch.where(boundary > 0, float("inf"), dist)
    return lexsort([-dist, r_full])


def sel_nsga2_sharded(key, fitness, k, mesh, axis: str | None = None,
                      front_chunk: int = 256, exchange: str = "indices", ranks: str = "peel",
                      tail: str = "sharded", *, n=None, quantum: int = 1):
    """NSGA-II selection with the dominance work sharded over the mesh:
    ``fitness`` is this rank's block (a :class:`~deap_tpu_torch.base.
    Fitness` or weighted values); the ``k`` selected global indices come
    back equal on every rank, index-identical to
    :func:`deap_tpu_torch.ops.emo.sel_nsga2` for every ``ranks`` /
    ``tail`` / ``exchange``.  ``key`` is unused.  ``tail="replicated"``
    gathers ranks and values and runs the single-card crowding tail."""
    del key
    if tail not in ("sharded", "replicated"):
        raise ValueError(f"unknown tail {tail!r}")
    w, values = _wv(fitness)
    sh = _layout(w, mesh, n, quantum)
    ranks_loc, _ = nondominated_ranks_sharded(
        w, mesh, axis=axis, front_chunk=front_chunk,
        stop_at_k=int(k), exchange=exchange, method=ranks, n=sh.n,
        quantum=quantum)
    if tail == "sharded":
        order = _crowding_tail_sharded(ranks_loc, values, mesh, sh)
    else:
        r_full = collectives.all_gather(
            _pad_rows(ranks_loc, sh.n_loc, sh.n).contiguous(), mesh)[:sh.n]
        v_full = collectives.all_gather(
            _pad_rows(values, sh.n_loc, 0.0).contiguous(), mesh)[:sh.n]
        dist = assign_crowding_dist(v_full, r_full)
        order = lexsort([-dist, r_full])
    return order[:k]
