"""The sorting-network model — the port's counterpart of
``examples/ga/sortingnetwork.py`` (reference
``examples/ga/sortingnetwork.py``): a network is a fixed-capacity genome
``{"wires": (cap, 2) int32, "length": () int32}``; a comparator lands
one level past the deepest level whose wire intervals overlap it (the
reference's ``addConnector``); the network runs its comparators in
(level, insertion) order; and it is assessed on all ``2^dim`` binary
inputs (the zero-one principle).

Everything here takes a batch of networks (a leading row axis): the
greedy level assignment is ``cap`` steps over the batch's per-level
wire masks, and the network runs ``cap`` comparator steps over a
``(networks, cases, dim)`` tensor."""

from __future__ import annotations

import numpy as np
import torch


def _interval(wires):
    return (torch.minimum(wires[..., 0], wires[..., 1]),
            torch.maximum(wires[..., 0], wires[..., 1]))


def assign_levels(wires, length, cap: int, dim: int):
    """Greedy level of each connector of ``(n, cap, 2)`` networks of
    ``length`` ``(n,)`` connectors: one past the deepest level whose
    covered interval overlaps the connector's; no-op connectors (both
    wires equal) and slots past ``length`` get the sentinel ``cap``.
    Returns ``(levels (n, cap), depth (n,))``."""
    n = wires.shape[0]
    dev = wires.device
    lo, hi = _interval(wires)
    col = torch.arange(dim, device=dev)
    slots = torch.arange(cap, device=dev)
    rows = torch.arange(n, device=dev)
    level_mask = torch.zeros((n, cap, dim), dtype=torch.bool, device=dev)
    levels = []
    for i in range(cap):
        a, b = lo[:, i, None], hi[:, i, None]
        m = (col >= a) & (col <= b)                                # (n, dim)
        active = (i < length) & (lo[:, i] != hi[:, i])
        conflicts = (level_mask & m[:, None, :]).any(-1)           # (n, cap)
        deepest = torch.where(conflicts, slots, -1).max(-1).values
        place = torch.clamp(deepest + 1, 0, cap - 1)
        new = level_mask[rows, place] | m
        level_mask[rows, place] = torch.where(active[:, None], new,
                                              level_mask[rows, place])
        levels.append(torch.where(active, place, cap))
    levels = torch.stack(levels, 1).to(torch.int32)
    depth = torch.where(levels < cap, levels + 1, 0).max(-1).values
    return levels, depth


def apply_network(wires, length, cases, levels=None):
    """Every comparator of ``(n, cap, 2)`` networks over ``(n, ncase,
    dim)`` inputs in (level, insertion) order (the reference's level
    sweep); ``levels`` from :func:`assign_levels` if already known."""
    n, cap = wires.shape[:2]
    dim = cases.shape[-1]
    if levels is None:
        levels, _ = assign_levels(wires, length, cap, dim)
    lo, hi = _interval(wires)
    slots = torch.arange(cap, device=wires.device)
    order = torch.argsort(levels.long() * (cap + 1) + slots, dim=1)
    lo, hi = lo.gather(1, order).long(), hi.gather(1, order).long()
    active = levels.gather(1, order) < cap
    vals = cases.clone()
    for c in range(cap):
        a = lo[:, c, None, None].expand(-1, vals.shape[1], 1)
        b = hi[:, c, None, None].expand(-1, vals.shape[1], 1)
        va, vb = vals.gather(2, a), vals.gather(2, b)
        on = active[:, c, None, None]
        vals.scatter_(2, a, torch.where(on, torch.minimum(va, vb), va))
        vals.scatter_(2, b, torch.where(on, torch.maximum(va, vb), vb))
    return vals


def all_binary_cases(dim: int, device=None) -> torch.Tensor:
    """All ``2^dim`` 0/1 sequences, bit ``j`` of ``i`` in column ``j``."""
    i = torch.arange(1 << dim, device=device)[:, None]
    return ((i >> torch.arange(dim, device=device)) & 1).to(torch.float32)


def assess(wires, length, cases, levels=None):
    """Unsorted outputs over ``cases`` ``(ncase, dim)`` of each of ``(n,
    cap, 2)`` networks: ``(n,)`` int64."""
    out = apply_network(wires, length,
                        cases.expand(wires.shape[0], -1, -1), levels)
    expect = torch.sort(out, dim=2).values
    return (out != expect).any(2).sum(1)


def draw(wires_np, length, dim) -> str:
    """ASCII rendering on the host (the reference's layout: one 7-char
    column a level, 'x' endpoints joined by '|')."""
    wires_np = np.asarray(wires_np)[:int(length)]
    n = len(wires_np)
    if n:
        levels, _ = assign_levels(torch.as_tensor(wires_np)[None],
                                  torch.tensor([n]), n, dim)
        levels = levels[0].numpy()
    else:
        levels = np.zeros(0, np.int32)
    depth = int(levels[levels < n].max() + 1) if n else 0
    rows = [list(f"{w}" + " o" + "-" * (7 * depth)) for w in range(dim)]
    gaps = [[" "] * (3 + 7 * depth) for _ in range(dim - 1)]
    for (a, b), lvl in zip(wires_np, levels):
        a, b = int(min(a, b)), int(max(a, b))
        if a == b:
            continue
        col = 3 + int(lvl) * 7 + 3
        rows[a][col] = "x"
        rows[b][col] = "x"
        for w in range(a, b):
            gaps[w][col] = "|"
        for w in range(a + 1, b):
            rows[w][col] = "|"
    out = []
    for w in range(dim):
        out.append("".join(rows[w]))
        if w < dim - 1:
            out.append("".join(gaps[w]))
    return "\n".join(out)
