"""GP variation operators — the PyTorch counterparts of
``deap_tpu/gp/variation.py``: subtree bounds, node depths, one-point
crossover (plain and leaf-biased) and uniform subtree mutation.

The JAX package writes each operator for one tree and ``jax.vmap``s it
over per-row keys.  Here every operator works over a leading row axis
with one key per row — ``keys`` ``(n, w)`` (``w`` the key width), trees
``codes``/``consts`` ``(n, cap)`` and ``lengths`` ``(n,)`` — and row
``i`` equals the JAX operator on ``keys[i]`` under threefry2x32 keys
(under rbg keys jax's ``vmap`` draws every row from the first row's
key, and the GP operators are not held to it).  The operators carry
the ``rowwise_op`` mark, so :func:`deap_tpu_torch.algorithms.var_and`
calls them once with ``split(key, n)``, as the JAX package's
``jax.vmap(tool)(split(key, n), ...)``.  Called with one key and one tree (the JAX package's per-tree
form, as in ``lambda k, t: gp.mut_uniform(k, t, expr, pset)``) they
return one tree (:func:`deap_tpu_torch.ops._dispatch.rowwise_op`).

For prefix arrays the subtree rooted at ``i`` ends at the first ``j >=
i`` where ``cumsum(1 - arity)`` exceeds its value before ``i`` by one.
Crossover and mutation are then three-segment splices (head, donor
subtree, tail); a child that would overflow the capacity leaves its
parent unchanged.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

from .. import random
from ..ops._dispatch import rowwise_op
from .pset import freeze_pset

__all__ = ["subtree_bounds", "node_depths", "tree_height", "cx_one_point",
           "cx_one_point_leaf_biased", "mut_uniform"]


def _surplus(codes, lengths, arity):
    """cumsum(1 - arity) over the valid tokens of each row."""
    cap = codes.shape[1]
    p = torch.arange(cap, device=codes.device)
    contrib = torch.where(p[None, :] < lengths[:, None],
                          1 - arity[codes.long()], 0)
    return torch.cumsum(contrib, dim=1)


def _first_true(hit):
    """Index of the first True of each row (0 where none)."""
    return torch.argmax(hit.to(torch.int8), dim=-1)


def subtree_bounds(codes, lengths, i, arity):
    """(start, end) per row of the subtree rooted at ``i`` (reference
    searchSubtree).  ``arity`` is the pset's arity table as a tensor."""
    cap = codes.shape[1]
    i = i.long()
    s = _surplus(codes, lengths, arity)
    base = torch.where(i > 0, s.gather(1, (i - 1).clamp(min=0)[:, None])[:, 0],
                       0)
    k = torch.arange(cap, device=codes.device)
    hit = (k[None, :] >= i[:, None]) & (s - base[:, None] == 1)
    end = _first_true(hit) + 1
    return i, torch.where(hit.any(dim=1), end, lengths.long())


def _all_subtree_ends(codes, lengths, arity):
    """end[j] of every root j per row: ``(n, cap)``."""
    cap = codes.shape[1]
    s = _surplus(codes, lengths, arity)
    base = torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1)
    k = torch.arange(cap, device=codes.device)
    hit = ((k[None, :] >= k[:, None])[None]
           & (s[:, None, :] - base[:, :, None] == 1))
    ends = _first_true(hit) + 1
    return torch.where(hit.any(dim=2), ends, lengths.long()[:, None])


def node_depths(codes, lengths, arity):
    """depth[i] = #ancestors of node i = #{j < i : end_j > i}."""
    cap = codes.shape[1]
    ends = _all_subtree_ends(codes, lengths, arity)
    k = torch.arange(cap, device=codes.device)
    anc = (k[:, None] > k[None, :])[None] & (ends[:, None, :] > k[None, :, None])
    return anc.sum(dim=2)


def tree_height(codes, lengths, arity):
    """Height of each tree (reference PrimitiveTree.height)."""
    d = node_depths(codes, lengths, arity)
    p = torch.arange(codes.shape[1], device=codes.device)
    return torch.where(p[None, :] < lengths[:, None], d, 0).max(dim=1).values


def _splice(dst, dst_consts, l_dst, i, j, src, src_consts, a, b):
    """Replace ``dst[i:j]`` with ``src[a:b]`` per row; returns (codes,
    consts, new_len, fits).  A row whose result would overflow the
    capacity keeps ``dst`` with fits=False."""
    cap = dst.shape[1]
    l_dst = l_dst.long()
    i, j, a, b = (v.long()[:, None] for v in (i, j, a, b))
    seg = b - a
    new_len = i + seg + (l_dst[:, None] - j)
    fits = new_len <= cap
    p = torch.arange(cap, device=dst.device)[None, :]
    src_idx = torch.clamp(a + (p - i), 0, cap - 1)
    tail_idx = torch.clamp(j + (p - i - seg), 0, cap - 1)
    head = p < i
    mid = p < i + seg
    out = torch.where(head, dst, torch.where(mid, src.gather(1, src_idx),
                                             dst.gather(1, tail_idx)))
    out_c = torch.where(head, dst_consts,
                        torch.where(mid, src_consts.gather(1, src_idx),
                                    dst_consts.gather(1, tail_idx)))
    live = p < new_len
    out = torch.where(live, out, 0)
    out_c = torch.where(live, out_c, 0.0)
    return (torch.where(fits, out, dst), torch.where(fits, out_c, dst_consts),
            torch.where(fits[:, 0], new_len[:, 0], l_dst), fits[:, 0])


def _expr_takes_type(expr: Callable) -> bool:
    """Whether ``expr`` accepts a second (return-type) argument, read from
    its signature."""
    try:
        sig = inspect.signature(expr)
    except (TypeError, ValueError):
        return True
    n = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return True
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
    return n >= 2


def _masked_choice(keys, mask, fallback=0):
    """Per row, a uniform index among the True entries of ``mask`` (the
    first index of the largest draw), ``fallback`` where there is none."""
    u = random.uniform(keys, (mask.shape[1],))
    pick = torch.argmax(torch.where(mask, u, -1.0), dim=1)
    return torch.where(mask.any(dim=1), pick, fallback)


def _cx(keys, t1, t2, pset, termpb):
    f = freeze_pset(pset)
    t = f.tables(keys.device)
    arity, rtype = t["arity"], t["ret_type"]
    c1, k1cst, l1 = t1
    c2, k2cst, l2 = t2
    cap = c1.shape[1]
    ks = random.split(keys, 4)
    k_i1, k_i2, k_b1, k_b2 = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    p = torch.arange(cap, device=keys.device)[None, :]
    rt1, rt2 = rtype[c1.long()], rtype[c2.long()]
    l1c, l2c = l1.long()[:, None], l2.long()[:, None]
    # exclude roots when trees have more than one node
    valid1 = (p < l1c) & ((p >= 1) | (l1c <= 1))
    valid2 = (p < l2c) & ((p >= 1) | (l2c <= 1))
    elig1 = valid1 & ((rt1[:, :, None] == rt2[:, None, :])
                      & valid2[:, None, :]).any(dim=2)
    if termpb is not None:
        ks = random.split(k_i1)
        pick_term = random.bernoulli(ks[:, 1], termpb)
        is_term1 = arity[c1.long()] == 0
        bias1 = elig1 & (is_term1 == pick_term[:, None])
        elig1 = torch.where(bias1.any(dim=1, keepdim=True), bias1, elig1)
    i1 = _masked_choice(k_b1, elig1)
    want_t = rt1.gather(1, i1[:, None])
    elig2 = valid2 & (rt2 == want_t)
    if termpb is not None:
        ks = random.split(k_i2)
        pick_term2 = random.bernoulli(ks[:, 1], termpb)
        is_term2 = arity[c2.long()] == 0
        bias2 = elig2 & (is_term2 == pick_term2[:, None])
        elig2 = torch.where(bias2.any(dim=1, keepdim=True), bias2, elig2)
    i2 = _masked_choice(k_b2, elig2)
    ok = elig1.any(dim=1) & elig2.any(dim=1)

    s1, e1 = subtree_bounds(c1, l1, i1, arity)
    s2, e2 = subtree_bounds(c2, l2, i2, arity)
    n1, n1c, nl1, fit1 = _splice(c1, k1cst, l1, s1, e1, c2, k2cst, s2, e2)
    n2, n2c, nl2, fit2 = _splice(c2, k2cst, l2, s2, e2, c1, k1cst, s1, e1)
    keep = ok & fit1 & fit2
    kc = keep[:, None]
    return ((torch.where(kc, n1, c1), torch.where(kc, n1c, k1cst),
             torch.where(keep, nl1, l1.long()).to(l1.dtype)),
            (torch.where(kc, n2, c2), torch.where(kc, n2c, k2cst),
             torch.where(keep, nl2, l2.long()).to(l2.dtype)))


@rowwise_op
def cx_one_point(keys, tree1, tree2, pset):
    """Typed one-point subtree crossover (reference gp.cxOnePoint), one
    key per row pair."""
    return _cx(keys, tree1, tree2, pset, None)


@rowwise_op
def cx_one_point_leaf_biased(keys, tree1, tree2, pset, termpb=0.1):
    """Koza's 90/10 leaf-biased crossover (reference
    cxOnePointLeafBiased): each tree picks a terminal point with
    probability ``termpb`` (a coin per tree), an internal one otherwise."""
    return _cx(keys, tree1, tree2, pset, termpb)


@rowwise_op
def mut_uniform(keys, tree, expr: Callable, pset):
    """Replace a random subtree of each row with a generated one of the
    same return type (reference mutUniform).  ``expr(keys, ret_types) ->
    (codes, consts, lengths)`` — a :func:`make_generator` closure over a
    key batch; a single-type ``expr`` may take the keys only."""
    f = freeze_pset(pset)
    t = f.tables(keys.device)
    codes, consts, lengths = tree
    ks = random.split(keys)
    k_i, k_gen = ks[:, 0], ks[:, 1]
    i = random.randint(k_i, (), 0, lengths.clamp(min=1))
    s, e = subtree_bounds(codes, lengths, i, t["arity"])
    if _expr_takes_type(expr):
        ret = t["ret_type"][codes.long().gather(1, s[:, None])[:, 0]]
        g_codes, g_consts, g_len = expr(k_gen, ret)
    else:
        g_codes, g_consts, g_len = expr(k_gen)
    zero = torch.zeros_like(s)
    n, nc, nl, _ = _splice(codes, consts, lengths, s, e, g_codes, g_consts,
                           zero, g_len)
    return n, nc, nl.to(lengths.dtype)
