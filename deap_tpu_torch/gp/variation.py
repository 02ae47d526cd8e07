"""GP variation operators — the PyTorch counterparts of
``deap_tpu/gp/variation.py``: subtree bounds, node depths, one-point
crossover (plain and leaf-biased), the subtree, node, ephemeral,
insertion and shrink mutations, the geometric semantic operators and the
``static_limit`` bloat decorator.

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

import functools
import inspect
from typing import Callable

import torch

from .. import random
from ..ops._dispatch import rowwise_op
from .pset import freeze_pset

__all__ = ["subtree_bounds", "node_depths", "tree_height", "cx_one_point",
           "cx_one_point_leaf_biased", "mut_uniform", "mut_node_replacement",
           "mut_ephemeral", "mut_insert", "mut_shrink", "static_limit",
           "cx_semantic", "mut_semantic"]


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
    """Height of each tree (reference PrimitiveTree.height); one tree
    ``(cap,)`` gives a scalar."""
    if codes.ndim == 1:
        lengths = torch.as_tensor(lengths, device=codes.device).reshape(1)
        return tree_height(codes[None], lengths, arity)[0]
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


def _switch_consts(f, keys, code):
    """Every node's constant drawn from ``keys`` ``(*batch, w)``, then the
    one of ``code`` ``(*batch)`` picked: ``lax.switch(code,
    f.const_fns, key)`` under ``jax.vmap``, which computes every branch
    for every row."""
    batch = keys.shape[:-1]
    flat = keys.reshape(-1, keys.shape[-1])
    vals = torch.stack([fn(flat) for fn in f.const_fns])       # (nodes, N)
    return vals.gather(0, code.reshape(1, -1).long())[0].reshape(batch)


def _keep_rows(keep, new, old):
    """``(codes, consts, lengths)``: ``new`` where ``keep``, else ``old``."""
    k = keep[:, None]
    return (torch.where(k, new[0], old[0]), torch.where(k, new[1], old[1]),
            torch.where(keep, new[2].long(), old[2].long()).to(old[2].dtype))


@rowwise_op
def mut_node_replacement(keys, tree, pset):
    """Replace a random node of each row with another of the same
    signature (reference mutNodeReplacement): primitives with primitives
    of the same arity and types, terminals with terminals of the same
    type; a new terminal brings its constant (a fresh draw for an
    ephemeral)."""
    f = freeze_pset(pset)
    t = f.tables(keys.device)
    arity, rtype, in_types = t["arity"], t["ret_type"], t["in_types"]
    codes, consts, lengths = tree
    ks = random.split(keys, 3)
    k_i, k_pick, k_const = ks[:, 0], ks[:, 1], ks[:, 2]
    i = random.randint(k_i, (), 0, lengths.clamp(min=1)).long()[:, None]
    c = codes.long().gather(1, i)[:, 0]
    same_sig = ((rtype[None, :] == rtype[c][:, None])
                & (arity[None, :] == arity[c][:, None])
                & (in_types[None] == in_types[c][:, None]).all(dim=2))
    new_c = _masked_choice(k_pick, same_sig, fallback=c)
    const = _switch_consts(f, k_const, new_c)
    fresh = t["is_ephemeral"][new_c] | (arity[new_c] == 0)
    old_c = consts.gather(1, i)[:, 0]
    return (codes.scatter(1, i, new_c.to(codes.dtype)[:, None]),
            consts.scatter(1, i, torch.where(fresh, const, old_c)[:, None]),
            lengths)


@rowwise_op
def mut_ephemeral(keys, tree, pset, mode: str = "one"):
    """Re-draw ephemeral constants (reference mutEphemeral): mode
    ``"one"`` re-samples one random ephemeral node of each row, any other
    mode every one.  Every node draws from its own key, ``split(key,
    cap)``, as in the JAX package."""
    f = freeze_pset(pset)
    t = f.tables(keys.device)
    codes, consts, lengths = tree
    n, cap = codes.shape
    ks = random.split(keys)
    k_pick, k_new = ks[:, 0], ks[:, 1]
    p = torch.arange(cap, device=keys.device)[None, :]
    mask = t["is_ephemeral"][codes.long()] & (p < lengths[:, None])
    if mode == "one":
        i = _masked_choice(k_pick, mask)
        sel = (p == i[:, None]) & mask.any(dim=1, keepdim=True)
    else:
        sel = mask
    new_consts = _switch_consts(f, random.split(k_new, cap), codes)
    return codes, torch.where(sel, new_consts, consts), lengths


@rowwise_op
def mut_insert(keys, tree, pset):
    """Insert a primitive above a random subtree of each row (reference
    mutInsert): the old subtree becomes one of its arguments (a slot of
    its type), the others new terminals.  Only primitives whose every
    argument type has terminals qualify; a row with no candidate, or
    whose child would overflow the capacity, is unchanged."""
    f = freeze_pset(pset)
    dev = keys.device
    t = f.tables(dev)
    arity, rtype, in_types = t["arity"], t["ret_type"], t["in_types"]
    term_arr, term_cnt = t["term_arr"], t["term_cnt"]
    fillable = torch.as_tensor(f.args_have_terminals, device=dev)
    ma = max(f.max_arity, 1)
    codes, consts, lengths = tree
    n, cap = codes.shape
    w = keys.shape[-1]
    ks = random.split(keys, 5)
    k_i, k_p, k_slot, k_terms, k_consts = (ks[:, j] for j in range(5))
    i = random.randint(k_i, (), 0, lengths.clamp(min=1)).long()
    ty = rtype[codes.long().gather(1, i[:, None])[:, 0]]          # (n,)
    j = torch.arange(ma, device=dev)
    accepts = ((in_types[None] == ty[:, None, None])
               & (j[None, None, :] < arity[None, :, None])).any(dim=2)
    cand = ((rtype[None, :] == ty[:, None]) & (arity > 0)[None, :]
            & accepts & fillable[None, :])
    p_code = _masked_choice(k_p, cand)
    ok = cand.any(dim=1)
    a = arity[p_code]
    arg_t = in_types[p_code]                                      # (n, ma)
    slot_ok = (arg_t == ty[:, None]) & (j[None, :] < a[:, None])
    slot = _masked_choice(k_slot, slot_ok)
    s, e = subtree_bounds(codes, lengths, i, arity)
    sub_len = e - s
    seg_len = a + sub_len
    # the terminal of each slot and its constant, one key a slot
    tk = random.split(k_terms, ma).reshape(-1, w)
    pick = random.randint(tk, (), 0, term_cnt[arg_t].clamp(min=1).reshape(-1))
    fill = term_arr[arg_t, pick.long().reshape(n, ma)]
    ck = random.split(k_consts, ma)
    fill_consts = _switch_consts(f, ck, fill)
    # layout: the primitive, then each slot j < a one terminal wide or,
    # at ``slot``, the old subtree
    widths = torch.where(j[None, :] == slot[:, None], sub_len[:, None], 1) \
        * (j[None, :] < a[:, None])
    offsets = 1 + torch.cat([torch.zeros_like(widths[:, :1]),
                             torch.cumsum(widths, dim=1)[:, :-1]], dim=1)
    p = torch.arange(cap, device=dev)[None, :]
    seg = torch.where(p == 0, p_code[:, None], 0)
    seg_c = torch.zeros_like(consts)
    for jj in range(ma):
        at = ((p == offsets[:, jj:jj + 1])
              & ((jj < a) & (jj != slot))[:, None])
        seg = torch.where(at, fill[:, jj:jj + 1], seg)
        seg_c = torch.where(at, fill_consts[:, jj:jj + 1], seg_c)
    off_slot = offsets.gather(1, slot[:, None])
    in_sub = (p >= off_slot) & (p < off_slot + sub_len[:, None])
    sub_src = torch.clamp(s[:, None] + (p - off_slot), 0, cap - 1)
    seg = torch.where(in_sub, codes.long().gather(1, sub_src), seg)
    seg_c = torch.where(in_sub, consts.gather(1, sub_src), seg_c)
    nc, nk, nl, fits = _splice(codes, consts, lengths, s, e,
                               seg.to(codes.dtype), seg_c,
                               torch.zeros_like(s), seg_len)
    return _keep_rows(ok & fits, (nc, nk, nl), tree)


@rowwise_op
def mut_shrink(keys, tree, pset):
    """Replace a random primitive of each row by one of its argument
    subtrees of the same type (reference mutShrink); a row with no such
    primitive is unchanged."""
    f = freeze_pset(pset)
    dev = keys.device
    t = f.tables(dev)
    arity, rtype = t["arity"], t["ret_type"]
    codes, consts, lengths = tree
    cap = codes.shape[1]
    ks = random.split(keys)
    k_i, k_arg = ks[:, 0], ks[:, 1]
    p = torch.arange(cap, device=dev)[None, :]
    cl = codes.long()
    is_prim = (arity[cl] > 0) & (p < lengths[:, None])
    i = _masked_choice(k_i, is_prim)
    ok = is_prim.any(dim=1)
    s, e = subtree_bounds(codes, lengths, i, arity)
    ends = _all_subtree_ends(codes, lengths, arity)
    # the children's starts: the first at i + 1, each next one at the end
    # of the one before
    ma = max(f.max_arity, 1)
    starts = [i + 1]
    for _ in range(ma - 1):
        starts.append(ends.gather(1, starts[-1].clamp(0, cap - 1)[:, None])
                      [:, 0])
    starts = torch.stack(starts, dim=1)                           # (n, ma)
    ci = cl.gather(1, i[:, None])[:, 0]
    a = arity[ci]
    j = torch.arange(ma, device=dev)
    match = ((j[None, :] < a[:, None])
             & (rtype[cl.gather(1, starts.clamp(0, cap - 1))]
                == rtype[ci][:, None]))
    which = _masked_choice(k_arg, match)
    ok = ok & match.any(dim=1)
    cs = starts.gather(1, which[:, None])[:, 0]
    ce = ends.gather(1, cs.clamp(0, cap - 1)[:, None])[:, 0]
    nc, nk, nl, fits = _splice(codes, consts, lengths, s, e, codes, consts,
                               cs, ce)
    return _keep_rows(ok & fits, (nc, nk, nl), tree)


def _append(state, src, src_consts, a, b):
    """Append ``src[a:b]`` after each row's tree (``_splice`` into an
    empty window at the row's length); ``state`` is ``(codes, consts,
    lengths, ok)`` and ``ok`` turns False on a row that overflowed."""
    c, k, l, ok = state
    cap = c.shape[1]
    if src.shape[1] < cap:                  # a short literal: zero-padded
        pad = cap - src.shape[1]
        src = torch.nn.functional.pad(src, (0, pad))
        src_consts = torch.nn.functional.pad(src_consts, (0, pad))
    c, k, l, fit = _splice(c, k, l, l, l, src, src_consts, a, b)
    return c, k, l, ok & fit


def _literal(rows, values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device).expand(rows, -1)


def _scalar_code(f):
    """A terminal or ephemeral code whose node reads its constant, to
    carry literal scalars (the semantic step, the constant 1.0): a plain
    terminal first, which ``mut_ephemeral`` never re-draws, else an
    ephemeral.  Arguments read ``X`` and do not qualify."""
    fallback = None
    for i in range(f.n_nodes):
        if not f.is_primitive[i] and not f.is_argument[i]:
            if not f.is_ephemeral[i]:
                return i
            if fallback is None:
                fallback = i
    if fallback is not None:
        return fallback
    raise AssertionError(
        "Semantic operators need at least one constant terminal or "
        "ephemeral in the primitive set to encode literal scalars.")


def _semantic_codes(f):
    """Codes of the lf/mul/add/sub primitives the semantic operators
    compose with (the reference asserts the same four names)."""
    codes = {}
    for name in ("lf", "mul", "add", "sub"):
        assert name in f.pset.mapping, (
            f"A '{name}' function is required in order to perform semantic "
            "variation")
        codes[name] = f.code_of(name)
    return codes


def _semantic_expr(pset, cap, expr, min_, max_):
    if expr is not None:
        return expr
    from .generate import make_generator
    gen = make_generator(pset, cap, "grow")
    return lambda k: gen(k, min_, max_)


@rowwise_op
def mut_semantic(keys, tree, pset, expr: Callable | None = None, ms=None,
                 min_=2, max_=6):
    """Geometric semantic mutation (reference mutSemantic): ``child = ind
    + ms * (lf(tr1) - lf(tr2))`` built as the prefix layout ``[add] ind
    [mul ms sub lf] tr1 [lf] tr2``.  ``expr(keys) -> trees`` makes the
    random trees (a grow generator at depth ``min_``-``max_`` by
    default); ``ms`` is the step (``U(0, 2)`` a row by default).  A
    child that overflows the capacity leaves its parent unchanged."""
    f = freeze_pset(pset)
    codes, consts, lengths = tree
    n, cap = codes.shape
    dev = keys.device
    sem = _semantic_codes(f)
    ms_code = _scalar_code(f)
    expr = _semantic_expr(pset, cap, expr, min_, max_)
    ks = random.split(keys, 3)
    t1c, t1k, t1l = expr(ks[:, 0])
    t2c, t2k, t2l = expr(ks[:, 1])
    if ms is None:
        ms = random.uniform(ks[:, 2], (), minval=0.0, maxval=2.0)
    ms = torch.as_tensor(ms, dtype=consts.dtype, device=dev).expand(n)
    ct, kt = codes.dtype, consts.dtype
    glue = _literal(n, [sem["mul"], ms_code, sem["sub"], sem["lf"]], ct, dev)
    glue_c = torch.stack([torch.zeros_like(ms), ms, torch.zeros_like(ms),
                          torch.zeros_like(ms)], dim=1)
    head = _literal(n, [sem["add"]], ct, dev)
    lf1 = _literal(n, [sem["lf"]], ct, dev)
    zero1 = torch.zeros((n, 1), dtype=kt, device=dev)
    zero = torch.zeros_like(lengths)
    out = (torch.zeros_like(codes), torch.zeros_like(consts),
           torch.zeros_like(lengths), torch.ones(n, dtype=torch.bool,
                                                  device=dev))
    out = _append(out, head, zero1, zero, zero + 1)
    out = _append(out, codes, consts, zero, lengths)
    out = _append(out, glue, glue_c, zero, zero + 4)
    out = _append(out, t1c, t1k, zero, t1l)
    out = _append(out, lf1, zero1, zero, zero + 1)
    out = _append(out, t2c, t2k, zero, t2l)
    return _keep_rows(out[3], out[:3], tree)


@rowwise_op
def cx_semantic(keys, tree1, tree2, pset, expr: Callable | None = None,
                min_=2, max_=6):
    """Geometric semantic crossover (reference cxSemantic): ``child1 =
    lf(tr)*ind1 + (1 - lf(tr))*ind2`` and the symmetric child2, as the
    prefix layout ``[add mul lf] tr ind1 [mul sub 1.0 lf] tr ind2``, one
    random tree a row from ``expr(keys)``.  A child that overflows the
    capacity falls back to its parent."""
    f = freeze_pset(pset)
    c1 = tree1[0]
    n, cap = c1.shape
    dev = keys.device
    sem = _semantic_codes(f)
    one_code = _scalar_code(f)
    expr = _semantic_expr(pset, cap, expr, min_, max_)
    trc, trk, trl = expr(keys)
    ct, kt = c1.dtype, tree1[1].dtype
    head = _literal(n, [sem["add"], sem["mul"], sem["lf"]], ct, dev)
    zero3 = torch.zeros((n, 3), dtype=kt, device=dev)
    mid = _literal(n, [sem["mul"], sem["sub"], one_code, sem["lf"]], ct, dev)
    mid_c = _literal(n, [0.0, 0.0, 1.0, 0.0], kt, dev)

    def build(pa, pb):
        zero = torch.zeros_like(pa[2])
        out = (torch.zeros_like(pa[0]), torch.zeros_like(pa[1]),
               torch.zeros_like(pa[2]), torch.ones(n, dtype=torch.bool,
                                                   device=dev))
        out = _append(out, head, zero3, zero, zero + 3)
        out = _append(out, trc, trk, zero, trl)
        out = _append(out, pa[0], pa[1], zero, pa[2])
        out = _append(out, mid, mid_c, zero, zero + 4)
        out = _append(out, trc, trk, zero, trl)
        out = _append(out, pb[0], pb[1], zero, pb[2])
        return _keep_rows(out[3], out[:3], pa)

    return build(tree1, tree2), build(tree2, tree1)


def static_limit(key_fn: Callable, max_value, pset=None):
    """Bloat-control decorator (reference staticLimit): where an offspring
    exceeds ``max_value`` under ``key_fn`` (a height or a length), its
    parent takes its place.

    It wraps ``op(keys, tree, ...) -> tree`` and ``op(keys, t1, t2, ...)
    -> (t1', t2')``; the trees are the arguments that are
    ``(codes, consts, lengths)`` triples.  A ``rowwise_op`` stays one:
    ``key_fn`` then gets the batch of children and returns one value a
    row, also when the wrapper is called with one key and one tree.  An
    unmarked ``op`` is wrapped as it is, and ``key_fn`` gets what it
    returns."""
    del pset

    def decorator(op):
        def wrapper(keys, *trees_and_args, **kwargs):
            trees = [a for a in trees_and_args
                     if isinstance(a, tuple) and len(a) == 3]
            out = op(keys, *trees_and_args, **kwargs)
            kids = list(out) if isinstance(out[0], tuple) else [out]
            result = []
            for parent, child in zip(trees, kids):
                over = torch.as_tensor(key_fn(child) > max_value)
                result.append(tuple(
                    torch.where(over.reshape(over.shape + (1,) * (
                        ch.ndim - over.ndim)), pa, ch)
                    for pa, ch in zip(parent, child)))
            return tuple(result) if len(result) > 1 else result[0]

        functools.update_wrapper(wrapper, op)
        if getattr(op, "rowwise", False):
            return rowwise_op(wrapper)
        wrapper.__dict__.pop("rowwise", None)
        return wrapper

    return decorator
