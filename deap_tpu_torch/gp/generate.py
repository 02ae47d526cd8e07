"""GP tree generation — the PyTorch counterpart of ``deap_tpu/gp/generate.py``
(reference ``genFull``/``genGrow``/``genHalfAndHalf``).

The JAX package runs the reference's typed-stack algorithm as a
``lax.while_loop`` per tree and ``jax.vmap``s it over per-row keys.  Here
one call generates a whole batch: ``gen(keys (n, w), ...)`` runs a fixed
number of masked iterations over all rows (a row whose loop has ended
keeps its state) with no host read, and row ``i`` equals the JAX
generator on ``keys[i]`` for threefry2x32 keys.  rbg keys run too, but
jax's ``vmap`` of a ``while_loop`` draws each iteration from the first
row's key, which this bulk draw does not follow: GP under rbg is not held
to the JAX package.

The key law is the JAX function's: ``split(key, 3)`` for the height and
the kind, then ``split(key, 4)`` per emitted token for the next key, the
terminal coin, the pick (one draw shared by the terminal and the
primitive pick: only one is used) and the constant, which is drawn for
every token.  A row emits token ``t`` in iteration ``t`` while its loop
runs, so the chain of keys and every draw are computed for all tokens in
bulk before the loop, and the loop only applies the modulus law to the
pick bits with the row's candidate count.

The number of iterations is fixed before the loop, from static inputs
only: ``cap``, or fewer when every type has a terminal — then no node
lies deeper than ``max_depth`` and a tree has at most ``sum(a**d for d
in 0..max_depth)`` nodes (``a`` the largest arity), and later
iterations would find every row's loop ended (``mut_uniform``'s depth
0-2 subtrees need 7 of the 64 iterations of a capacity-64 buffer).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import random
from .pset import freeze_pset

__all__ = ["make_generator", "gen_full", "gen_grow", "gen_half_and_half"]


def _draws(f, key, n_iter: int):
    """Every draw of ``n_iter`` iterations: terminal coins ``(n,
    n_iter)``, pick bits ``(n, n_iter)`` x 2, and each node's constant
    ``(n_nodes, n, n_iter)`` (the constant a token of that code would
    get)."""
    chain = []
    for _ in range(n_iter):
        ks = random.split(key, 4)                        # (n, 4, w)
        chain.append(ks)
        key = ks[:, 0]
    ks = torch.stack(chain, dim=1)                    # (n, n_iter, 4, w)
    u_term = random.uniform(ks[:, :, 1])
    higher, lower = random.randint_bits(ks[:, :, 2], ())
    k_const = ks[:, :, 3].reshape(-1, ks.shape[-1])
    n = ks.shape[0]
    consts = torch.stack([fn(k_const).reshape(n, n_iter)
                          for fn in f.const_fns])
    return u_term, higher, lower, consts


def make_generator(pset, cap: int, kind: str = "half_and_half") -> Callable:
    """Build ``gen(keys (n, w), min_depth, max_depth, ret_type=None) ->
    (codes (n, cap) int32, consts (n, cap) float32, lengths (n,) int32)``
    — masked iterations over all rows, no host read.

    ``kind``: "full", "grow" or "half_and_half" (a coin per tree).
    ``min_depth``/``max_depth`` are ints; ``ret_type`` is a type id or a
    ``(n,)`` tensor of them (typed ``mut_uniform`` passes the replaced
    subtree's type).  One key ``(2,)`` (the JAX package's per-tree form)
    gives one tree, ``(cap,)``, ``(cap,)`` and a scalar length.  Raises
    at construction if a reachable argument type has no terminal."""
    if kind not in ("full", "grow", "half_and_half"):
        raise ValueError(f"unknown generator kind {kind!r}")
    f = freeze_pset(pset)
    term_cnt_np = f.term_by_type[1]
    reachable = {f.pset.ret}
    for i in range(f.n_nodes):
        if f.is_primitive[i]:
            reachable.update(int(t) for t in f.in_types[i, :f.arity[i]])
    missing = [t for t in reachable if term_cnt_np[t] == 0]
    if missing:
        raise ValueError(
            f"The primitive set has no terminal for type id(s) {missing}; "
            "tree generation cannot terminate. Add a terminal of that type "
            "(reference gp.generate raises IndexError for this, "
            "gp.py:612-617).")
    max_arity = max(f.max_arity, 1)
    ratio = float(np.float32(f.terminal_ratio))
    depth_bounded = bool((term_cnt_np > 0).all())

    def iterations(max_depth: int) -> int:
        if not depth_bounded:
            return cap
        return min(cap, sum(max_arity ** d for d in range(max_depth + 1)))

    def gen(keys, min_depth: int, max_depth: int, ret_type=None):
        if keys.ndim == 1:
            if torch.is_tensor(ret_type):
                ret_type = ret_type.reshape(1)
            return tuple(x[0] for x in gen(keys[None], min_depth,
                                           max_depth, ret_type))
        dev = keys.device
        t = f.tables(dev)
        n = keys.shape[0]
        ks = random.split(keys, 3)
        height = random.randint(ks[:, 0], (), min_depth, max_depth + 1)
        if kind == "full":
            grow = torch.zeros((n,), dtype=torch.bool, device=dev)
        elif kind == "grow":
            grow = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            grow = random.bernoulli(ks[:, 1], 0.5)
        n_iter = iterations(max_depth)
        u_term, higher, lower, node_consts = _draws(f, ks[:, 2], n_iter)

        rows = torch.arange(n, device=dev)
        depth_rows = cap + max_arity
        codes = torch.zeros((n, cap), dtype=torch.int64, device=dev)
        consts = torch.zeros((n, cap), dtype=torch.float32, device=dev)
        st_type = torch.zeros((n, depth_rows), dtype=torch.int64, device=dev)
        st_type[:, 0] = f.pset.ret if ret_type is None else \
            torch.as_tensor(ret_type, device=dev).to(torch.int64)
        st_depth = torch.zeros((n, depth_rows), dtype=torch.int64, device=dev)
        pos = torch.zeros((n,), dtype=torch.int64, device=dev)
        sp = torch.ones((n,), dtype=torch.int64, device=dev)
        lanes = torch.arange(max_arity, device=dev)
        height = height.to(torch.int64)
        for it in range(n_iter):
            active = (sp > 0) & (pos < cap)
            top = (sp - 1).clamp(min=0)
            ty = st_type[rows, top]
            d = st_depth[rows, top]
            sp1 = sp - 1
            t_term_cnt = t["term_cnt"][ty]
            t_prim_cnt = t["prim_cnt"][ty]
            has_prim = t_prim_cnt > 0
            has_term = t_term_cnt > 0
            at_bottom = d >= height
            grow_term = (d >= min_depth) & (u_term[:, it] < ratio)
            want_term = at_bottom | (grow & grow_term)
            must_term = (pos + sp1 + max_arity) >= cap
            choose_term = (want_term & has_term) | must_term | ~has_prim
            hi, lo = higher[:, it], lower[:, it]
            tpick = random.randint_from_bits(hi, lo, 0,
                                             t_term_cnt.clamp(min=1)).long()
            ppick = random.randint_from_bits(hi, lo, 0,
                                             t_prim_cnt.clamp(min=1)).long()
            code = torch.where(choose_term, t["term_arr"][ty, tpick],
                               t["prim_arr"][ty, ppick])
            const = node_consts[code, rows, it]
            codes[:, it] = torch.where(active, code, codes[:, it])
            consts[:, it] = torch.where(active, const, consts[:, it])

            # push the primitive's argument types right to left, so the
            # leftmost child pops first: rows sp1 + j get in_types[a-1-j]
            a = t["arity"][code]
            rev = (a[:, None] - 1 - lanes[None, :]).clamp(0, max_arity - 1)
            rev_ty = t["in_types"][code[:, None], rev]         # (n, ma)
            for j in range(max_arity):
                slot = (sp1 + j).clamp(0, depth_rows - 1)
                write = active & (j < a)
                st_type[rows, slot] = torch.where(
                    write, rev_ty[:, j], st_type[rows, slot])
                st_depth[rows, slot] = torch.where(
                    write, d + 1, st_depth[rows, slot])
            sp = torch.where(active, sp1 + a, sp)
            pos = torch.where(active, pos + 1, pos)
        return codes.to(torch.int32), consts, pos.to(torch.int32)

    return gen


def gen_full(keys, pset, min_, max_, cap: int = 64):
    """Full-method trees (reference genFull), one per key."""
    return make_generator(pset, cap, "full")(keys, min_, max_)


def gen_grow(keys, pset, min_, max_, cap: int = 64):
    """Grow-method trees (reference genGrow), one per key."""
    return make_generator(pset, cap, "grow")(keys, min_, max_)


def gen_half_and_half(keys, pset, min_, max_, cap: int = 64):
    """Ramped half-and-half (reference genHalfAndHalf), one per key."""
    return make_generator(pset, cap, "half_and_half")(keys, min_, max_)
