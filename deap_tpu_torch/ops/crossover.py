"""Crossover operators — the PyTorch counterparts of
``deap_tpu/ops/crossover.py``: per-pair ``cx(key, ind1, ind2)`` plus a
population-level ``.batched`` form that takes one key, registered for
the operators the JAX package registers one for (``cx_one_point``,
``cx_two_point``, ``cx_uniform``, ``cx_blend``, ``cx_simulated_binary``,
``cx_simulated_binary_bounded``, ``cx_es_blend``, ``cx_es_two_point``).

The permutation and variable-length operators (``cx_partialy_matched``,
``cx_uniform_partialy_matched``, ``cx_ordered``, ``cx_messy_one_point``)
have none: each is a :func:`~deap_tpu_torch.ops._dispatch.rowwise_op`,
written over a leading row axis with one key a row (the JAX package's
``jax.vmap`` over ``split`` keys); each also takes one key and one pair.
PMX's swap chain runs ``size`` steps, each a gather and a scatter of
``(rows,)`` vectors, not a Python loop over rows."""

from __future__ import annotations

import numpy as np
import torch

from .. import random
from .._xla_math import fma, pow as xla_pow
from ._dispatch import batched_op, rowwise_op

__all__ = [
    "cx_one_point", "cx_two_point", "cx_uniform",
    "cx_partialy_matched", "cx_uniform_partialy_matched", "cx_ordered",
    "cx_blend", "cx_simulated_binary", "cx_simulated_binary_bounded",
    "cx_messy_one_point", "cx_es_blend", "cx_es_two_point",
]


def key_parts(key, num: int) -> list:
    """``split(key, num)`` as a list of ``num`` keys, for one key or a
    batch of keys (key ``i`` of every batch row)."""
    ks = random.split(key, num)
    return [ks[..., i, :] for i in range(num)]


def draw_shape(key, ind) -> tuple:
    """The draw shape of a shape-polymorphic operator: the whole of
    ``ind`` for one key; for a batch of keys, a row each (the key batch
    supplies the leading axes)."""
    return tuple(ind.shape[key.ndim - 1:])


def _two_cut_points(key, size, low=1, shape=()):
    """Two distinct cut points with the reference's law: ``c1`` in
    ``[low, size]``, ``c2`` in ``[low, size-1]`` bumped past ``c1``, then
    ordered.  ``shape`` draws a batch of independent pairs; a batch of
    keys draws a pair a key."""
    k1, k2 = key_parts(key, 2)
    c1 = random.randint(k1, shape, low, size + 1)
    c2 = random.randint(k2, shape, low, size)
    c2 = torch.where(c2 >= c1, c2 + 1, c2)
    return torch.minimum(c1, c2), torch.maximum(c1, c2)


def _swap_where(mask, ind1, ind2):
    return torch.where(mask, ind2, ind1), torch.where(mask, ind1, ind2)


def one_point_mask(point, size: int):
    """The genes a one-point crossover swaps: those at or past ``point``
    (a scalar, or ``(n, 1)`` points: one row of the mask each)."""
    return torch.arange(size, device=point.device) >= point


def two_point_mask(lo, hi, size: int):
    """The genes a two-point crossover swaps: ``[lo, hi)`` (scalars, or
    ``(n, 1)`` cut points)."""
    idx = torch.arange(size, device=lo.device)
    return (idx >= lo) & (idx < hi)


def one_point_cuts(key, n: int, size: int):
    """The ``(n, 1)`` points of :func:`cx_one_point`'s batched form."""
    return random.randint(key, (n, 1), 1, size)


def two_point_cuts(key, n: int, size: int):
    """The ``(n, 1)`` cut points ``(lo, hi)`` of :func:`cx_two_point`'s
    batched form.  The streamed engine draws them for the whole
    population and applies :func:`two_point_mask` a slice at a time."""
    return _two_cut_points(key, size, shape=(n, 1))


def cx_one_point(key, ind1, ind2):
    """Swap the tails after one random point in ``[1, size - 1]``."""
    size = ind1.shape[-1]
    point = random.randint(key, (), 1, size)
    return _swap_where(one_point_mask(point, size), ind1, ind2)


def _cx_one_point_batched(key, A, B):
    size = A.shape[-1]
    return _swap_where(one_point_mask(one_point_cuts(key, A.shape[0], size),
                                     size), A, B)


batched_op(cx_one_point, _cx_one_point_batched)


def cx_two_point(key, ind1, ind2):
    """Swap the slice between two random points."""
    size = ind1.shape[-1]
    return _swap_where(two_point_mask(*_two_cut_points(key, size), size),
                       ind1, ind2)


def _cx_two_point_batched(key, A, B):
    size = A.shape[-1]
    return _swap_where(two_point_mask(*two_point_cuts(key, A.shape[0], size),
                                      size), A, B)


batched_op(cx_two_point, _cx_two_point_batched)


def cx_uniform(key, ind1, ind2, indpb):
    """Swap each attribute independently with probability ``indpb``:
    one Bernoulli mask over the whole shape, so one key serves a
    ``(n, size)`` batch (its own batched form)."""
    return _swap_where(random.bernoulli(key, indpb, draw_shape(key, ind1)),
                       ind1, ind2)


batched_op(cx_uniform, cx_uniform)


def _positions(perm: torch.Tensor) -> torch.Tensor:
    """``p[r, v]`` = the index of value ``v`` in row ``r`` of the
    permutations ``perm`` (int64).  The indices are unique, so the
    scatter's order does not matter."""
    idx = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.zeros_like(idx).scatter_(1, perm, idx)


def _pmx_swap_chain(ind1, ind2, active):
    """PMX's swap chain (reference crossover.py:120-136) over a leading
    row axis: at each active position ``i`` swap the matched values in
    both children and update both position tables.  Step ``i`` writes a
    child's slot ``i`` and then slot ``p[t2]`` (the later write wins
    where they meet, as in ``.at[i].set(t2).at[p1[t2]].set(t1)``);
    inactive rows write back what they hold."""
    dtype = ind1.dtype
    i1, i2 = ind1.long().clone(), ind2.long().clone()
    p1, p2 = _positions(i1), _positions(i2)
    rows = torch.arange(i1.shape[0], device=i1.device)
    for i in range(i1.shape[-1]):
        act = active[:, i]
        t1, t2 = i1[:, i].clone(), i2[:, i].clone()
        j1, j2 = p1[rows, t2], p2[rows, t1]
        old1, old2 = i1[rows, j1], i2[rows, j2]
        i1[:, i] = torch.where(act, t2, t1)
        i1[rows, j1] = torch.where(act, t1, old1)
        i2[:, i] = torch.where(act, t1, t2)
        i2[rows, j2] = torch.where(act, t2, old2)
        a1, b1 = p1[rows, t1], p1[rows, t2]
        p1[rows, t1] = torch.where(act, b1, a1)
        p1[rows, t2] = torch.where(act, a1, b1)
        a2, b2 = p2[rows, t2], p2[rows, t1]
        p2[rows, t2] = torch.where(act, b2, a2)
        p2[rows, t1] = torch.where(act, a2, b2)
    return i1.to(dtype), i2.to(dtype)


@rowwise_op
def cx_partialy_matched(keys, ind1, ind2):
    """PMX on integer permutations (reference crossover.py:94-141): the
    cut points ``[lo, hi)`` with ``low = 0``, then the swap chain over
    them."""
    size = ind1.shape[-1]
    lo, hi = _two_cut_points(keys, size, low=0)
    idx = torch.arange(size, device=ind1.device)
    active = (idx >= lo[:, None]) & (idx < hi[:, None])
    return _pmx_swap_chain(ind1, ind2, active)


@rowwise_op
def cx_uniform_partialy_matched(keys, ind1, ind2, indpb):
    """UPMX (Cicirello & Smith 2000): PMX swaps at the positions of a
    Bernoulli(``indpb``) mask a row."""
    active = random.bernoulli(keys, indpb, (ind1.shape[-1],))
    return _pmx_swap_chain(ind1, ind2, active)


def _stable_order(flag: torch.Tensor) -> torch.Tensor:
    """``argsort(flag, stable=True)`` of a bool tensor along its rows:
    the false entries first, each group in index order."""
    return torch.sort(flag.to(torch.int8), dim=-1, stable=True).indices


def _ox_child(keep, fill, lo, hi):
    """One ordered-crossover child a row: ``keep``'s ``[lo, hi]``
    segment stays; the other positions, scanned cyclically from ``hi +
    1``, take ``fill``'s values not in the segment in their cyclic order
    from ``hi + 1`` (reference crossover.py:188-238).  ``jnp.roll`` by
    ``-(hi + 1)`` is a gather at ``(j + hi + 1) % size``; positions past
    the fill count write the drop slot ``size``, which is cut away."""
    n, size = keep.shape
    idx = torch.arange(size, device=keep.device).expand(n, size)
    lo, hi = lo[:, None], hi[:, None]
    seg = (idx >= lo) & (idx <= hi)
    member = torch.zeros_like(seg).scatter_(1, keep, seg)
    pos_rot = (idx + hi + 1) % size
    rot = fill.gather(1, pos_rot)
    donor_vals = rot.gather(1, _stable_order(member.gather(1, rot)))
    pos_out = (pos_rot >= lo) & (pos_rot <= hi)
    pos_vals = pos_rot.gather(1, _stable_order(pos_out))
    nfill = size - (hi - lo + 1)
    safe_pos = torch.where(idx < nfill, pos_vals, size)
    buf = torch.zeros((n, size + 1), dtype=keep.dtype, device=keep.device)
    buf.scatter_(1, safe_pos, donor_vals)
    return torch.where(seg, keep, buf[:, :size])


@rowwise_op
def cx_ordered(keys, ind1, ind2):
    """Ordered crossover (OX, Goldberg 1989) on permutations: ``a`` in
    ``[0, size)``, ``b`` in ``[0, size - 1)`` bumped past ``a``, the
    segment ``[min, max]``."""
    size = ind1.shape[-1]
    k1, k2 = key_parts(keys, 2)
    a = random.randint(k1, (), 0, size)
    b = random.randint(k2, (), 0, size - 1)
    b = torch.where(b >= a, b + 1, b)
    lo, hi = torch.minimum(a, b).long(), torch.maximum(a, b).long()
    g1, g2 = ind1.long(), ind2.long()
    return (_ox_child(g1, g2, lo, hi).to(ind1.dtype),
            _ox_child(g2, g1, lo, hi).to(ind1.dtype))


def cx_blend(key, ind1, ind2, alpha):
    """BLX-alpha blend: per gene ``gamma = (1 + 2 alpha) u - alpha`` with
    ``u`` uniform, children ``(1 - gamma) ind1 + gamma ind2`` and ``gamma
    ind1 + (1 - gamma) ind2``.  Shape-polymorphic: one key serves a
    ``(n, size)`` batch.  As XLA's CPU backend compiles the jitted
    operator, ``gamma`` is one fused multiply-add and each child fuses its
    product with ``gamma`` into the add (inside the evopole example's
    generation loop XLA fuses the other product instead:
    ``deap_tpu_torch.examples.ga.evopole``)."""
    u = random.uniform(key, ind1.shape)
    gamma = fma(u, float(np.float32(1.0 + 2.0 * alpha)),
                -float(np.float32(alpha)))
    rest = 1.0 - gamma
    return fma(gamma, ind2, rest * ind1), fma(gamma, ind1, rest * ind2)


batched_op(cx_blend, cx_blend)


def cx_simulated_binary(key, ind1, ind2, eta):
    """SBX (reference crossover.py:263-288): the spread factor ``beta``
    is ``(2u)^(1/(eta+1))`` below ``u = 0.5`` and ``(1/(2(1-u)))^(1/(eta+
    1))`` above it (:func:`deap_tpu_torch._xla_math.pow`), children
    ``0.5 ((1 +- beta) ind1 + (1 -+ beta) ind2)``.  The float32 form is
    the one XLA compiles inside ``vary_genome`` (``bench.py``'s xla
    body): the product of the first term is fused into the add of the
    second.  Shape-polymorphic: its own batched form."""
    u = random.uniform(key, draw_shape(key, ind1))
    p = 1.0 / (eta + 1.0)
    beta = torch.where(u <= 0.5, xla_pow(2.0 * u, p),
                       xla_pow(1.0 / (2.0 * (1.0 - u)), p))
    up, dn = 1.0 + beta, 1.0 - beta
    return (0.5 * fma(up, ind1, dn * ind2), 0.5 * fma(dn, ind1, up * ind2))


batched_op(cx_simulated_binary, cx_simulated_binary)


def _bounds(v, like):
    """A scalar bound stays a Python float (float32 value, no device
    copy); a per-gene sequence becomes a tensor beside ``like``."""
    if isinstance(v, (int, float)):
        return float(torch.tensor(v, dtype=like.dtype))
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def cx_simulated_binary_bounded(key, ind1, ind2, eta, low, up):
    """Bounded SBX as NSGA-II uses it: each gene is crossed with
    probability 0.5 where the parents differ; the spread factor is
    corrected for the bounds, the children are clipped and swapped at
    random.  Shape-polymorphic: one key serves a ``(n, size)`` batch, and
    a batch of ``n`` keys draws row ``r`` from key ``r`` (``jax.vmap`` of
    the per-pair operator over ``split`` keys, as the NSGA-II example
    calls it).

    The float32 operations are the ones XLA's CPU backend runs when the
    operator is jitted inside a generation (``vary_genome`` in a scanned
    loop, the published path): ``x1 + x2 -/+ beta_q * diff`` is one
    fused multiply-add, and the three powers of a gene go through
    :func:`deap_tpu_torch._xla_math.pow`.  ``2 - rand * alpha`` is
    rounded twice there, because the product also feeds the other
    branch's power; jitted on its own, XLA splits the branches into two
    fusions and contracts it, which moves 0.3% of the genes by one ulp
    (pinned in ``tests/test_torch_sbx_poly.py``)."""
    low, up = _bounds(low, ind1), _bounds(up, ind1)
    k_apply, k_rand, k_swap = key_parts(key, 3)
    shape = draw_shape(key, ind1)
    apply_ = random.bernoulli(k_apply, 0.5, shape) & (
        (ind1 - ind2).abs() > 1e-14)
    x1 = torch.minimum(ind1, ind2)
    x2 = torch.maximum(ind1, ind2)
    rand = random.uniform(k_rand, shape)
    gap = x2 - x1
    diff = torch.where(gap > 1e-14, gap, 1.0)         # guarded denominator
    total = x1 + x2
    inv_pow = 1.0 / (eta + 1.0)

    def beta_q(beta):
        alpha = 2.0 - xla_pow(beta, -(eta + 1.0))
        return torch.where(
            rand <= 1.0 / alpha,
            xla_pow(rand * alpha, inv_pow),
            xla_pow(1.0 / (2.0 - rand * alpha), inv_pow))

    beta1 = 1.0 + (2.0 * (x1 - low) / diff)
    c1 = 0.5 * fma(-beta_q(beta1), diff, total)
    beta2 = 1.0 + (2.0 * (up - x2) / diff)
    c2 = 0.5 * fma(beta_q(beta2), diff, total)
    c1 = _clip(c1, low, up)
    c2 = _clip(c2, low, up)
    swap = random.bernoulli(k_swap, 0.5, shape)
    o1 = torch.where(swap, c2, c1)
    o2 = torch.where(swap, c1, c2)
    return torch.where(apply_, o1, ind1), torch.where(apply_, o2, ind2)


def _clip(x, low, up):
    if torch.is_tensor(low) or torch.is_tensor(up):
        return torch.minimum(torch.maximum(x, torch.as_tensor(low).to(x)),
                             torch.as_tensor(up).to(x))
    return torch.clamp(x, low, up)


batched_op(cx_simulated_binary_bounded, cx_simulated_binary_bounded)


@rowwise_op
def cx_messy_one_point(keys, ind1, ind2):
    """Messy one-point crossover (reference crossover.py:367-387): cut
    each parent at its own point in ``[0, length]`` and splice head one
    with tail two, head two with tail one.  Individuals are ``(genome,
    length)`` pairs over a fixed capacity (plain tensors count as full);
    the children come back as such pairs (int32 lengths), their slots
    from ``length`` on zero."""
    if isinstance(ind1, tuple):
        (g1, l1), (g2, l2) = ind1, ind2
    else:
        g1, g2 = ind1, ind2
        l1 = l2 = torch.full(g1.shape[:1], g1.shape[-1], dtype=torch.int32,
                             device=g1.device)
    cap = g1.shape[-1]
    k1, k2 = key_parts(keys, 2)
    cut1 = random.randint(k1, (), 0, l1.long() + 1).long()[:, None]
    cut2 = random.randint(k2, (), 0, l2.long() + 1).long()[:, None]
    idx = torch.arange(cap, device=g1.device)[None, :]
    l1, l2 = l1.long()[:, None], l2.long()[:, None]

    def splice(head, lh, tail, ct, lt):
        src = torch.clamp(ct + (idx - lh), 0, cap - 1)
        child = torch.where(idx < lh, head, tail.gather(1, src))
        length = torch.clamp(lh + (lt - ct), max=cap)
        child = torch.where(idx < length, child, torch.zeros_like(child))
        return child, length[:, 0].to(torch.int32)

    return splice(g1, cut1, g2, cut2, l2), splice(g2, cut2, g1, cut1, l1)


def cx_es_blend(key, ind1, ind2, alpha):
    """ES blend crossover on ``(x, strategy)`` pairs (reference
    crossover.py:390-416): values and strategies blend with the same
    per-gene ``gamma``, in :func:`cx_blend`'s float32 form.
    Shape-polymorphic: its own batched form."""
    (x1, s1), (x2, s2) = ind1, ind2
    u = random.uniform(key, draw_shape(key, x1))
    gamma = fma(u, float(np.float32(1.0 + 2.0 * alpha)),
                -float(np.float32(alpha)))
    rest = 1.0 - gamma
    return ((fma(gamma, x2, rest * x1), fma(gamma, s2, rest * s1)),
            (fma(gamma, x1, rest * x2), fma(gamma, s1, rest * s2)))


batched_op(cx_es_blend, cx_es_blend)


def cx_es_two_point(key, ind1, ind2):
    """ES two-point crossover (reference crossover.py:419-446): the same
    two cut points swap values and strategies."""
    (x1, s1), (x2, s2) = ind1, ind2
    lo, hi = _two_cut_points(key, x1.shape[-1])
    idx = torch.arange(x1.shape[-1], device=x1.device)
    mask = (idx >= lo) & (idx < hi)
    (nx1, nx2), (ns1, ns2) = _swap_where(mask, x1, x2), _swap_where(
        mask, s1, s2)
    return (nx1, ns1), (nx2, ns2)


def _cx_es_two_point_batched(key, A, B):
    (x1, s1), (x2, s2) = A, B
    n, size = x1.shape[0], x1.shape[-1]
    lo, hi = _two_cut_points(key, size, shape=(n, 1))
    idx = torch.arange(size, device=x1.device)[None, :]
    mask = (idx >= lo) & (idx < hi)
    (nx1, nx2), (ns1, ns2) = _swap_where(mask, x1, x2), _swap_where(
        mask, s1, s2)
    return (nx1, ns1), (nx2, ns2)


batched_op(cx_es_two_point, _cx_es_two_point_batched)
