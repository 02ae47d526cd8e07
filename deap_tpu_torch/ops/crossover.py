"""Crossover operators — the PyTorch counterparts of
``deap_tpu/ops/crossover.py``: per-pair ``cx(key, ind1, ind2)`` plus a
population-level ``.batched`` form that takes one key."""

from __future__ import annotations

import numpy as np
import torch

from .. import random
from .._xla_math import fma, pow as xla_pow
from ._dispatch import batched_op

__all__ = ["cx_two_point", "cx_blend", "cx_simulated_binary_bounded"]


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
    ordered.  ``shape`` draws a batch of independent pairs."""
    k1, k2 = random.split(key)
    c1 = random.randint(k1, shape, low, size + 1)
    c2 = random.randint(k2, shape, low, size)
    c2 = torch.where(c2 >= c1, c2 + 1, c2)
    return torch.minimum(c1, c2), torch.maximum(c1, c2)


def _swap_where(mask, ind1, ind2):
    return torch.where(mask, ind2, ind1), torch.where(mask, ind1, ind2)


def cx_two_point(key, ind1, ind2):
    """Swap the slice between two random points."""
    size = ind1.shape[-1]
    lo, hi = _two_cut_points(key, size)
    idx = torch.arange(size, device=ind1.device)
    return _swap_where((idx >= lo) & (idx < hi), ind1, ind2)


def _cx_two_point_batched(key, A, B):
    n, size = A.shape[0], A.shape[-1]
    lo, hi = _two_cut_points(key, size, shape=(n, 1))
    idx = torch.arange(size, device=A.device)[None, :]
    return _swap_where((idx >= lo) & (idx < hi), A, B)


batched_op(cx_two_point, _cx_two_point_batched)


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
