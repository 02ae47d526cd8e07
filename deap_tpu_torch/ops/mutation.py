"""Mutation operators — the PyTorch counterparts of
``deap_tpu/ops/mutation.py``.  The elementwise operators are
shape-polymorphic: called on a ``(pop, size)`` batch with one key each
is its own batched form.  ``mut_es_log_normal`` registers
``_mut_es_log_normal_batched`` (one common normal a row), and
``mut_shuffle_indexes``, a sequential swap chain, is a
:func:`~deap_tpu_torch.ops._dispatch.rowwise_op`."""

from __future__ import annotations

import numpy as np
import torch

from .. import random
from .._xla_math import exp, fma, pow as xla_pow
from ._dispatch import batched_op, rowwise_op
from .crossover import _bounds, _clip, draw_shape, key_parts

__all__ = [
    "mut_gaussian", "mut_polynomial_bounded", "mut_shuffle_indexes",
    "mut_flip_bit", "mut_uniform_int", "mut_es_log_normal",
]


def mut_gaussian(key, ind, mu, sigma, indpb):
    """Add N(mu, sigma) noise to each gene with probability ``indpb``.
    The noise is drawn in the genome's dtype, as in the JAX package.

    float32 follows the program XLA compiles under ``jit``: the normal's
    ``sqrt(2)`` and ``sigma`` become one float32 factor ``c =
    float32(sigma * float32(sqrt(2)))`` (a constant folded in float32
    when ``sigma`` is a number, one multiply when it is a tensor), and
    the gene is ``ind + fma(erf_inv(u), c, mu)``; a Python ``mu`` of 0
    drops out, and the add to the gene becomes the FMA, ``fma(erf_inv(u),
    c, ind)``.  bfloat16 rounds each operation to bfloat16, with Python
    scalars taken as bfloat16 constants, as jax's weak types make them."""
    k_mask, k_noise = random.split(key)
    mask = random.bernoulli(k_mask, indpb, ind.shape)
    if ind.dtype == torch.bfloat16:
        z = random.normal(k_noise, ind.shape, ind.dtype)
        mu, sigma = (torch.as_tensor(v, device=ind.device).to(torch.bfloat16)
                     if not torch.is_tensor(v) else v for v in (mu, sigma))
        return torch.where(mask, ind + (z * sigma + mu), ind)
    if ind.dtype != torch.float32:
        raise TypeError("mut_gaussian is ported for float32 and bfloat16 "
                        "genomes only")
    return gaussian_from_draws(ind, mask,
                               random.normal_erf_inv(k_noise, ind.shape),
                               mu, sigma)


def gaussian_from_draws(ind, mask, e, mu, sigma):
    """:func:`mut_gaussian`'s float32 arithmetic on given draws: the
    Bernoulli ``mask`` and ``e = erf_inv(u)``, the normal before its
    ``sqrt(2)`` (the streamed engine draws them a slice at a time)."""
    if torch.is_tensor(sigma):
        c = sigma.to(device=ind.device, dtype=torch.float32) * random.SQRT2
    else:
        c = float(np.float32(np.float32(sigma) * np.float32(random.SQRT2)))
    if not torch.is_tensor(mu) and mu == 0:
        mutated = fma(e, c, ind)
    else:
        mutated = ind + fma(e, c, mu)
    return torch.where(mask, mutated, ind)


batched_op(mut_gaussian, mut_gaussian)


def mut_polynomial_bounded(key, ind, eta, low, up, indpb):
    """Deb's polynomial bounded mutation, as NSGA-II uses it: each gene
    moves with probability ``indpb`` by a polynomially distributed step
    scaled to its distance from the bounds.  The multiply-adds that XLA
    fuses under ``jit`` (``2 rand + (1 - 2 rand) p`` and ``ind + delta_q
    * span``, ``1 - (ind - low) / span``) are
    :func:`~deap_tpu_torch._xla_math.fma`; in the mirrored
    ``2 (1 - rand) + 2 (rand - 0.5) p`` XLA's backend fuses the exact
    doubling instead, so the product is rounded on its own.  The four
    powers of a gene go through :func:`deap_tpu_torch._xla_math.pow`.
    A batch of keys draws row ``r`` from key ``r``, as
    :func:`~deap_tpu_torch.ops.crossover.cx_simulated_binary_bounded`."""
    low, up = _bounds(low, ind), _bounds(up, ind)
    k_mask, k_rand = key_parts(key, 2)
    shape = draw_shape(key, ind)
    mask = random.bernoulli(k_mask, indpb, shape)
    rand = random.uniform(k_rand, shape)
    if torch.is_tensor(low) or torch.is_tensor(up):
        span = torch.where(torch.as_tensor(up > low), up - low, 1.0)
        inv_span = 1.0 / span
    else:
        span = float(np.float32(up) - np.float32(low)) if up > low else 1.0
        inv_span = float(np.float32(1.0) / np.float32(span))
    mut_pow = 1.0 / (eta + 1.0)
    # the bounds are constants of the jitted program, so XLA divides by
    # the span as a multiplication by its float32 reciprocal, fused into
    # the subtraction from one
    xy1 = fma(-(ind - low), inv_span, 1.0)
    xy2 = fma(-(up - ind), inv_span, 1.0)
    val1 = fma(1.0 - 2.0 * rand, xla_pow(xy1, eta + 1.0), 2.0 * rand)
    dq1 = xla_pow(val1, mut_pow) - 1.0
    val2 = 2.0 * (1.0 - rand) + (2.0 * (rand - 0.5)) * xla_pow(xy2,
                                                               eta + 1.0)
    dq2 = 1.0 - xla_pow(val2, mut_pow)
    delta_q = torch.where(rand < 0.5, dq1, dq2)
    x = _clip(fma(delta_q, span, ind), low, up)
    return torch.where(mask, x, ind)


batched_op(mut_polynomial_bounded, mut_polynomial_bounded)


def mut_flip_bit(key, ind, indpb):
    """Flip each bit with probability ``indpb``: ``1 - ind`` where the
    draw hits.  A bool genome comes back as int32, as jax's promotion of
    ``1 - bool`` makes it."""
    return flip_where(ind, random.bernoulli(key, indpb, ind.shape))


def flip_where(ind, mask):
    """:func:`mut_flip_bit` on a given mask: ``1 - ind`` where it is
    set (a bool genome as int32)."""
    if ind.dtype == torch.bool:
        ind = ind.to(torch.int32)
    return torch.where(mask, 1 - ind, ind)


batched_op(mut_flip_bit, mut_flip_bit)


@rowwise_op
def mut_shuffle_indexes(keys, ind, indpb):
    """Swap each gene with probability ``indpb`` with another position
    drawn uniformly from the rest (reference mutation.py:98-121): a
    ``randint(0, size - 1)`` bumped past ``i``, then the sequential swap
    chain, ``size`` steps over a leading row axis."""
    size = ind.shape[-1]
    k_mask, k_idx = key_parts(keys, 2)
    mask = random.bernoulli(k_mask, indpb, (size,))
    raw = random.randint(k_idx, (size,), 0, size - 1).long()
    idx = torch.arange(size, device=ind.device)
    swap_to = torch.where(raw >= idx, raw + 1, raw)
    x = ind.clone()
    rows = torch.arange(x.shape[0], device=x.device)
    for i in range(size):
        j, m = swap_to[:, i], mask[:, i]
        xi, xj = x[:, i].clone(), x[rows, j]
        x[:, i] = torch.where(m, xj, xi)
        x[rows, j] = torch.where(m, xi, xj)
    return x


def mut_uniform_int(key, ind, low, up, indpb):
    """Replace each gene with probability ``indpb`` by a uniform integer
    in ``[low, up]``, drawn for the genome's dtype (int8, int16 or
    int32: :func:`deap_tpu_torch.random.randint`, whose narrow law clips
    the bounds to the dtype and draws in int32); a float genome raises,
    as in jax.  Shape-polymorphic: its own batched form."""
    if ind.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(f"mut_uniform_int takes an int8, int16 or int32 "
                        f"genome, not {ind.dtype}")
    k_mask, k_val = key_parts(key, 2)
    shape = draw_shape(key, ind)
    mask = random.bernoulli(k_mask, indpb, shape)
    vals = random.randint(k_val, shape, low, up + 1, dtype=ind.dtype)
    return torch.where(mask, vals, ind)


batched_op(mut_uniform_int, mut_uniform_int)



def _log_normal_scales(c: float, size: int):
    """The float32 factors XLA folds onto ``erf_inv`` of the common and
    the per-gene normals: ``t0 * sqrt(2)`` and ``t * sqrt(2)``, with ``t
    = c / sqrt(2 sqrt(size))`` and ``t0 = c / sqrt(2 size)``, every step
    a float32 operation."""
    f = np.float32
    t = f(c) / np.sqrt(f(2.0) * np.sqrt(f(size)))
    t0 = f(c) / np.sqrt(f(2.0) * f(size))
    root2 = f(random.SQRT2)
    return float(t0 * root2), float(t * root2)


def _log_normal(key, ind, c, indpb, common_shape):
    x, s = ind
    k_mask, k_common, k_gene, k_val = key_parts(key, 4)
    c0, cg = _log_normal_scales(c, x.shape[-1])
    shape = draw_shape(key, x)
    mask = random.bernoulli(k_mask, indpb, shape)
    common = random.normal_erf_inv(k_common, common_shape) * c0
    if key.ndim > 1:                    # a key a row: one common normal each
        common = common[..., None]
    new_s = s * exp(fma(random.normal_erf_inv(k_gene, shape), cg, common))
    new_x = fma(new_s, random.normal(k_val, shape), x)
    return torch.where(mask, new_x, x), torch.where(mask, new_s, s)


def mut_es_log_normal(key, ind, c, indpb):
    """Self-adaptive ES mutation on ``(x, strategy)`` pairs (reference
    mutation.py:180-219): each mutated gene's strategy is multiplied by
    ``exp(t0 N + t N_i)`` (one common normal, one a gene) and its value
    moves by ``strategy * N``.  The float32 form XLA compiles: ``t0`` and
    ``t`` fold into the normals' ``sqrt(2)``, the per-gene product is
    fused into the exponent's add, and ``new_s * N`` into the add to
    ``x``.  One key and one pair, or a batch of keys (one a row) and
    ``(n, size)`` pairs, as ``jax.vmap`` over ``split`` keys."""
    return _log_normal(key, ind, c, indpb, ())


def _mut_es_log_normal_batched(key, ind, c, indpb):
    """:func:`mut_es_log_normal` over ``(n, size)`` pairs from one key,
    with one common normal a row."""
    return _log_normal(key, ind, c, indpb, (ind[0].shape[0], 1))


batched_op(mut_es_log_normal, _mut_es_log_normal_batched)
