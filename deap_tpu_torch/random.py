"""Threefry-2x32 keys and samplers, bit-compatible with ``jax.random``.

The port keeps the JAX package's explicit-key discipline: every
trajectory is a pure function of a key, and the keys, splits, fold-ins
and raw bits here equal ``jax.random``'s under the default
``threefry2x32`` implementation with ``jax_threefry_partitionable=True``
(pinned bitwise by ``tests/test_torch_random.py``).  ``torch.Generator``
plays no part.

A key is an ``int64`` tensor of shape ``(..., 2)`` holding two uint32
words.  PyTorch's ``uint32`` support is thin, so all uint32 arithmetic is
done in ``int64`` and masked with ``& 0xFFFFFFFF``.  Plain tensor ops are
enough: threefry is counter arithmetic, not a kernel of the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from ._xla_math import erf_inv, fma

__all__ = ["PRNGKey", "key_data", "split", "fold_in", "bits", "uniform",
           "bernoulli", "randint", "normal"]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def mul32(a, b: int):
    """``a * b mod 2**32`` for uint32 words held in int64 and a constant
    ``b`` below 2**32, split into 16-bit halves so no product overflows
    int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _iota_2x32(shape, device):
    """Row-major counter over ``shape`` as (hi, lo) uint32 words — the
    partitionable layout's ``iota_2x32_shape``."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return counts >> 32, counts & M32


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """A raw key from an integer seed (``jax.random.PRNGKey`` with 64-bit
    types disabled: the words are ``[0, seed mod 2**32]``)."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=dev)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The key's two uint32 words (as int64); keys are already raw."""
    return key


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``num`` (or ``shape``) new keys, shape ``(*shape, 2)``."""
    shape = _shape(num)
    hi, lo = _iota_2x32(shape, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Mix an integer into a key (``jax.random.fold_in``)."""
    d = torch.tensor([int(data) & M32], dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Raw uint32 words of ``shape`` (as int64): ``random_bits(key, 32)``."""
    shape = _shape(shape)
    hi, lo = _iota_2x32(shape, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape = (), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Uniform floats in ``[minval, maxval)`` from the top 23 bits."""
    if dtype != torch.float32:
        raise TypeError("uniform is ported for float32 only")
    shape = _shape(shape)
    b = bits(key, shape)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # bounds stay Python floats (float32 values): a scalar needs no
    # host-to-device copy; XLA fuses the scale-and-shift into one FMA
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(fma(floats, span, lo), min=lo)


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Shape = ()) -> torch.Tensor:
    """Bool draws, true with probability ``p``."""
    return uniform(key, shape) < float(np.float32(p))


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)`` by jax's two-word modulus law
    (biased exactly as jax's is when the span is not a power of two)."""
    shape = _shape(shape)
    i32_min, i32_max = -(1 << 31), (1 << 31) - 1
    maxval_out_of_range = maxval > i32_max
    minval = min(max(int(minval), i32_min), i32_max)
    maxval = min(max(int(maxval), i32_min), i32_max)
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & M32
    if maxval <= minval:
        span = 1
    elif maxval_out_of_range:
        span = (span + 1) & M32
    if span == 0:           # the full 2**32 range: remainders are no-ops
        offset = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & M32) % span     # the square wraps, as in jax
        offset = mul32(higher % span, mult) + (lower % span)
        offset = (offset & M32) % span
    out = (minval + offset + (1 << 31)) & M32
    return (out - (1 << 31)).to(torch.int32)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype=torch.float32) -> torch.Tensor:
    """Standard normals: ``sqrt(2) * erf_inv(u)`` with ``u`` uniform in
    ``(-1, 1)``.  ``erf_inv`` follows XLA's f32 expansion
    (:mod:`deap_tpu_torch._xla_math`)."""
    if dtype != torch.float32:
        raise TypeError("normal is ported for float32 only")
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, torch.float32, lo, 1.0)
    return erf_inv(u) * 1.4142135381698608
