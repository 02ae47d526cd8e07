"""Rows of a whole threefry draw, without drawing the rest.

The streamed engine's bitwise contract (a streamed generation at pop
``n`` equals the resident one at the same pop and key) rests on one
primitive: the resident path draws its genome-sized randomness (the
mutation mask and noise at ``(n, dim)``, ``cx_uniform``'s swap mask at
``(n // 2, dim)``) from one key each, and a slice must reproduce rows
``[row_start, row_start + rows)`` of that very draw without making the
whole of it.

The port's keys use threefry2x32's *partitionable* layout
(:mod:`deap_tpu_torch.random`): element ``i`` of a draw, counted in
row-major order, is ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``
with its two output words xored.  So a slice of rows is threefry over
the counters ``[row_start * width, (row_start + rows) * width)``, with
``width`` the product of the trailing dimensions: O(slice) work and
memory, from explicit offsets on top of :func:`deap_tpu_torch.random.
threefry2x32`.  (The JAX package's module regenerates jax's other,
non-partitionable layout, where a draw of ``total`` words pairs counter
``t`` with ``total / 2 + t``; jax now defaults to the partitionable
one, and the port implements no other.)  No global state is involved,
so a slice of any size, a 1-row tail included, is exact.

The float laws are :mod:`deap_tpu_torch.random`'s own, applied to the
sliced words (:func:`~deap_tpu_torch.random.uniform_from_bits`, the
``erf_inv`` of :func:`~deap_tpu_torch.random.normal_erf_inv`, ``u <
float32(p)``).  ``tests/test_torch_bigpop.py`` holds every sampler here
against whole ``jax.random`` draws.
"""

from __future__ import annotations

import math

import torch

from .. import random
from .._xla_math import erf_inv

__all__ = ["check_prng_compat", "sliced_bits", "sliced_uniform",
           "sliced_normal", "sliced_bernoulli"]


def check_prng_compat(key: torch.Tensor) -> None:
    """Raise unless ``key`` is one threefry2x32 key, whose draws this
    module regenerates (an rbg key draws Philox bits from a running
    counter, which the streamed engine does not slice)."""
    name = random.impl_of(key)
    if name != "threefry2x32":
        raise RuntimeError(
            "streamed generation requires a threefry2x32 key; this key's "
            f"implementation is {name!r}")
    if key.ndim != 1:
        raise ValueError("streamed generation takes one key, not a batch of "
                         f"shape {tuple(key.shape)}")


def sliced_bits(key: torch.Tensor, shape, row_start: int,
                rows: int) -> torch.Tensor:
    """Rows ``[row_start, row_start + rows)`` of ``random.bits(key,
    shape)``: uint32 words as int64, shaped ``(rows, *shape[1:])``."""
    check_prng_compat(key)
    shape = tuple(int(s) for s in shape)
    row_start, rows = int(row_start), int(rows)
    if rows < 0 or row_start < 0 or row_start + rows > shape[0]:
        raise ValueError(f"rows [{row_start}, {row_start + rows}) outside "
                         f"a draw of {shape[0]} rows")
    width = math.prod(shape[1:])
    first = row_start * width
    counts = torch.arange(first, first + rows * width, dtype=torch.int64,
                          device=key.device).reshape((rows,) + shape[1:])
    b1, b2 = random.threefry2x32(key[0], key[1], counts >> 32,
                                 counts & random.M32)
    return b1 ^ b2


def sliced_uniform(key, shape, row_start: int, rows: int,
                   minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Rows of ``random.uniform(key, shape, minval=..., maxval=...)``
    (float32)."""
    return random.uniform_from_bits(sliced_bits(key, shape, row_start, rows),
                                    minval, maxval)


def sliced_normal(key, shape, row_start: int, rows: int) -> torch.Tensor:
    """Rows of ``random.normal_erf_inv(key, shape)``: the normal before
    its scale by ``random.SQRT2`` (``random.normal`` is this times it),
    the form ``mut_gaussian``'s arithmetic takes."""
    return erf_inv(sliced_uniform(key, shape, row_start, rows,
                                  random.NORMAL_LO, 1.0))


def sliced_bernoulli(key, p: float, shape, row_start: int,
                     rows: int) -> torch.Tensor:
    """Rows of ``random.bernoulli(key, p, shape)``."""
    return sliced_uniform(key, shape, row_start, rows) < random.prob32(p)
