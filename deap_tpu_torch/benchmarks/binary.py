"""Binary benchmark functions — the PyTorch counterparts of
``deap_tpu/benchmarks/binary.py``: the ``bin2float`` decoding decorator
and the deceptive trap, Chuang and Royal Road functions.  Individuals
are 0/1 tensors (integer or float); every function is written over
leading row axes too, so one call serves a population.

A bit string's value is a float32 sum of powers of two in XLA's order
(:func:`~deap_tpu_torch._xla_math.row_sum`): past 24 bits the order
rounds."""

from __future__ import annotations

from functools import wraps

import numpy as np
import torch

from .._xla_math import fma, row_sum

__all__ = ["bin2float", "trap", "inv_trap", "chuang_f1", "chuang_f2",
           "chuang_f3", "royal_road1", "royal_road2"]


def _bits_to_int(bits: torch.Tensor) -> torch.Tensor:
    """Big-endian bits (last axis) → their float32 value."""
    n = bits.shape[-1]
    basis = torch.tensor(2.0 ** np.arange(n - 1, -1, -1), dtype=torch.float32,
                         device=bits.device)
    return row_sum(bits.to(torch.float32) * basis)


def _blocks(x: torch.Tensor, start: int, stop: int, size: int):
    """``x[start:stop]`` cut into blocks of ``size`` along the last axis."""
    return x[..., start:stop].reshape(x.shape[:-1] + (-1, size))


def bin2float(min_, max_, nbits):
    """Decorator decoding a binary genome into ``len // nbits`` floats in
    ``[min_, max_]`` before calling the wrapped function."""
    # XLA folds ``/ div * (max_ - min_)`` into one float32 factor and
    # fuses its product into the add of ``min_``
    f = np.float32
    factor = float(f(f(max_ - min_) / f(2.0 ** nbits - 1.0)))

    def wrap(function):
        @wraps(function)
        def wrapped_function(individual, *args, **kargs):
            nelem = individual.shape[-1] // nbits
            genes = _blocks(individual, 0, nelem * nbits, nbits)
            decoded = fma(_bits_to_int(genes), factor, min_)
            return function(decoded, *args, **kargs)
        return wrapped_function
    return wrap


def _count(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` over the last axis: int32 for integer and bool bits,
    float32 for float ones."""
    if x.is_floating_point():
        return row_sum(x)
    return x.sum(-1, dtype=torch.int32)


def trap(individual):
    """Deceptive trap: ``k`` if all ones, else ``k - 1 - u``."""
    u = _count(individual)
    k = individual.shape[-1]
    return torch.where(u == k, float(k), (k - 1.0) - u.to(torch.float32))


def inv_trap(individual):
    """Inverted trap: ``k`` if all zeros, else ``u - 1``."""
    u = _count(individual)
    k = individual.shape[-1]
    return torch.where(u == 0, float(k), u.to(torch.float32) - 1.0)


def chuang_f1(individual):
    """Chuang & Hsu's deceptive f1: 40 + 1 bits, the traps switched by
    the last bit."""
    blocks = _blocks(individual, 0, individual.shape[-1] - 1, 4)
    inv, reg = row_sum(inv_trap(blocks)), row_sum(trap(blocks))
    return torch.where(individual[..., -1] == 0, inv, reg),


def chuang_f2(individual):
    """Chuang & Hsu's deceptive f2: 40 + 2 bits, four optima chosen by
    the last two bits."""
    n = individual.shape[-1]
    pairs = _blocks(individual, 0, n - 2, 8)
    first, second = pairs[..., :4], pairs[..., 4:]
    ti, ii = row_sum(trap(first)), row_sum(inv_trap(first))
    tj, ij = row_sum(trap(second)), row_sum(inv_trap(second))
    b0, b1 = individual[..., -2] == 0, individual[..., -1] == 0
    total = torch.where(b0 & b1, ii + ij,
                        torch.where(b0, ii + tj,
                                    torch.where(b1, ti + ij, ti + tj)))
    return total,


def chuang_f3(individual):
    """Chuang & Hsu's deceptive f3: 40 + 1 bits with a wrapped trap
    block."""
    n = individual.shape[-1]
    inv0 = row_sum(inv_trap(_blocks(individual, 0, n - 1, 4)))
    inv1 = row_sum(inv_trap(_blocks(individual, 2, n - 3, 4)))
    wrapped = torch.cat([individual[..., -2:], individual[..., :2]], -1)
    return torch.where(individual[..., -1] == 0, inv0,
                       inv1 + trap(wrapped)),


def royal_road1(individual, order):
    """Royal Road R1: ``order`` points for each complete all-ones block
    of length ``order``."""
    nelem = individual.shape[-1] // order
    value = _bits_to_int(_blocks(individual, 0, nelem * order, order))
    # a divisor tensor: the card divides a tensor by a Python number as
    # a multiply by its reciprocal, which moves the floor at value == max
    max_value = torch.full_like(value, 2.0 ** order - 1.0)
    return row_sum(float(order) * torch.floor(value / max_value)),


def royal_road2(individual, order):
    """Royal Road R2: R1 summed at doubling block sizes up to
    ``order ** 2``."""
    total = 0.0
    norder = order
    while norder < order ** 2:
        total = total + royal_road1(individual, norder)[0]
        norder *= 2
    return total,
