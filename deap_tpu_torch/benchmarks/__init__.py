"""Benchmark objective functions — the PyTorch counterparts of
``deap_tpu/benchmarks/__init__.py``.  Each maps ONE individual (a 1-D
tensor) to a tuple of objective scalars; the loops vmap them over the
population with ``torch.func.vmap``, or call the batched form of those
registered with one (``ackley``, ``zdt1``, ``dtlz2``: written over a
leading row axis) once on the population."""

from __future__ import annotations

import math

import numpy as np
import torch

from .._xla_math import (cos, exp, fma, fma_product, row_mean, row_sum,
                         sin, sqrt)
from ..ops._dispatch import batched_op

__all__ = ["sphere", "ackley", "rastrigin", "zdt1", "dtlz2"]


def sphere(individual):
    """Sphere: sum x_i^2."""
    return torch.sum(individual * individual),


def ackley(individual):
    """Ackley: ``20 - 20 exp(-0.2 sqrt(mean x²)) + e - exp(mean cos 2πx)``
    in the form XLA compiles it: ``exp``, ``cos``, ``sqrt`` and the two
    means are its float32 forms (:mod:`deap_tpu_torch._xla_math`), the
    constants ``20 + e`` fold into one float32, and the product with 20
    is fused into the subtraction from it.  Written over a leading row
    axis too, and registered as its own batched form, so the loops call
    it once on the population (``vmap`` cannot batch the float-bit views
    of those forms on every torch release)."""
    a = exp(-0.2 * sqrt(row_mean(individual ** 2)))
    b = exp(row_mean(cos((2.0 * math.pi) * individual)))
    return fma(a, -20.0, _ACKLEY_20_E) - b,


_ACKLEY_20_E = float(np.float32(20.0) + np.float32(math.e))
batched_op(ackley, ackley)


def rastrigin(individual):
    """Rastrigin — the flagship GA benchmark config."""
    n = individual.shape[-1]
    return 10.0 * n + torch.sum(individual ** 2 - 10.0 * torch.cos(
        2.0 * math.pi * individual)),


def zdt1(individual):
    """ZDT1 — two objectives, the NSGA-II benchmark's default problem, in
    the form XLA compiles it: the genes summed in index order (XLA's
    windows past 32, :func:`~deap_tpu_torch._xla_math.row_sum`), the
    division by ``n - 1`` and the factor 9 folded into one float32
    constant whose product is fused into ``1 +``.  Written over a
    leading row axis too and registered as its own batched form (the
    fused multiply-add views float bits, which ``vmap`` cannot batch on
    every torch release).  Bitwise to the jitted JAX function alone;
    inside a jitted generation XLA may fuse the sum with the mutation
    and reassociate it (the tests state rtol 1e-6 there)."""
    n = individual.shape[-1]
    f1 = individual[..., 0]
    g = fma(row_sum(individual[..., 1:]),
            float(np.float32(9.0) * (np.float32(1.0) / np.float32(n - 1))),
            1.0)
    return f1, g * (1.0 - sqrt(f1 / g))


batched_op(zdt1, zdt1)


def _prod(t: torch.Tensor, k: int):
    """Product of the first ``k`` entries of the last axis, in order
    (``None`` when ``k`` is 0: the empty product is 1)."""
    p = None
    for i in range(k):
        p = t[..., i] if p is None else p * t[..., i]
    return p


def _dtlz_spherical(individual, obj, g):
    ang = individual[..., :obj - 1] * _HALF_PI
    cos_t = cos(ang)
    opg = 1.0 + g
    f = [opg * _prod(cos_t, obj - 1)]
    for m in range(obj - 2, -1, -1):
        head = _prod(cos_t, m)
        f.append((opg if head is None else opg * head) * sin(ang[..., m]))
    return tuple(f)


_HALF_PI = float(np.float32(0.5 * math.pi))


def dtlz2(individual, obj):
    """DTLZ2, ``obj`` objectives; spherical front ``sum f_i^2 = 1`` at
    ``g = 0``.  XLA's float32 form: ``g`` fuses each square into the
    running sum (:func:`~deap_tpu_torch._xla_math.fma_product`), the
    angles are ``float32(pi / 2) * x``, ``cos``/``sin`` are glibc's
    (:mod:`deap_tpu_torch._xla_math`) and the products run in index
    order.  Bitwise to the jitted JAX function, and the same on every
    device; written over a leading row axis and registered as its own
    batched form, as :func:`zdt1`."""
    e = (individual[..., obj - 1:] - 0.5).double()
    g = (e[..., 0] * e[..., 0]).float()
    for i in range(1, e.shape[-1]):
        g = fma_product(e[..., i] * e[..., i], g)
    return _dtlz_spherical(individual, obj, g)


batched_op(dtlz2, dtlz2)
