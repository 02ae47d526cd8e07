"""Benchmark objective functions — the PyTorch counterparts of
``deap_tpu/benchmarks/__init__.py``.  Each maps ONE individual (a 1-D
tensor) to a tuple of objective scalars; the loops vmap them over the
population with ``torch.func.vmap``."""

from __future__ import annotations

import math

import numpy as np
import torch

from .._xla_math import cos, exp, fma, row_mean, sqrt
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
    """ZDT1 — two objectives, the NSGA-II benchmark's default problem.
    The sum runs in torch's order, not XLA's (the tests state rtol
    1e-6)."""
    n = individual.shape[-1]
    g = 1.0 + 9.0 * torch.sum(individual[1:]) / (n - 1)
    f1 = individual[0]
    return f1, g * (1.0 - sqrt(f1 / g))


def _dtlz_spherical(individual, obj, g, transform=lambda x: x):
    xc = transform(individual[:obj - 1])
    cos_t = torch.cos(0.5 * math.pi * xc)
    f = [(1.0 + g) * torch.prod(cos_t)]
    for m in range(obj - 2, -1, -1):
        f.append((1.0 + g) * torch.prod(cos_t[:m])
                 * torch.sin(0.5 * math.pi * xc[m]))
    return tuple(f)


def dtlz2(individual, obj):
    """DTLZ2, ``obj`` objectives; spherical front ``sum f_i^2 = 1`` at
    ``g = 0``.  Written with torch's own ``cos``/``sin``, which differ
    from XLA's by a few ulp (the tests state rtol 1e-6)."""
    xm = individual[obj - 1:]
    g = torch.sum((xm - 0.5) ** 2)
    return _dtlz_spherical(individual, obj, g)
