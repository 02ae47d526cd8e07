"""Symbolic-regression target functions — the PyTorch counterparts of
``deap_tpu/benchmarks/gp.py`` (reference ``deap/benchmarks/gp.py``).

``data`` holds the input variables on its first axis: a ``(n_vars,)``
vector, as the JAX package's functions take under ``jax.vmap``, or
``(n_vars, *points)`` for many points at once.  Each function is the
float32 form XLA's CPU backend compiles for the JAX function: its
``exp``/``sin``/``cos`` (:mod:`deap_tpu_torch._xla_math`), ``x ** k``
as products, and a fused multiply-add wherever a product's only use is
an addition, so the values equal the jitted JAX function's (XLA flushes
subnormal results to zero, which the port does not)."""

from __future__ import annotations

import torch

from .._xla_math import cos, exp, fma, sin

__all__ = ["kotanchek", "salustowicz_1d", "salustowicz_2d", "unwrapped_ball",
           "rational_polynomial", "rational_polynomial2", "sin_cos", "ripple"]


def kotanchek(data):
    """Kotanchek: ``exp(-(x0 - 1)^2) / (3.2 + (x1 - 2.5)^2)``."""
    a, b = data[0] - 1.0, data[1] - 2.5
    return torch.div(exp(-(a * a)), fma(b, b, 3.2))


def _salustowicz(x):
    s, c = sin(x), cos(x)
    return exp(-x) * (x * (x * x)) * c * s * fma(c, s * s, -1.0)


def salustowicz_1d(data):
    """Salustowicz 1-D: ``exp(-x) x^3 cos(x) sin(x) (cos(x) sin(x)^2 -
    1)``."""
    return _salustowicz(data[0])


def salustowicz_2d(data):
    """Salustowicz 2-D: the 1-D form times ``(x1 - 5)``."""
    return _salustowicz(data[0]) * (data[1] - 5.0)


def unwrapped_ball(data):
    """Unwrapped ball: ``10 / (5 + sum_i (x_i - 3)^2)``, the squares
    summed in order, each fused into the running sum."""
    acc = torch.zeros_like(data[0])
    for i in range(data.shape[0]):
        t = data[i] - 3.0
        acc = fma(t, t, acc)
    return torch.div(torch.full_like(acc, 10.0), 5.0 + acc)


def rational_polynomial(data):
    """3-D rational polynomial: ``30 (x0 - 1)(x2 - 1) / (x1^2 (x0 -
    10))``."""
    return torch.div(30.0 * (data[0] - 1.0) * (data[2] - 1.0),
                     (data[1] * data[1]) * (data[0] - 10.0))


def rational_polynomial2(data):
    """2-D rational polynomial: ``((x0 - 3)^4 + (x1 - 3)^3 - (x1 - 3)) /
    ((x1 - 2)^4 + 10)``."""
    u, v, w = data[0] - 3.0, data[1] - 3.0, data[1] - 2.0
    u2, w2 = u * u, w * w
    return torch.div(fma(v, v * v, u2 * u2) - v, fma(w2, w2, 10.0))


def sin_cos(data):
    """``6 sin(x0) cos(x1)`` (the reference's documented formula)."""
    return 6.0 * sin(data[0]) * cos(data[1])


def ripple(data):
    """Ripple: ``(x0 - 3)(x1 - 3) + 2 sin((x0 - 4)(x1 - 4))``."""
    s = sin((data[0] - 4.0) * (data[1] - 4.0))
    return fma(data[0] - 3.0, data[1] - 3.0, 2.0 * s)
