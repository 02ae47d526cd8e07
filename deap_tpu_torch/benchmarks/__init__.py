"""Benchmark objective functions — the PyTorch counterparts of
``deap_tpu/benchmarks/__init__.py``, all 33 of them, with the
subpackages ``binary``, ``movingpeaks``, ``tools`` and ``gp``.  Each
maps one individual (a 1-D tensor) to a tuple of objective scalars;
every function but ``sphere``, ``rastrigin`` and ``rand`` is also
written over a leading row axis and registered as its own batched form,
so the loops call it once on the population (``torch.func.vmap`` cannot
batch the float-bit views of the XLA-form transcendentals and fused
multiply-adds on every torch release).

The float32 forms are the ones XLA's CPU backend compiles for the JAX
function of one individual under ``jax.vmap``, and the same on every
device: bitwise there but in the loops whose transcendental calls XLA
scalarizes inside a vectorized row loop (bohachevsky, the scaled and
skewed rastrigins, schaffer and kursawe at some widths, poloni's and
ZDT4's first / second objective), and DTLZ7's last objective on rare
rows, each within the ulp bound ``tests/test_torch_benchmarks_rest.py``
states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import random
from .._xla_math import (cos, exp, fma, fma_product, pow, row_dot, row_mean,
                         row_prod, row_sum, sin, sqrt, vectorized_row_loop)
from ..ops._dispatch import batched_op
from . import binary, movingpeaks, tools  # noqa: F401  (subpackages)

__all__ = [
    "rand", "plane", "sphere", "cigar", "rosenbrock", "h1", "ackley",
    "bohachevsky", "griewank", "rastrigin", "rastrigin_scaled",
    "rastrigin_skew", "schaffer", "schwefel", "himmelblau", "shekel",
    "kursawe", "schaffer_mo", "zdt1", "zdt2", "zdt3", "zdt4", "zdt6",
    "dtlz1", "dtlz2", "dtlz3", "dtlz4", "dtlz5", "dtlz6", "dtlz7",
    "fonseca", "poloni", "dent",
]


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


def _dtlz_spherical(individual, obj, g, opg=None):
    """The spherical objectives at ``g`` (or at ``opg = 1 + g`` in the
    form the caller's fusion computes it)."""
    ang = _HALF_PI * individual[..., :obj - 1]
    cos_t = cos(ang)
    opg = 1.0 + g if opg is None else opg
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


# --- the rest of the JAX package's functions ----------------------------
# Each is written over a leading row axis (``[..., i]``) and registered as
# its own batched form, in the float32 form XLA compiles for the JAX
# function under ``jax.jit(jax.vmap(f))``: XLA's ``cos``/``sin``/``exp``
# and ``powf`` (:mod:`deap_tpu_torch._xla_math`), an integer power as
# products (jax's binary powering), sums and products in XLA's order
# (``row_sum``, ``row_dot`` when the product is fused into the sum,
# ``row_prod``), and a fused multiply-add wherever XLA contracts a
# product into its only use.

def _f32(v) -> float:
    return float(np.float32(v))


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """jax's ``integer_pow``: binary powering, the running product times
    the current square, each product's subnormal result a signed zero
    (XLA's CPU code runs with subnormals flushed)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else _flush(acc * x)
        y >>= 1
        if y > 0:
            x = _flush(x * x)
    return acc


def _flush(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < _FLT_MIN, v * 0.0, v)


_FLT_MIN = float(np.finfo(np.float32).tiny)


def _fpow(x: torch.Tensor, y) -> torch.Tensor:
    """``x ** y`` as jax traces it: an int exponent is ``integer_pow``,
    a float one ``powf``."""
    if isinstance(y, (int, np.integer)) and not isinstance(y, bool):
        return _ipow(x, int(y))
    return pow(x, float(y))


def _own_batched(fn):
    return batched_op(fn, fn)


def rand(individual, key):
    """A uniform draw from ``key`` (the reference's global ``random``
    made explicit), one a call whatever the individual."""
    del individual
    return random.uniform(key, ()),


@_own_batched
def plane(individual):
    """Plane: the first attribute."""
    return individual[..., 0],


@_own_batched
def cigar(individual):
    """Cigar: ``x_0² + 1e6 sum x_i²``."""
    x0 = individual[..., 0]
    return fma(row_dot(individual, individual), 1e6, x0 * x0),


@_own_batched
def rosenbrock(individual):
    """Rosenbrock: ``sum 100 (x_i² - x_{i+1})² + (1 - x_i)²``, in the
    form XLA's CPU backend compiles for each count of terms (read off its
    machine code at 1, 4, 29 and 99 terms): past 32 each term
    ``fma((1 - x)², 1, 100 t²)`` with ``t = fma(x, x, -y)``, summed in
    windows; from 8 to 32 the vectorized loop
    (:func:`~deap_tpu_torch._xla_math.vectorized_row_loop`), each term
    fused into the running sum as ``fma(u, u, fma(t², 100, s))``; below 8
    the same chain over the terms in order, with ``t = x² - y`` unfused
    from 2 terms (the rows' interleaved loads sit between the product and
    the subtraction)."""
    x, y = individual[..., :-1], individual[..., 1:]
    n = x.shape[-1]
    if n > 32:
        t = fma(x, x, -y)
        u = 1.0 - x
        return row_sum(fma(u, u, 100.0 * (t * t))),
    fused = n == 1 or n >= 8

    def update(acc, lo, hi):
        a, b = x[..., lo:hi], y[..., lo:hi]
        t = fma(a, a, -b) if fused else a * a - b
        u = 1.0 - a
        return fma(u, u, fma(t * t, 100.0, acc))

    return vectorized_row_loop(update, n, torch.zeros_like(x[..., 0])),


@_own_batched
def h1(individual):
    """H1, a 2-D maximization landscape."""
    x0, x1 = individual[..., 0], individual[..., 1]
    s1 = sin(x0 - x1 * 0.125)
    s2 = sin(x1 + x0 * 0.125)
    a, b = x0 - 8.6998, x1 - 6.7665
    return fma(s2, s2, s1 * s1) / (sqrt(fma(a, a, b * b)) + 1.0),


@_own_batched
def bohachevsky(individual):
    """Bohachevsky."""
    x, x1 = individual[..., :-1], individual[..., 1:]
    t = fma(x, x, 2.0 * (x1 * x1))
    t = fma(cos(_f32(3.0 * math.pi) * x), -0.3, t)
    t = fma(cos(_f32(4.0 * math.pi) * x1), -0.4, t)
    return row_sum(t + 0.7),


@_own_batched
def griewank(individual):
    """Griewank: ``sum x² / 4000 - prod cos(x_i / sqrt(i)) + 1``."""
    n = individual.shape[-1]
    root = np.sqrt(np.arange(1, n + 1, dtype=np.float32))
    c = cos(individual / torch.tensor(root, device=individual.device))
    return fma(row_dot(individual, individual), _f32(1.0 / 4000.0),
               -row_prod(c)) + 1.0,


def _rastrigin_terms(s):
    return fma(s, s, -(10.0 * cos(_TWO_PI * s)))


_TWO_PI = _f32(2.0 * math.pi)


@_own_batched
def rastrigin_scaled(individual):
    """Scaled Rastrigin: rastrigin of ``10^(i / (n - 1)) x_i``."""
    n = individual.shape[-1]
    s = torch.tensor(_rastrigin_scales(n), device=individual.device) \
        * individual
    return _f32(10.0 * n) + row_sum(_rastrigin_terms(s)),


def _rastrigin_scales(n: int) -> np.ndarray:
    """``10 ** (i / (n - 1))`` as XLA folds the constant: the float32
    quotient, then ``powf``."""
    e = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    return np.power(np.float32(10.0), e).astype(np.float32)


@_own_batched
def rastrigin_skew(individual):
    """Skewed Rastrigin: rastrigin of ``10 x`` where ``x > 0``."""
    n = individual.shape[-1]
    s = torch.where(individual > 0, 10.0 * individual, individual)
    return _f32(10.0 * n) + row_sum(_rastrigin_terms(s)),


@_own_batched
def schaffer(individual):
    """Schaffer: ``sum s^0.25 (sin²(50 s^0.1) + 1)``, ``s = x_i² +
    x_{i+1}²``."""
    x, x1 = individual[..., :-1], individual[..., 1:]
    s = fma(x, x, x1 * x1)
    w = sin(50.0 * pow(s, 0.1))
    return row_sum(pow(s, 0.25) * fma(w, w, 1.0)),


@_own_batched
def schwefel(individual):
    """Schwefel: ``418.98 n - sum x sin(sqrt |x|)``."""
    n = individual.shape[-1]
    # the sine's call in the loop keeps each product fused into the sum
    # up to 32 terms (read at 5 terms, where row_dot's own rule does not)
    return _f32(418.9828872724339 * n) - row_dot(
        individual, sin(sqrt(individual.abs())), fused=n <= 32),


@_own_batched
def himmelblau(individual):
    """Himmelblau, 2-D."""
    x0, x1 = individual[..., 0], individual[..., 1]
    a = fma(x0, x0, x1) - 11.0
    b = fma(x1, x1, x0) - 7.0
    return fma(a, a, b * b),


@_own_batched
def shekel(individual, a, c):
    """Shekel: ``sum_j 1 / (c_j + |x - a_j|²)`` over the peaks ``a``
    ``(m, dim)`` and widths ``c`` ``(m,)``."""
    a, c = (torch.as_tensor(v, dtype=torch.float32, device=individual.device)
            for v in (a, c))
    d = individual[..., None, :] - a
    return row_sum(1.0 / (c + row_dot(d, d))),


def _kursawe_radii2(x, y):
    """``x_i² + x_{i+1}²`` as XLA compiles Kursawe's first objective.
    Up to 3 terms the loop is unrolled and each interior square is one
    value shared by two terms: only a square with one use is fused into
    its add (the first term's ``x_0²``, the last term's ``x_n²``).  From 4
    to 32 terms the loop is vectorized over shared squares (no fusion);
    past 32 each term fuses its first square."""
    t = x.shape[-1]
    if t > 32:
        return fma(x, x, y * y)
    if t < 4:
        sx, sy = x * x, y * y
        r = sx + sy
        first = fma(x[..., :1], x[..., :1], sy[..., :1])
        if t == 1:
            return first
        last = fma(y[..., -1:], y[..., -1:], sx[..., -1:])
        return torch.cat([first, r[..., 1:-1], last], -1)
    return x * x + y * y


@_own_batched
def kursawe(individual):
    """Kursawe, two objectives: ``sum -10 exp(-0.2 sqrt(x_i² +
    x_{i+1}²))`` (each product with -10 fused into the sum up to 32
    terms) and ``sum |x|^0.8 + 5 sin(x³)``."""
    x, y = individual[..., :-1], individual[..., 1:]
    f1 = row_dot(exp(-0.2 * sqrt(_kursawe_radii2(x, y))), -10.0,
                 fused=x.shape[-1] <= 32)
    f2 = row_sum(fma(sin(_ipow(individual, 3)), 5.0,
                     pow(individual.abs(), 0.8)))
    return f1, f2


@_own_batched
def schaffer_mo(individual):
    """Schaffer's bi-objective function of one attribute."""
    x0 = individual[..., 0]
    d = x0 - 2.0
    return x0 * x0, d * d


def _zdt_g(individual):
    n = individual.shape[-1]
    return fma(row_sum(individual[..., 1:]),
               _f32(np.float32(9.0) * (np.float32(1.0) / np.float32(n - 1))),
               1.0)


@_own_batched
def zdt2(individual):
    """ZDT2: ``f2 = g (1 - (f1 / g)²)``."""
    f1 = individual[..., 0]
    g = _zdt_g(individual)
    r = f1 / g
    return f1, g * fma(-r, r, 1.0)


@_own_batched
def zdt3(individual):
    """ZDT3: ``f2 = g (1 - sqrt(f1 / g) - f1 / g sin(10 pi f1))``."""
    f1 = individual[..., 0]
    g = _zdt_g(individual)
    r = f1 / g
    return f1, g * fma(-r, sin(_f32(10.0 * math.pi) * f1), 1.0 - sqrt(r))


@_own_batched
def zdt4(individual):
    """ZDT4: rastrigin-like ``g`` over the tail."""
    n = individual.shape[-1]
    tail = individual[..., 1:]
    g = _f32(1.0 + 10.0 * (n - 1)) + row_sum(
        fma(cos(_f32(4.0 * math.pi) * tail), -10.0, tail * tail))
    f1 = individual[..., 0]
    return f1, g * (1.0 - sqrt(f1 / g))


@_own_batched
def zdt6(individual):
    """ZDT6: ``f1 = 1 - exp(-4 x_1) sin⁶(6 pi x_1)``, ``g = 1 + 9
    (sum / (n - 1))^0.25``."""
    n = individual.shape[-1]
    x0 = individual[..., 0]
    g = fma(pow(row_sum(individual[..., 1:]) * _f32(1.0 / (n - 1)), 0.25),
            9.0, 1.0)
    f1 = fma(-exp(-4.0 * x0), _ipow(sin(_f32(6.0 * math.pi) * x0), 6), 1.0)
    r = f1 / g
    return f1, g * fma(-r, r, 1.0)


def _dtlz_rastrigin_opg(xm):
    """``1 + g`` of DTLZ1 and DTLZ3: XLA fuses the product with 100 into
    the add of 1, ``fma(n + sum, 100, 1)``."""
    d = xm - 0.5
    s = row_sum(fma(d, d, -cos(_f32(20.0 * math.pi) * d)))
    return fma(float(xm.shape[-1]) + s, 100.0, 1.0)


@_own_batched
def dtlz1(individual, obj):
    """DTLZ1, ``obj`` objectives; linear front ``sum f = 0.5``."""
    opg = _dtlz_rastrigin_opg(individual[..., obj - 1:])
    f = [0.5 * row_prod(individual[..., :obj - 1]) * opg]
    for m in range(obj - 2, -1, -1):
        head = 0.5 * row_prod(individual[..., :m]) if m else 0.5
        f.append(head * (1.0 - individual[..., m]) * opg)
    return tuple(f)


@_own_batched
def dtlz3(individual, obj):
    """DTLZ3: DTLZ2's spherical front with DTLZ1's multimodal ``g``."""
    return _dtlz_spherical(individual, obj, None,
                           _dtlz_rastrigin_opg(individual[..., obj - 1:]))


@_own_batched
def dtlz4(individual, obj, alpha):
    """DTLZ4: DTLZ2 with the meta-variable mapping ``x -> x^alpha``."""
    d = individual[..., obj - 1:] - 0.5
    return _dtlz_spherical(_fpow(individual, alpha), obj, row_dot(d, d))


def _dtlz56(ind, n_objs, gval):
    opg = 1.0 + gval
    # a true float32 division (``pi / t`` of a Python float would be
    # torch's reciprocal times pi)
    scale = torch.full_like(opg, math.pi) / (4.0 * opg)

    def theta(x):
        return scale[..., None] * fma(2.0 * gval[..., None], x, 1.0)

    half0 = _HALF_PI * ind[..., 0]
    c0 = opg * cos(half0)
    fit = [c0 * row_prod(cos(theta(ind[..., 1:])))]
    for m in range(n_objs - 1, 0, -1):
        if m == 1:
            fit.append(opg * sin(half0))
        else:
            fit.append(c0 * row_prod(cos(theta(ind[..., 1:m - 1])))
                       * sin(theta(ind[..., m - 1:m]))[..., 0])
    return tuple(fit)


@_own_batched
def dtlz5(ind, n_objs):
    """DTLZ5: degenerate curve front (the reference's index
    conventions: ``theta`` over ``ind[1:]`` in ``f_0``)."""
    d = ind[..., n_objs - 1:] - 0.5
    return _dtlz56(ind, n_objs, row_dot(d, d))


@_own_batched
def dtlz6(ind, n_objs):
    """DTLZ6: DTLZ5 with ``g = sum x^0.1``."""
    return _dtlz56(ind, n_objs, row_sum(pow(ind[..., n_objs - 1:], 0.1)))


@_own_batched
def dtlz7(ind, n_objs):
    """DTLZ7: disconnected front."""
    tail = ind[..., n_objs - 1:]
    opg = 1.0 + fma(row_sum(tail), _f32(9.0 / tail.shape[-1]), 1.0)
    head = ind[..., :n_objs - 1]
    h = row_dot(head / opg[..., None],
                1.0 + sin(_f32(3.0 * math.pi) * head))
    fit = [ind[..., i] for i in range(n_objs - 1)]
    fit.append(opg * (float(n_objs) - h))
    return tuple(fit)


_INV_SQRT3 = _f32(np.float32(1.0) / np.sqrt(np.float32(3.0)))


@_own_batched
def fonseca(individual):
    """Fonseca & Fleming, three attributes."""
    x = individual[..., :3]
    a, b = x - _INV_SQRT3, x + _INV_SQRT3
    return 1.0 - exp(-row_dot(a, a)), 1.0 - exp(-row_dot(b, b))


def _poloni_mix(s1, c1, s2, c2, p, q, r, t):
    """``p sin x1 - q cos x1 + r sin x2 - t cos x2``."""
    return fma(c2, -t, fma(s2, r, fma(c1, -q, s1 * p)))


@_own_batched
def poloni(individual):
    """Poloni, two attributes."""
    x1, x2 = individual[..., 0], individual[..., 1]
    s1, c1 = sin(x1), cos(x1)
    s2, c2 = sin(x2), cos(x2)
    b1 = _poloni_mix(s1, c1, s2, c2, 0.5, 2.0, 1.0, 1.5)
    b2 = _poloni_mix(s1, c1, s2, c2, 1.5, 1.0, 2.0, 0.5)
    u, v = _POLONI_A1 - b1, _POLONI_A2 - b2
    w, z = x1 + 3.0, x2 + 1.0
    return fma(v, v, fma(u, u, 1.0)), fma(w, w, z * z)


def _poloni_constants():
    """XLA folds ``a1``, ``a2`` in float32, each operation rounded (its
    evaluator does not contract)."""
    f = np.float32
    one = torch.tensor([1.0, 2.0])
    s, c = sin(one).numpy(), cos(one).numpy()
    a1 = f(f(f(f(0.5) * s[0]) - f(f(2.0) * c[0])) + s[1]) - f(f(1.5) * c[1])
    a2 = f(f(f(f(1.5) * s[0]) - c[0]) + f(f(2.0) * s[1])) - f(f(0.5) * c[1])
    return float(a1), float(a2)


_POLONI_A1, _POLONI_A2 = _poloni_constants()


def dent(individual, lambda_=0.85):
    """Dent, two attributes."""
    x1, x2 = individual[..., 0], individual[..., 1]
    dm, dp = x1 - x2, x1 + x2
    d = lambda_ * exp(-(dm * dm))
    s = sqrt(fma(dp, dp, 1.0))
    t = sqrt(fma(dm, dm, 1.0))
    return (fma(((s + t) + x1) - x2, 0.5, d),
            fma(((s + t) - x1) + x2, 0.5, d))


batched_op(dent, dent)
