"""XLA's own f32 expansions of ``log``, ``log1p``, ``exp``, ``expm1`` and
``erf_inv``, written with correctly rounded float32 operations only, and
the C library's ``sinf``/``cosf``/``powf`` that XLA's CPU backend calls.

The JAX package's numbers come from XLA's CPU emitter: ``log`` and
``exp`` are the Cephes polynomials (as in Eigen's ``plog``/``pexp``),
``log1p`` is a Cephes rational for ``|x| < sqrt(2) - 1`` and
``log(1 + x)`` above it, ``expm1`` is ``tanh(x/2) * (exp(x) + 1)`` for
``|x| <= 0.5`` with Eigen's rational ``tanh``, and ``erf_inv`` is Giles'
single-precision polynomial in ``w = -log1p(-x*x)``.  XLA's CPU backend then contracts
every multiply whose only use is an add into one fused multiply-add.

Each function below repeats that sequence of operations in the same
order with the same float32 constants, with :func:`fma` exactly where
XLA fuses and separately rounded operations everywhere else.  Every
step is correctly rounded on the CPU and on the card (``sqrt`` goes
through float64 because PyTorch's vectorized float32 ``sqrt`` on the CPU
is not), so the results are bitwise-equal to ``jax.jit`` on the CPU and
identical on every device (pinned by ``tests/test_torch_random.py``).
The CUDA kernels in ``deap_tpu_torch/kernels/megakernel.cu`` carry the
same ``log``, ``log1p`` and ``erf_inv`` with ``__fmaf_rn`` and explicit
round-to-nearest intrinsics.

``torch.log1p``/``torch.erfinv`` would be within a few ulp, but differ
from XLA on a few percent of inputs, and from each other across devices.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["fma", "fma_product", "deferred_rounding", "fma64", "sqrt", "log", "log1p", "exp",
           "expm1", "tanh", "erf_inv", "sin", "cos", "sincos",
           "sincos_small", "pow", "row_sum", "row_sum_vectorized", "row_dot",
           "row_prod", "row_mean", "cumsum", "vectorized_row_loop"]

_INF = float("inf")
_FLT_MIN = 1.1754943508222875e-38           # smallest normal float32
_SQRTHF = 0.7071067690849304
# Cephes logf polynomial, highest degree first
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
# Cephes log1p rational on |x| < sqrt(2) - 1, highest degree first
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_SMALL = 0.4142135679721832
# Cephes expf
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)
# Eigen's rational tanh (odd numerator over even denominator in t*t)
_TANH_CLAMP = 7.998811721801758
_TANH_TINY = 0.00039999998989515007
_TANH_NUM = (-2.7607683663038313e-16, 2.0001879384549948e-13,
             -8.604671836165423e-11, 5.122297253024044e-08,
             1.4857223504805006e-05, 0.0006372619536705315,
             0.004893524572253227)
_TANH_DEN = (1.1982583600911312e-06, 0.00011853470641653985,
             0.0022684347350150347, 0.0048935250379145145)
# Giles' erfinv, w < 5 and w >= 5, highest degree first
_ERFINV_LT = (2.810226362726098e-08, 3.432739390518691e-07,
              -3.523387704262859e-06, -4.391506536194356e-06,
              0.00021858086984138936, -0.001253725029528141,
              -0.004177681636065245, 0.24664072692394257, 1.5014094114303589)
_ERFINV_GE = (-0.0002002142573473975, 0.0001009505576803349,
              0.0013493432197719812, -0.003673428436741233,
              0.005739507731050253, -0.007622461300343275,
              0.00943887047469616, 1.0016740560531616, 2.832976818084717)


def fma(a, b, c) -> torch.Tensor:
    """Exactly rounded float32 ``a * b + c`` (one rounding, as the FMA
    instruction).  PyTorch has no fused multiply-add, so the product is
    formed exactly in float64 and added by :func:`fma_product`.  Operands
    are float32 tensors (or float64 tensors holding float32 values, not
    widened again) or Python numbers, which are first rounded to float32;
    one of ``a`` and ``b`` is a tensor."""
    a, b = (x.double() if torch.is_tensor(x) else float(np.float32(x))
            for x in (a, b))
    return fma_product(a * b, c)                # exact: 24 + 24 bits


class DeferredRounding:
    """The float64 products and sums that :func:`fma` and
    :func:`fma_product` rounded straight to float32 inside
    :func:`deferred_rounding`."""

    def __init__(self):
        self.terms = []             # (p, c, s): product, addend, sum
        self.flag = None

    def check(self) -> None:
        """Test the sums kept so far, in one group of launches, for one
        whose straight rounding may differ from the exact one: an inexact
        float64 sum (TwoSum error) that :func:`_may_round_twice`."""
        if not self.terms:
            return
        p, c, s = (torch.cat([t[i].reshape(-1) for t in self.terms])
                   for i in range(3))
        self.terms.clear()
        bv = s - p
        err = (p - (s - bv)) + (c - bv)
        bad = ((err != 0) & _may_round_twice(s)).any()
        self.flag = bad if self.flag is None else self.flag | bad

    def exact(self) -> bool:
        """Whether every straight rounding was the exact one (one host
        read)."""
        self.check()
        return self.flag is None or not bool(self.flag)


_DEFERRED = [None]          # the active DeferredRounding, if any


@contextlib.contextmanager
def deferred_rounding():
    """Within the block :func:`fma` and :func:`fma_product` skip their
    round-to-odd correction: the float64 sum is rounded straight to
    float32, which is the exact result unless the sum is inexact and
    :func:`_may_round_twice`, and the terms are kept.  The yielded
    :class:`DeferredRounding` tests the kept terms in bulk (``check()``)
    and says at the end whether every result was exact (``exact()``);
    where one may not be, the caller recomputes outside the block.  A
    loop of many small FMAs saves most of their launches this way."""
    record = DeferredRounding()
    prev, _DEFERRED[0] = _DEFERRED[0], record
    try:
        yield record
    finally:
        _DEFERRED[0] = prev


def _may_round_twice(s: torch.Tensor) -> torch.Tensor:
    """Where rounding an inexact float64 sum ``s`` straight to float32 may
    differ from rounding the exact sum: ``s`` is a float32 midpoint (its
    low 29 mantissa bits ``0x10000000``; every midpoint is a float64
    value, so elsewhere the exact sum lies on the same side of each as
    ``s``), or below float32's normal range, where the midpoints lie
    elsewhere."""
    low = s.view(torch.int64) & 0x1FFFFFFF
    return (low == 0x10000000) | (s.abs() < _FLT_MIN)


def fma_product(p: torch.Tensor, c) -> torch.Tensor:
    """``p + c`` rounded once to float32, ``p`` a float64 tensor holding an
    exact product of two float32 values (the second half of :func:`fma`;
    a caller forming many products at once saves their conversions).
    The sum is rounded to odd in float64 (TwoSum error, then a nudge to
    the odd neighbour), so its final rounding to float32 is the correct
    one (inside :func:`deferred_rounding`, the straight rounding, checked
    later).  ``c`` is a float32 tensor or a Python number."""
    c = c.double() if torch.is_tensor(c) else float(np.float32(c))
    s = p + c
    if _DEFERRED[0] is not None:
        if not torch.is_tensor(c):
            c = torch.full_like(p, c)
        _DEFERRED[0].terms.append(torch.broadcast_tensors(p, c, s))
        return s.float()
    bv = s - p                                  # TwoSum error of s
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64: its
    rounding to float32 is exact for square roots)."""
    return torch.sqrt(x.double()).float()


def log(v: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 natural logarithm."""
    x = torch.where(v > _FLT_MIN, v, _FLT_MIN)
    b = x.view(torch.int32)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y1 = fma(fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    y2 = fma(fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    y3 = fma(fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    y = fma(y1, x3, y2)
    y = fma(y, x3, y3)
    y = fma(y, x3, e * _LOG_Q1)
    x = x - x2 * 0.5                            # x2 * 0.5 is exact
    x = fma(e, _LOG_Q2, x + y)
    out = torch.where(v > 0, x, float("nan"))
    out = torch.where(v == _INF, _INF, out)
    return torch.where(v == 0, -_INF, out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``."""
    large = log(x + 1.0)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, c)
    den = torch.full_like(x, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, c)
    x2 = x * x
    # XLA fuses x2 * -0.5 into the add; the product is exact, so the
    # separately rounded sum is the same number
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 exponential (Cephes, range-clamped)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(fx, -_LOG_Q2, x)
    r = fma(fx, -_LOG_Q1, r)
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, r, c)
    y = fma(y, r * r, r)
    y = y + 1.0
    # 2**fx as float bits: (fx + 127) << 23, never a negative shift
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


def tanh(h: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``tanh`` (Eigen's rational form): ``h`` itself
    below ``|h| < 0.0004``, +-1 from ``|h| >= 20``, else the odd
    polynomial over the even one in ``t = clamp(h, +-7.9988117)`` with
    every multiply fused into its add.  Bitwise to jitted ``jnp.tanh``
    over every float32 class (``tests/test_torch_evopole.py``)."""
    t = torch.clamp(h, -_TANH_CLAMP, _TANH_CLAMP)
    t2 = (t * t).double()               # widened once for every FMA
    p = fma(t2, _TANH_NUM[0], _TANH_NUM[1])
    for c in _TANH_NUM[2:]:
        p = fma(t2, p, c)
    q = fma(t2, _TANH_DEN[0], _TANH_DEN[1])
    for c in _TANH_DEN[2:]:
        q = fma(t2, q, c)
    th = (t * p) / q
    th = torch.where(h.abs() < _TANH_TINY, h, th)
    return torch.where(h.abs() >= 20.0, torch.copysign(torch.ones_like(h), h),
                       th)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``expm1``."""
    e = exp(x)
    h = x * 0.5
    small = tanh(h) * (e + 1.0)
    out = torch.where(x.abs() > 0.5, e - 1.0, small)
    return torch.where(h == 0, x, out)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function (Giles' polynomial)."""
    lg = log1p(x * -x)
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg, sqrt(-lg) - 3.0)
    p = torch.where(lt, _ERFINV_LT[0], _ERFINV_GE[0])
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = fma(p, w, torch.where(lt, a, b))
    return x * torch.where(x.abs() == 1.0, _INF, p)


# XLA's CPU backend calls the C library's sinf/cosf; glibc's are ARM's
# optimized routines: the argument is reduced and the polynomial evaluated
# in double precision, then rounded to float32 once.  Abstop12 thresholds
# (exponent and top three mantissa bits of |y|): 2^-12, 0.75, 120, inf.
_TOP_TINY, _TOP_POLY, _TOP_FAST, _TOP_INF = 0x398, 0x3F4, 0x42F, 0x7F8
_SINCOS_TINY, _SINCOS_POLY = 2.0 ** -12, 0.75       # |y| at TINY and POLY
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")    # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")          # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")       # 2pi * 2^-64
# cosine c0..c4 (negated in the second table), sine s1..s3
_COS_POLY = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
# 4/pi to 192 bits, 8 new bits per word
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_M32 = 0xFFFFFFFF


def _mul_32x32(a, b):
    """``a * b`` for uint32 words (int64 tensors) as the (hi, lo) uint32
    words of the 64-bit product, in 16-bit halves so nothing overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    lo_lo = a_lo * b_lo
    mid = a_hi * b_lo + a_lo * b_hi                 # < 2^33
    hi_hi = a_hi * b_hi
    lo = lo_lo + ((mid & 0xFFFF) << 16)
    hi = hi_hi + (mid >> 16) + (lo >> 32)
    return hi & _M32, lo & _M32


def _reduce_large(bits: torch.Tensor):
    """glibc's ``reduce_large``: the float's bits (as int64, |y| >= 120)
    times 4/pi in a 32 x 96 -> 128-bit product; returns the reduced
    argument (float64) and the quadrant (int64)."""
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=bits.device)
    base = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    xi = ((bits & 0xFFFFFF) | 0x800000) << shift
    a0, a4, a8 = table[base], table[base + 4], table[base + 8]
    r0 = (xi * (a0 & 0xFFFF) + (((xi * (a0 >> 16)) & 0xFFFF) << 16)) & _M32
    r1_hi, r1_lo = _mul_32x32(xi, a4)
    r2_hi, _ = _mul_32x32(xi, a8)
    # res0 = ((r2 >> 32) | (r0 << 32)) + r1, modulo 2^64, as (hi, lo)
    lo = r2_hi + r1_lo
    hi = (r0 + r1_hi + (lo >> 32)) & _M32
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30             # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & _M32                    # res0 -= n << 62
    signed_hi = torch.where(hi >= (1 << 31), hi - (1 << 32), hi)
    res = signed_hi * (1 << 32) + lo                # (int64_t) res0
    return res.double() * _PI63, n


def _sincos(y: torch.Tensor, want: tuple) -> list:
    """glibc's ``sinf``/``cosf`` of ``y``: the values named in ``want``
    (``"sin"``, ``"cos"``), sharing one argument reduction."""
    y = y.float()
    bits = y.view(torch.int32).to(torch.int64) & _M32
    top = (bits >> 20) & 0x7FF
    negative = bits >> 31
    x = y.double()
    # |y| < 120: one multiply-subtract by pi/2
    r = x * _HPI_INV
    n_fast = (r.to(torch.int32).to(torch.int64) + 0x800000) >> 24
    x_fast = x - n_fast.double() * _HPI
    x_large, n_large = _reduce_large(bits)
    fast = top < _TOP_FAST
    xr = torch.where(fast, x_fast, x_large)
    n = torch.where(fast, n_fast, n_large)
    quadrant = torch.where(fast, n, n + negative)
    sign = torch.where((quadrant & 3 == 1) | (quadrant & 3 == 2), -1.0, 1.0)
    negate_cos = (quadrant & 2) != 0
    poly = top < _TOP_POLY                          # no reduction below 0.75
    xs = torch.where(poly, x, xr * sign)
    x2 = torch.where(poly, x * x, xr * xr)
    negate_cos = negate_cos & ~poly
    n = torch.where(poly, 0, n)
    # sine polynomial
    x3 = xs * x2
    s1 = _SIN_POLY[1] + x2 * _SIN_POLY[2]
    x7 = x3 * x2
    s = xs + x3 * _SIN_POLY[0]
    sin_val = s + x7 * s1
    # cosine polynomial (its coefficients negated in the second table)
    c = torch.where(negate_cos, -1.0, 1.0).double()
    x4 = x2 * x2
    c2 = c * _COS_POLY[3] + x2 * (c * _COS_POLY[4])
    c1 = c * _COS_POLY[0] + x2 * (c * _COS_POLY[1])
    x6 = x4 * x2
    cc = c1 + x4 * (c * _COS_POLY[2])
    cos_val = cc + x6 * c2
    odd = (n & 1) != 0
    tiny = top < _TOP_TINY
    nan = top >= _TOP_INF
    out = []
    for name in want:
        is_cos = name == "cos"
        # an odd quadrant swaps the two polynomials
        v = torch.where(odd ^ is_cos, cos_val, sin_val).float()
        v = torch.where(tiny, torch.ones_like(y) if is_cos else y, v)
        out.append(torch.where(nan, float("nan"), v))
    return out


def sin(y: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 sine (glibc's ``sinf``), through float64."""
    return _sincos(y, ("sin",))[0]


def cos(y: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 cosine (glibc's ``cosf``), through float64."""
    return _sincos(y, ("cos",))[0]


def sincos(y: torch.Tensor):
    """``(sin(y), cos(y))`` as :func:`sin` and :func:`cos` give them, from
    one argument reduction."""
    return tuple(_sincos(y, ("sin", "cos")))


def sincos_small(y: torch.Tensor):
    """``(sin(y), cos(y))`` for ``|y| < 0.75``, bitwise to :func:`sincos`
    there (glibc's branch without argument reduction, in its order of
    float64 operations), and NaN elsewhere: a third of the launches,
    and no table copied to the device, for callers whose arguments stay
    small."""
    y = y.float()
    x = y.double()
    x2 = x * x
    x3 = x * x2
    s1 = _SIN_POLY[1] + x2 * _SIN_POLY[2]
    x7 = x3 * x2
    sin_val = (x + x3 * _SIN_POLY[0]) + x7 * s1
    x4 = x2 * x2
    c2 = _COS_POLY[3] + x2 * _COS_POLY[4]
    c1 = _COS_POLY[0] + x2 * _COS_POLY[1]
    x6 = x4 * x2
    cos_val = (c1 + x4 * _COS_POLY[2]) + x6 * c2
    a = y.abs()
    tiny, inside = a < _SINCOS_TINY, a < _SINCOS_POLY
    sin_v = torch.where(tiny, y, sin_val.float())
    cos_v = torch.where(tiny, 1.0, cos_val.float())
    return (torch.where(inside, sin_v, float("nan")),
            torch.where(inside, cos_v, float("nan")))


# XLA's CPU backend lowers float32 ``power`` to ``llvm.pow.f32``, which
# becomes a call of the C library's ``powf``.  glibc's (2.28 and later)
# is ARM's optimized routine: ``exp2(y * log2(x))`` in double precision
# with a 16-entry ``log2`` table and a 32-entry ``exp2`` table, rounded to
# float32 once; on x86-64 with FMA its multiply-adds are fused.  XLA runs
# it with subnormals flushed: a subnormal base reads as the bit pattern 0
# past the zero test (so the subnormal rescale yields exponent -23 of
# nothing), and a subnormal result is a signed zero.
_POWF_LOG2 = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_LOG2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# bits of 2^(i/32) less i << 47
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")            # 0x1.8p52 / 32
_EXP2F_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_POWF_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")
_VELTKAMP = 134217729.0                              # 2^27 + 1
_F32_TINY = float.fromhex("0x1p-149")


def _two_sum(a, b):
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


def _veltkamp(a):
    c = a * _VELTKAMP
    hi = c - (c - a)
    return hi, a - hi


def _round_to_odd_sum(a, b):
    s, err = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """Correctly rounded float64 ``a * b + c`` (Boldo and Melquiond's
    emulation: Dekker's exact product, TwoSum, one sum rounded to odd).
    ``a`` is a float64 tensor, ``b`` and ``c`` float64 tensors or Python
    floats; no operand may be so large or small that the exact product's
    halves overflow or underflow."""
    b, c = (v if torch.is_tensor(v)
            else torch.tensor(v, dtype=torch.float64, device=a.device)
            for v in (b, c))
    uh = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    return th + _round_to_odd_sum(tl, ul)


def _checkint(iy: int) -> int:
    """glibc's ``checkint``: 0 not an integer, 1 odd, 2 even."""
    e = (iy >> 23) & 0xFF
    if e < 0x7F:
        return 0
    if e > 0x7F + 23:
        return 2
    if iy & ((1 << (0x7F + 23 - e)) - 1):
        return 0
    return 1 if iy & (1 << (0x7F + 23 - e)) else 2


def pow(x: torch.Tensor, y: float) -> torch.Tensor:
    """XLA CPU's float32 ``x ** y`` for a scalar exponent ``y`` (finite,
    not zero): glibc's ``powf`` with fused multiply-adds, subnormal bases
    and results flushed as XLA's threads flush them.  Equal to
    ``jax.jit(lambda v: v ** y)`` bit for bit on every float32 base
    (pinned by ``tests/test_torch_sbx_poly.py``)."""
    y = float(np.float32(y))
    if not np.isfinite(y) or y in (0.0, 1.0, 2.0, 3.0, 0.5, -1.0):
        # XLA's simplifier turns 1, 2, 3, 0.5 and -1 into products, a
        # square root and a reciprocal before they reach powf
        raise ValueError(f"pow is ported for the exponents that reach "
                         f"powf, not {y}")
    yint = _checkint(int(np.float32(y).view(np.uint32)))
    x = x.float()
    ix = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    negative = (ix >> 31) != 0
    ax = ix & 0x7FFFFFFF
    # a subnormal base is rescaled by 2^23 in float32, which reads 0 with
    # subnormals flushed: bits 0 less 23 << 23
    ax = torch.where(ax < 0x00800000, -(23 << 23), ax)
    tmp = (ax - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ax - top) & 0xFFFFFFFF
    k = torch.where(top >= (1 << 31), top - (1 << 32), top) >> 23
    tab = torch.tensor(_POWF_LOG2, dtype=torch.float64, device=x.device)
    z = iz.to(torch.int32).view(torch.float32).double()
    r = fma64(z, tab[i, 0], -1.0)
    y0 = tab[i, 1] + k.double()
    a = _POWF_LOG2_POLY
    r2 = r * r
    q = fma64(r2, fma64(r, a[2], a[3]), fma64(r, a[4], y0))
    logx = fma64(fma64(r, a[0], a[1]), r2 * r2, q)
    ylogx = logx * y
    # exp2: ylogx = k/32 + r, 2^(k/32) from the table
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    r = ylogx - (kd - _EXP2F_SHIFT)
    tab2 = torch.tensor([t - (1 << 64) if t >> 63 else t for t in _EXP2F_TAB],
                        dtype=torch.int64, device=x.device)
    signed = negative if yint == 1 else torch.zeros_like(negative)
    s = (tab2[ki & 31] + ((ki + torch.where(signed, 0x10000, 0)) << 47)
         ).view(torch.float64)
    c = _EXP2F_POLY
    p = fma64(fma64(r, c[0], c[1]), r * r, fma64(r, c[2], 1.0))
    out = (p * s).float()
    sign = torch.where(signed, -1.0, 1.0).to(torch.float32)
    out = torch.where(ylogx > _POWF_OFLOW, sign * _INF, out)
    out = torch.where(ylogx < -149.0, sign * _F32_TINY, out)
    out = torch.where(ylogx <= -150.0, sign * 0.0, out)
    if yint == 0:
        out = torch.where(negative, float("nan"), out)
    # zero, infinite and NaN bases
    x2 = x * x
    if yint == 1:
        x2 = torch.where(negative, -x2, x2)
    special = ((ix & 0x7FFFFFFF) == 0) | ((ix & 0x7FFFFFFF) >= 0x7F800000)
    out = torch.where(special, 1.0 / x2 if y < 0 else x2, out)
    return torch.where(out.abs() < _FLT_MIN, sign * 0.0, out)


# XLA's CPU backend rewrites a reduction longer than 32 into windows of
# 32 (zero padding split evenly, the odd one at the end), sums each
# window in order, then reduces the partial sums the same way
_REDUCE_WINDOW = 32


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 sum over the last axis, in its order."""
    n = x.shape[-1]
    if n > _REDUCE_WINDOW:
        return row_sum(row_sum(_windows(x)))
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(n):
        s = s + x[..., i]
    return s


_VECTOR_LANES = 8               # float32 lanes of the host's AVX2 loops


def row_sum_vectorized(x: torch.Tensor) -> torch.Tensor:
    """A float32 sum over the last axis (up to 32 terms) as LLVM's loop
    vectorizer compiles it inside some of XLA's fusions: eight running
    sums over whole chunks of eight terms, folded in halves (lane ``i``
    plus lane ``i + 4``, and again), then the remaining terms in
    order."""
    lanes = _VECTOR_LANES
    n = x.shape[-1]
    m = n - n % lanes
    if m == 0:
        return row_sum(x)
    acc = x[..., :lanes]
    for i in range(lanes, m, lanes):
        acc = acc + x[..., i:i + lanes]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    s = acc[..., 0]
    for i in range(m, n):
        s = s + x[..., i]
    return s


def _windows(x: torch.Tensor) -> torch.Tensor:
    """``x``'s last axis padded with zeros as :func:`row_sum` pads it and
    cut into windows of 32: ``(..., windows, 32)``."""
    n = x.shape[-1]
    m = -(-n // _REDUCE_WINDOW) * _REDUCE_WINDOW
    lo = (m - n) // 2
    x = torch.nn.functional.pad(x, (lo, m - n - lo))
    return x.reshape(x.shape[:-1] + (m // _REDUCE_WINDOW, _REDUCE_WINDOW))


def row_dot(a: torch.Tensor, b, fused: bool | None = None) -> torch.Tensor:
    """XLA CPU's float32 sum over the last axis of ``a * b``.  Its
    backend either fuses each product into the running sum as a fused
    multiply-add (the first product rounded alone) or sums the rounded
    products, in :func:`row_sum`'s order and windows.  Which one depends
    on the program: ``fused=None`` takes what it does for a function of
    one individual under ``jax.vmap`` (a row reduction of an ``(n,
    length)`` input) — fused for lengths up to 4 and from 9 to 32, not
    for 5 to 8 and past 32; ``fused=True`` or ``False`` forces one.
    ``b`` is a tensor that broadcasts against ``a`` or a Python
    number."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, float(np.float32(b)))
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    if fused is None:
        fused = not (n > _REDUCE_WINDOW or 5 <= n <= 8)
    if not fused:
        return row_sum(a * b)
    if n > _REDUCE_WINDOW:
        return row_sum(row_dot(_windows(a), _windows(b), True))
    p = a.double() * b.double()                 # exact products
    s = p[..., 0].float()
    for i in range(1, n):
        s = fma_product(p[..., i], s)
    return s


def row_prod(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 product over the last axis, in :func:`row_sum`'s
    order and windows (padding with ones)."""
    n = x.shape[-1]
    if n > _REDUCE_WINDOW:
        m = -(-n // _REDUCE_WINDOW) * _REDUCE_WINDOW
        lo = (m - n) // 2
        x = torch.nn.functional.pad(x, (lo, m - n - lo), value=1.0)
        x = x.reshape(x.shape[:-1] + (m // _REDUCE_WINDOW, _REDUCE_WINDOW))
        return row_prod(row_prod(x))
    p = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(n):
        p = p * x[..., i]
    return p


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 mean over the last axis: :func:`row_sum` times
    the float32 reciprocal of the length."""
    return row_sum(x) * float(np.float32(1.0 / x.shape[-1]))


# XLA's CPU pipeline rewrites a cumulative sum longer than 16 into blocks
# of 16: each block's prefix sums in order, then the blocks' totals summed
# the same way (recursively) and added to the next block's prefixes
_SCAN_BLOCK = 16


def _prefix_in_order(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for i in range(1, x.shape[-1]):
        out[..., i] = out[..., i - 1] + x[..., i]
    return out


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``jnp.cumsum`` of a 1-D tensor, in its order:
    up to 16 entries one running sum; beyond that, the entries padded
    with zeros to rows of 16, each row's running sum, and to each row
    the sum of the rows before it, taken by this same rule over the row
    totals."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return _prefix_in_order(x)
    m = -(-n // _SCAN_BLOCK)
    rows = _prefix_in_order(torch.nn.functional.pad(
        x, (0, m * _SCAN_BLOCK - n)).reshape(m, _SCAN_BLOCK))
    before = torch.nn.functional.pad(cumsum(rows[:, -1])[:-1], (1, 0))
    return (rows + before[:, None]).reshape(-1)[:n]


_LOOP_LANES, _LOOP_INTERLEAVE = 4, 2


def vectorized_row_loop(update, n: int, init: torch.Tensor) -> torch.Tensor:
    """A float32 sum of ``n`` terms over the last axis as LLVM's loop
    vectorizer compiles it inside an XLA CPU fusion whose loop runs along
    the row: chunks of 4 terms, two interleaved accumulators that the
    backend reassociates into one chain (chunks 0, 2, 4, ..., then 1, 3,
    5, ...), the four lanes folded as ``(l0 + l2) + (l1 + l3)``, then the
    terms past the last whole pair of chunks one at a time.
    ``update(acc, lo, hi)`` adds terms ``lo:hi`` into ``acc`` (last axis
    ``hi - lo``) in the fusion's own form; ``init`` is the row shape's
    starting value (zeros)."""
    step = _LOOP_LANES * _LOOP_INTERLEAVE
    m = n - n % step
    if m:
        acc = init[..., None].expand(init.shape + (_LOOP_LANES,))
        chunks = m // _LOOP_LANES
        for c in (list(range(0, chunks, _LOOP_INTERLEAVE))
                  + list(range(1, chunks, _LOOP_INTERLEAVE))):
            acc = update(acc, c * _LOOP_LANES, (c + 1) * _LOOP_LANES)
        while acc.shape[-1] > 1:
            h = acc.shape[-1] // 2
            acc = acc[..., :h] + acc[..., h:]
        s = acc[..., 0]
    else:
        s = init
    for i in range(m, n):
        s = update(s[..., None], i, i + 1)[..., 0]
    return s
