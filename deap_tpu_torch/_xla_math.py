"""XLA's own f32 expansions of ``log``, ``log1p``, ``exp``, ``expm1`` and
``erf_inv``, written with correctly rounded float32 operations only.

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

import numpy as np
import torch

__all__ = ["fma", "sqrt", "log", "log1p", "exp", "expm1", "erf_inv"]

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
    formed exactly in float64, the sum is rounded to odd there (TwoSum
    error, then a nudge to the odd neighbour), and the final rounding to
    float32 is then the correct one.  Operands are float32 tensors or
    Python numbers, which are first rounded to float32."""
    a, b, c = (x.double() if torch.is_tensor(x)
               else torch.tensor(float(np.float32(x)), dtype=torch.float64)
               for x in (a, b, c))
    p = a * b                                   # exact: 24 + 24 bits
    s = p + c
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


def _tanh(h: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(h, -_TANH_CLAMP, _TANH_CLAMP)
    t2 = t * t
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
    small = _tanh(h) * (e + 1.0)
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
