"""Keys and samplers, bit-compatible with ``jax.random``.

The port keeps the JAX package's explicit-key discipline: every
trajectory is a pure function of a key, and the keys, splits, fold-ins
and raw bits here equal ``jax.random``'s under both key implementations
the JAX package's bench scripts use (pinned bitwise by
``tests/test_torch_random.py`` and ``tests/test_torch_random_rbg.py``).
``torch.Generator`` plays no part.

A key is an ``int64`` tensor of uint32 words whose last dimension names
its implementation:

* ``(..., 2)``: ``threefry2x32`` with ``jax_threefry_partitionable=True``;
* ``(..., 4)``: ``rbg``.  Its ``split`` and ``fold_in`` are threefry on
  each half, ``w[0:2]`` and ``w[2:4]``; its bits are XLA's
  ``rng_bit_generator`` as the CPU backend compiles it, Philox-4x32-10
  with key ``(w0, w1)`` and a 128-bit counter whose low 64 bits start at
  ``w2 | w3 << 32`` and whose high 64 bits are ``w0 | w1 << 32``.

:func:`PRNGKey` makes a key of the module default implementation
(``threefry2x32``) unless told otherwise; :func:`default_impl` sets that
default for a block, as ``jax.default_prng_impl`` does.  Every other
function follows the key's own shape.

A batch of keys ``(*batch, w)`` is what ``jax.vmap`` over per-row keys
sees.  Threefry draws each key's own stream.  ``rbg`` draws as jax's
batching rule for ``rng_bit_generator`` does: the bits of the FIRST key of
the batch at shape ``(*batch, *shape)``, the other keys unread.

PyTorch's ``uint32`` support is thin, so all uint32 arithmetic is done in
``int64`` and masked with ``& 0xFFFFFFFF``.  Plain tensor ops are enough:
threefry and Philox are counter arithmetic, not kernels of the JAX
package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from ._xla_math import erf_inv, fma

__all__ = ["PRNGKey", "default_impl", "impl_of", "key_data", "split",
           "fold_in", "bits", "uniform", "bernoulli", "randint", "normal",
           "permutation", "shuffle", "row_range", "row_range_active",
           "outside_row_range"]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def mul32(a, b):
    """``a * b mod 2**32`` for uint32 words held in int64 (``b`` a
    constant or a tensor of words), split into 16-bit halves so no
    product overflows int64."""
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


#: the active :func:`row_range` windows: local leading size -> (global
#: leading size, first row)
_WINDOWS: list = [{}]
#: the smallest window :func:`row_range` takes: key splits inside the
#: samplers and operators draw 2 to 7 keys, never a window's size
MIN_WINDOW = 8


def _window(shape):
    """``(global_rows, first_row)`` when an active :func:`row_range`
    window claims a draw of ``shape``, else ``None``."""
    if not shape or not _WINDOWS[0]:
        return None
    return _WINDOWS[0].get(int(shape[0]))


def _iota_2x32(shape, device):
    """Row-major counter over ``shape`` as (hi, lo) uint32 words — the
    partitionable layout's ``iota_2x32_shape``.  Inside a
    :func:`row_range` window claiming ``shape[0]``, the counters of rows
    ``[first, first + shape[0])`` of the global shape."""
    n = math.prod(shape)
    win = _window(shape)
    start = 0 if win is None else win[1] * math.prod(shape[1:])
    counts = torch.arange(start, start + n, dtype=torch.int64,
                          device=device).reshape(shape)
    return counts >> 32, counts & M32


@contextlib.contextmanager
def row_range(*ranges):
    """Draw rows of a global draw without drawing the rest.

    Each range is ``(n_global, start, stop)``.  Within the block, a
    threefry draw (:func:`bits` and every sampler over it) or split whose
    shape leads with ``stop - start`` rows is rows ``[start, stop)`` of
    the same draw at leading size ``n_global``: bit for bit the slice of
    the whole draw, because the partitionable layout counts each element
    by its row-major index.  An rbg draw of such a shape is the same
    slice of the first key's stream.

    This is how one rank of a sharded loop draws its own rows of a
    population-wide draw.  A window matches draws by their leading size
    alone, so only code whose draws all lead with the row (or pair) axis
    may run inside one: the samplers, the splits of per-row keys, and the
    operators' batched forms.  Per-row operator calls run under
    :func:`outside_row_range`.  Local sizes below :data:`MIN_WINDOW` are
    refused (the samplers split keys two to seven at a time), and two
    ranges may not share a local size."""
    windows = dict(_WINDOWS[0])
    for n_global, start, stop in ranges:
        n_global, start, stop = int(n_global), int(start), int(stop)
        size = stop - start
        if size < MIN_WINDOW:
            raise ValueError(f"row_range window of {size} rows: needs at "
                             f"least {MIN_WINDOW}")
        if not 0 <= start < stop <= n_global:
            raise ValueError(f"row range [{start}, {stop}) outside "
                             f"{n_global} rows")
        if size in windows:
            raise ValueError(f"two row_range windows of {size} rows")
        windows[size] = (n_global, start)
    old, _WINDOWS[0] = _WINDOWS[0], windows
    try:
        yield
    finally:
        _WINDOWS[0] = old


def row_range_active() -> bool:
    """Is a :func:`row_range` window open?"""
    return bool(_WINDOWS[0])


@contextlib.contextmanager
def outside_row_range():
    """Close every :func:`row_range` window for the block: each draw there
    is a whole draw, whatever its leading size.  A sharded loop runs an
    operator's per-row calls so (a row's own draws, such as a ``(dim,)``
    mask, are not rows of the population) after drawing the per-row keys
    inside the window."""
    old, _WINDOWS[0] = _WINDOWS[0], {}
    try:
        yield
    finally:
        _WINDOWS[0] = old


IMPLS = {"threefry2x32": 2, "rbg": 4}
_DEFAULT = ["threefry2x32"]


def _impl_name(impl) -> str:
    name = _DEFAULT[0] if impl is None else str(impl)
    if name not in IMPLS:
        raise ValueError(f"unknown key implementation {name!r}: expected "
                         f"one of {sorted(IMPLS)}")
    return name


@contextlib.contextmanager
def default_impl(impl: str):
    """Within the block, :func:`PRNGKey` without ``impl`` makes keys of
    ``impl`` (``"threefry2x32"`` or ``"rbg"``): the counterpart of
    ``jax.default_prng_impl`` / ``jax_default_prng_impl``."""
    name = _impl_name(impl)
    old, _DEFAULT[0] = _DEFAULT[0], name
    try:
        yield name
    finally:
        _DEFAULT[0] = old


def impl_of(key: torch.Tensor) -> str:
    """The implementation a key's last dimension names."""
    width = key.shape[-1] if key.ndim else 0
    for name, w in IMPLS.items():
        if w == width:
            return name
    raise ValueError(f"a key's last dimension is 2 (threefry2x32) or 4 "
                     f"(rbg), not shape {tuple(key.shape)}")


def _is_rbg(key: torch.Tensor) -> bool:
    return impl_of(key) == "rbg"


def PRNGKey(seed: int, *, impl: str | None = None, device=None
            ) -> torch.Tensor:
    """A raw key from an integer seed (``jax.random.PRNGKey`` with 64-bit
    types disabled): threefry's words are ``[0, seed mod 2**32]``, rbg's
    are those twice.  ``impl=None`` takes the module default
    (:func:`default_impl`)."""
    dev = resolve_device(device)
    words = [0, int(seed) & M32] * (IMPLS[_impl_name(impl)] // 2)
    return torch.tensor(words, dtype=torch.int64, device=dev)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The key's uint32 words (as int64); keys are already raw."""
    return key


def _words(key: torch.Tensor, ndraw: int):
    """A threefry key's two words, shaped ``(*batch, 1, ..., 1)`` to
    broadcast against ``ndraw`` trailing draw axes."""
    tail = (1,) * ndraw
    return (key[..., 0].reshape(key.shape[:-1] + tail),
            key[..., 1].reshape(key.shape[:-1] + tail))


def _halves(fn, key: torch.Tensor, *args) -> torch.Tensor:
    """An rbg key op: the threefry op ``fn`` on each half, concatenated."""
    return torch.cat([fn(key[..., :2], *args), fn(key[..., 2:], *args)], -1)


def _threefry_split(key: torch.Tensor, shape) -> torch.Tensor:
    hi, lo = _iota_2x32(shape, key.device)
    b1, b2 = threefry2x32(*_words(key, len(shape)), hi, lo)
    return torch.stack([b1, b2], dim=-1)


def _threefry_fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & M32)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``num`` (or ``shape``) new keys per key: ``(*batch, *shape, w)``."""
    shape = _shape(num)
    if _is_rbg(key):
        return _halves(_threefry_split, key, shape)
    return _threefry_split(key, shape)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Mix an integer into a key (``jax.random.fold_in``)."""
    if _is_rbg(key):
        return _halves(_threefry_fold_in, key, data)
    return _threefry_fold_in(key, data)


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m: int):
    """``(hi, lo)`` words of the 64-bit product of a uint32 word and a
    uint32 constant.  The int64 product wraps past 2**63 but keeps its
    bit pattern, so the shift and masks read it as unsigned."""
    p = a * m
    return (p >> 32) & M32, p & M32


def philox4x32(key0, key1, x):
    """Philox-4x32-10 (Random123; XLA's ``Philox``) on four counter words
    ``x``; returns the four output words."""
    k0, k1 = key0, key1
    for _ in range(10):
        hi0, lo0 = _mulhilo(x[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo(x[2], _PHILOX_M[1])
        x = (hi1 ^ x[1] ^ k0, lo1, hi0 ^ x[3] ^ k1, lo0)
        k0 = (k0 + _PHILOX_W[0]) & M32
        k1 = (k1 + _PHILOX_W[1]) & M32
    return x


def _rbg_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``rng_bit_generator(key, shape, uint32)`` on the CPU backend: the
    counters ``c + i`` (128-bit, low half ``w2 | w3 << 32``, high half
    ``w0 | w1 << 32``) each give four words, taken in turn, cut to the
    shape's size."""
    n = math.prod(shape)
    if n == 0:
        return torch.zeros(shape, dtype=torch.int64, device=key.device)
    win = _window(shape)
    first = 0 if win is None else win[1] * math.prod(shape[1:])
    w = key.reshape(-1, 4)[0]
    w0, w1, w2, w3 = w[0], w[1], w[2], w[3]
    i = torch.arange(first // 4, (first + n + 3) // 4, dtype=torch.int64,
                     device=key.device)
    c0 = w2 + (i & M32)
    c1 = w3 + (i >> 32) + (c0 >> 32)
    c2 = w0 + (c1 >> 32)
    c3 = (w1 + (c2 >> 32)) & M32
    x = philox4x32(w0, w1, (c0 & M32, c1 & M32, c2 & M32, c3))
    skip = first % 4
    return torch.stack(x, dim=-1).reshape(-1)[skip:skip + n].reshape(shape)


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Raw uint32 words (as int64) of ``(*batch, *shape)``:
    ``random_bits(key, 32)`` of each key — for an rbg batch, of its first
    key at the whole shape, as under ``jax.vmap``.  Narrower draws
    (jax's 8- and 16-bit ``random_bits``) are these words' low bits under
    both implementations."""
    shape = _shape(shape)
    if _is_rbg(key):
        return _rbg_bits(key, key.shape[:-1] + shape)
    hi, lo = _iota_2x32(shape, key.device)
    b1, b2 = threefry2x32(*_words(key, len(shape)), hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape = (), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Uniform floats in ``[minval, maxval)`` from the top 23 bits.  The
    bounds are Python numbers or float32 tensors that broadcast against
    the draws (device scalars stay on the device: ``span = maxval -
    minval`` in float32, then the FMA and the clamp, as XLA computes
    traced bounds)."""
    if dtype != torch.float32:
        raise TypeError("uniform is ported for float32 only")
    return uniform_from_bits(bits(key, shape), minval, maxval)


def uniform_from_bits(b: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """:func:`uniform`'s float32 law on given raw words ``b`` (the
    streamed engine's slices draw their words at explicit counters:
    :mod:`deap_tpu_torch.bigpop.slicedprng`)."""
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if torch.is_tensor(minval) or torch.is_tensor(maxval):
        lo, hi = (v.to(torch.float32) if torch.is_tensor(v)
                  else float(np.float32(v)) for v in (minval, maxval))
        span = hi - lo
        if not torch.is_tensor(lo):
            lo = torch.full_like(span, lo)
        return torch.maximum(fma(floats, span, lo), lo)
    # bounds stay Python floats (float32 values): a scalar needs no
    # host-to-device copy; XLA fuses the scale-and-shift into one FMA
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(fma(floats, span, lo), min=lo)


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Shape = ()) -> torch.Tensor:
    """Bool draws, true with probability ``p``."""
    return uniform(key, shape) < prob32(p)


def prob32(p: float) -> float:
    """The float32 threshold a uniform is compared with (``u < p``)."""
    return float(np.float32(p))


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint_bits(key: torch.Tensor, shape: Shape):
    """The two words of raw bits that :func:`randint` reduces:
    ``(higher, lower)``, each ``(*batch, *shape)``."""
    shape = _shape(shape)
    ks = split(key)
    return bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)


def _span(minval, maxval):
    """jax's bounds law: both bounds clamped to int32, ``span = maxval -
    minval`` as a uint32 word, 1 when ``maxval <= minval`` (so
    ``minval`` is returned), one more when ``maxval`` was above the
    int32 range.  Python ints stay Python ints (no device copy);
    tensors give tensors.  Returns ``(minval, span)``; a span of 0 is
    the full 2**32 range."""
    if not (torch.is_tensor(minval) or torch.is_tensor(maxval)):
        out_of_range = maxval > _I32_MAX
        minval = min(max(int(minval), _I32_MIN), _I32_MAX)
        maxval = min(max(int(maxval), _I32_MIN), _I32_MAX)
        span = (maxval - minval) & M32
        if maxval <= minval:
            span = 1
        elif out_of_range:
            span = (span + 1) & M32
        return minval, span
    dev = (minval if torch.is_tensor(minval) else maxval).device
    minval, maxval = (torch.as_tensor(b, device=dev).to(torch.int64)
                      for b in (minval, maxval))
    out_of_range = maxval > _I32_MAX
    minval = minval.clamp(_I32_MIN, _I32_MAX)
    maxval = maxval.clamp(_I32_MIN, _I32_MAX)
    span = torch.where(maxval <= minval, 1, (maxval - minval) & M32)
    span = torch.where(out_of_range & (maxval > minval), (span + 1) & M32,
                       span)
    return minval, span


def randint_from_bits(higher, lower, minval, maxval) -> torch.Tensor:
    """jax's two-word modulus law on raw bits (biased exactly as jax's is
    when the span is not a power of two).  ``minval``/``maxval`` are
    Python ints or integer tensors that broadcast against the bits."""
    minval, span = _span(minval, maxval)
    full = span == 0            # the full 2**32 range: remainders are no-ops
    safe = torch.where(full, 1, span) if torch.is_tensor(span) else (
        1 if full else span)
    mult = (1 << 16) % safe
    mult = ((mult * mult) & M32) % safe         # the square wraps, as in jax
    offset = (mul32(higher % safe, mult) + (lower % safe)) & M32
    if torch.is_tensor(full):
        offset = torch.where(full, lower, offset % safe)
    else:
        offset = lower if full else offset % safe
    out = (minval + offset + (1 << 31)) & M32
    return (out - (1 << 31)).to(torch.int32)


def randint(key: torch.Tensor, shape: Shape, minval, maxval,
            dtype=torch.int32) -> torch.Tensor:
    """Integer draws in ``[minval, maxval)`` of ``(*batch, *shape)``.  The
    bounds are Python ints or integer tensors of the key batch's shape
    (one bound per key, as a traced bound under ``jax.vmap``).

    ``dtype`` int8 or int16 takes jax's narrow law: Python int bounds
    clipped to ``[min, max]`` and ``[min, max + 1]`` of the dtype, the
    int32 draw on those, and its conversion to the dtype (jax always
    draws at least 32 bits)."""
    shape = _shape(shape)
    if dtype in (torch.int8, torch.int16):
        info = torch.iinfo(dtype)
        lo = min(max(int(minval), info.min), info.max)
        hi = min(max(int(maxval), info.min), info.max + 1)
        return randint(key, shape, lo, hi).to(dtype)
    if dtype != torch.int32:
        raise TypeError(f"randint draws int8, int16 or int32, not {dtype}")
    higher, lower = randint_bits(key, shape)
    tail = (1,) * len(shape)
    minval, maxval = (b.reshape(b.shape + tail) if torch.is_tensor(b) else b
                      for b in (minval, maxval))
    return randint_from_bits(higher, lower, minval, maxval)


# bfloat16 values of jax's constants: nextafter(-1, 0), the span
# 1 - nextafter(-1, 0) (2 after rounding) and sqrt(2)
_BF16_LO, _BF16_SPAN, _BF16_SQRT2 = -0.99609375, 2.0, 1.4140625


def _uniform_bf16(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax's bfloat16 uniform in ``[nextafter(-1, 0), 1)``: bfloat16 has
    7 mantissa bits, fewer than 8, so jax draws 8 random bits (the low
    byte of the 32-bit word) and keeps their top 7; every step is a
    bfloat16 operation (XLA computes it in float32 and rounds)."""
    b = bits(key, shape) & 0xFF
    one = ((b >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    u = (one - 1.0) * _BF16_SPAN + _BF16_LO
    return torch.clamp(u, min=_BF16_LO)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype=torch.float32) -> torch.Tensor:
    """Standard normals: ``sqrt(2) * erf_inv(u)`` with ``u`` uniform in
    ``(-1, 1)``.  ``erf_inv`` follows XLA's f32 expansion
    (:mod:`deap_tpu_torch._xla_math`).  float32 or bfloat16; in
    bfloat16 the uniform and the product are bfloat16 operations and
    ``erf_inv`` runs in float32 on the widened uniform and is rounded,
    as in the HLO XLA's CPU backend compiles for ``jax.random.normal``."""
    if dtype == torch.bfloat16:
        z = erf_inv(_uniform_bf16(key, shape).float()).to(torch.bfloat16)
        return z * torch.tensor(_BF16_SQRT2, dtype=torch.bfloat16,
                                device=z.device)
    if dtype != torch.float32:
        raise TypeError("normal is ported for float32 and bfloat16 only")
    return normal_erf_inv(key, shape) * SQRT2


# float32(sqrt(2)), the scale jax puts on erf_inv(u)
SQRT2 = 1.4142135381698608


def normal_erf_inv(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """The float32 ``erf_inv(u)`` of :func:`normal`, before its scale by
    :data:`SQRT2`: under ``jit`` XLA folds that scale into the constants
    that multiply the normal (``mut_gaussian``'s ``sigma``)."""
    return erf_inv(uniform(key, shape, torch.float32, NORMAL_LO, 1.0))


# nextafter(-1, 0) in float32: the lower bound of the normal's uniform
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _shuffle_rounds(n: int) -> int:
    """jax's static round count: ``ceil(3 ln(max(1, n)) / ln(2**32 - 1))``
    (one round up to n = 1625, two from there to beyond 2**20)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(float(M32))))


def shuffle(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` in a random order, as ``jax.random.permutation``
    gives them for an array: each round splits the key, draws one 32-bit
    sort key a row and sorts the rows by it, stably (ties keep their
    order, so the result is the same on every device).  The words are
    sorted as int64, whose order is uint32's on the CPU and the card."""
    if key.ndim == 2:
        return _shuffle_rows(key, x)
    if key.ndim != 1:
        raise ValueError("permutation takes one key or a (k, w) batch, "
                         f"not shape {tuple(key.shape)}")
    n = x.shape[0]
    for _ in range(_shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def _shuffle_rows(keys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.vmap`` of the shuffle over a ``(k, w)`` key batch: ``(k, n,
    ...)``, row ``i`` the rows of ``x`` in key ``i``'s order (each key its
    own rounds, a stable sort a row)."""
    n = x.shape[0]
    idx = torch.arange(n, device=keys.device).expand(keys.shape[0], n)
    for _ in range(_shuffle_rounds(n)):
        ks = split(keys)
        keys, sub = ks[:, 0], ks[:, 1]
        order = torch.sort(bits(sub, (n,)), dim=1, stable=True).indices
        idx = idx.gather(1, order)
    return x[idx]


def permutation(key: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation``: for an integer ``n``, a random int32
    permutation of ``arange(n)``; for a tensor, its rows shuffled (see
    :func:`shuffle`).  A ``(k, w)`` batch of keys gives ``k`` of them,
    one a key, as ``jax.vmap`` over the keys does."""
    if torch.is_tensor(x):
        return shuffle(key, x)
    return shuffle(key, torch.arange(int(x), dtype=torch.int32,
                                     device=key.device))
