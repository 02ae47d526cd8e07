"""deap_tpu_torch.random and deap_tpu_torch._xla_math against jitted JAX.

The port's threefry keys, splits, fold-ins, raw bits and samplers are
pinned bitwise to ``jax.random`` (threefry2x32, partitionable layout) over
a battery of seeds.  XLA's float32 ``log1p``/``expm1``/``erf_inv`` are
reproduced operation for operation, FMA contractions included, so
``normal``, the transcendental battery and the tournament positions are
bitwise too: the stated ulp bound is 0 (inputs avoid subnormals, which
XLA's CPU backend flushes to zero).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from deap_tpu.ops import selection as jsel
from deap_tpu_torch import _xla_math as xm
from deap_tpu_torch import interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import selection as tsel

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

SEEDS = [0, 1, 42, -5, 123456789, 2**31 - 1, 2**32 - 1]
N = 4096
ULP_BOUND = 0


def _tkey(seed):
    return tr.PRNGKey(seed, device="cpu")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    view = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    return np.array_equal(a.view(view[a.dtype.itemsize]),
                          b.view(view[b.dtype.itemsize]))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    tk = _tkey(seed)
    assert _bits_equal(jk, interop.key_to_numpy(tk))
    for num in (2, 3, (2, 3)):
        assert _bits_equal(jax.jit(lambda k: jax.random.split(k, num))(jk),
                           interop.key_to_numpy(tr.split(tk, num)))
    for data in (0, 7, 2**31 + 5):
        assert _bits_equal(jax.jit(jax.random.fold_in)(jk, np.uint32(data)),
                           interop.key_to_numpy(tr.fold_in(tk, data)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), _tkey(seed)
    jb = jax.jit(lambda k: jax.random.bits(k, (N,), jnp.uint32))(jk)
    assert _bits_equal(jb, tr.bits(tk, (N,)).numpy().astype(np.uint32))
    assert _bits_equal(jax.jit(lambda k: jax.random.uniform(k, (N,)))(jk),
                       tr.uniform(tk, (N,)).numpy())
    ju = jax.jit(lambda k: jax.random.uniform(
        k, (64, 100), jnp.float32, -5.12, 5.12))(jk)
    assert _bits_equal(ju, tr.uniform(tk, (64, 100), minval=-5.12,
                                      maxval=5.12).numpy())
    for p in (0.05, 0.3, 0.9):
        jm = jax.jit(lambda k: jax.random.bernoulli(k, p, (N,)))(jk)
        assert np.array_equal(np.asarray(jm),
                              tr.bernoulli(tk, p, (N,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), _tkey(seed)
    for lo, hi in ((0, 10), (1, 101), (-50, 50), (0, 1_000_003), (3, 3)):
        ji = jax.jit(lambda k: jax.random.randint(k, (N,), lo, hi))(jk)
        assert np.array_equal(np.asarray(ji),
                              tr.randint(tk, (N,), lo, hi).numpy()), (lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulp_bound(seed):
    jn = np.asarray(jax.jit(lambda k: jax.random.normal(k, (N,)))(
        jax.random.PRNGKey(seed)))
    tn = tr.normal(_tkey(seed), (N,)).numpy()
    ulps = np.abs(jn.view(np.int32).astype(np.int64)
                  - tn.view(np.int32).astype(np.int64))
    assert ulps.max() <= ULP_BOUND


def _battery(rng, n=40_000):
    x = np.concatenate([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n // 4) ** 7,
                        [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 0.999999]])
    x = x.astype(np.float32)
    return x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]


@pytest.mark.parametrize("name,jf,tf,scale", [
    ("log1p", jnp.log1p, xm.log1p, -1.0),
    ("log1p_pos", jnp.log1p, xm.log1p, 3.0),
    ("log", jnp.log, xm.log, 100.0),
    ("expm1", jnp.expm1, xm.expm1, 6.0),
    ("exp", jnp.exp, xm.exp, 20.0),
    ("erf_inv", lax.erf_inv, xm.erf_inv, 1.0),
])
def test_xla_math_bitwise(name, jf, tf, scale):
    x = _battery(np.random.default_rng(7)) * np.float32(scale)
    if name in ("log1p", "log"):
        x = -np.abs(x) if name == "log1p" else np.abs(x)
    x = x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]
    j = np.asarray(jax.jit(jf)(x))
    t = tf(torch.from_numpy(x.copy())).numpy()
    same = (j.view(np.uint32) == t.view(np.uint32)) | (np.isnan(j)
                                                       & np.isnan(t))
    assert same.all(), (name, x[~same][:5], j[~same][:5], t[~same][:5])


def test_fma_is_exactly_rounded():
    """The float64 round-to-odd emulation is a true FMA: exact where the
    float64 sum is exact (near-cancelling ``c``), and equal to XLA's own
    contracted ``x * y + z`` everywhere."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(100_000).astype(np.float32)
    b = rng.standard_normal(100_000).astype(np.float32)
    for c in ((-(a.astype(np.float64) * b)).astype(np.float32),
              rng.standard_normal(100_000).astype(np.float32)):
        got = xm.fma(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
        j = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
        assert np.array_equal(got.view(np.uint32), j.view(np.uint32))
    cancel = (-(a.astype(np.float64) * b)).astype(np.float32)
    ref = (a.astype(np.float64) * b + cancel).astype(np.float32)
    got = xm.fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(cancel)).numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("tournsize", [2, 3, 7])
def test_tournament_positions_bitwise(tournsize):
    """The position law equals the JAX package's at n = 1e6: the mismatch
    rate is 0 (torch's own log1p/expm1 would move ~1.4% by one rank)."""
    n, k = 1_000_000, 100_000
    key = jax.random.PRNGKey(tournsize)
    jp = np.asarray(jax.jit(lambda kk: jsel.tournament_positions(
        kk, n, k, tournsize))(key))
    tp = tsel.tournament_positions(interop.key_to_torch(key, device="cpu"),
                                   n, k, tournsize).numpy()

    diff = jp.astype(np.int64) - tp
    assert np.mean(diff != 0) <= 0.0
    assert np.abs(diff).max() <= 1
