"""``_xla_math.pow``, bounded SBX and polynomial bounded mutation of
deap_tpu_torch against the jitted JAX functions.

XLA's CPU backend computes a float32 power by the C library's ``powf``
with subnormals flushed; ``_xla_math.pow`` repeats it (glibc's algorithm
with its fused multiply-adds emulated exactly) and must equal
``jax.jit(lambda v: v ** e)`` on every input: the mismatch count is 0.
The polynomial mutation must be bitwise (0 ulp) against the *jitted* JAX
operator — batched and per row, scalar and per-gene bounds, values at
the bounds, ``low == up`` — and so must SBX and the mutation together
through the jitted ``vary_genome``, the form every loop runs.  SBX
jitted on its own is another program to XLA: it contracts ``2 - rand *
alpha`` into a fused multiply-add there and not inside ``vary_genome``
(where the product has a second use).  The port follows ``vary_genome``;
against the operator jitted alone the stated bound is ``SBX_ALONE_ATOL``
(1e-6 of the widest span; the one-ulp change is amplified by the
cancellation in ``x1 + x2 - beta_q * diff``, measured up to 27 ulp) on
at most ``SBX_ALONE_RATE`` of the genes (measured 0.35%).  Inputs are
made with numpy from a seed.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import algorithms as jalg, base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu_torch import _xla_math as xm, algorithms as talg
from deap_tpu_torch import base as tbase, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

ETA = 20.0
SBX_ALONE_RATE = 0.01
SBX_ALONE_ATOL = 1e-6


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _close_at_rate(got, want, span=1.0):
    """SBX against the operator jitted alone: within ``SBX_ALONE_ATOL``
    of the span, different on at most ``SBX_ALONE_RATE`` of the genes."""
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want).max() <= SBX_ALONE_ATOL * span
            and (_bits(got) != _bits(want)).mean() <= SBX_ALONE_RATE)


def _pow_inputs(seed: int, scale: int = 1) -> np.ndarray:
    """3.2e5 float32 bases (times ``scale``): the operators' range,
    values next to 1 and next to 0, random bit patterns (negative,
    subnormal, huge, NaN) and the special values."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 1e-45, 1e-40,
                        1.1754942e-38, 1.1754944e-38, 3e38, np.inf, -np.inf,
                        np.nan, -2.5, 1.0000001, 0.99999994, -1e-40],
                       np.float32)
    bits = rng.integers(0, 2 ** 32, 60_000 * scale, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return np.concatenate([
        rng.uniform(0.001, 2, 200_000 * scale).astype(np.float32), special,
        bits,
        np.float32(1) + rng.uniform(0, 1e-4, 30_000 * scale).astype(
            np.float32),
        rng.uniform(0, 1e-30, 30_000 * scale).astype(np.float32)])


def _pow_mismatches(e: float, x: np.ndarray) -> np.ndarray:
    want = np.asarray(jax.jit(lambda v: v ** e)(jnp.asarray(x)))
    got = xm.pow(torch.from_numpy(x), e).numpy()
    return (_bits(got) != _bits(want)) & ~(np.isnan(got) & np.isnan(want))


@pytest.mark.parametrize("e", [ETA + 1.0, -(ETA + 1.0), 1.0 / (ETA + 1.0),
                               2.5, 7.0, -0.3],
                         ids=["21", "-21", "1/21", "2.5", "7", "-0.3"])
def test_pow_equals_jitted_xla_pow(e):
    x = _pow_inputs(int(abs(e) * 10))
    mismatch = _pow_mismatches(e, x)
    assert len(x) >= 300_000
    assert int(mismatch.sum()) == 0, x[mismatch][:5]


def test_pow_refuses_the_exponents_xla_rewrites():
    x = torch.ones(4)
    for e in (0.0, 1.0, 2.0, 3.0, 0.5, -1.0, float("inf")):
        with pytest.raises(ValueError, match="exponent"):
            xm.pow(x, e)


def test_fma64_is_correctly_rounded():
    rng = np.random.default_rng(5)
    a = rng.normal(size=2000) * 10.0 ** rng.integers(-8, 8, 2000)
    b = rng.normal(size=2000) * 10.0 ** rng.integers(-8, 8, 2000)
    c = -a * b * (1 + rng.normal(size=2000) * 1e-9)     # heavy cancellation
    c[::3] = rng.normal(size=len(c[::3]))
    got = xm.fma64(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        assert g == float(exact)          # Fraction -> float rounds once
    # Python-float operands
    assert float(xm.fma64(torch.tensor([3.0], dtype=torch.float64), 2.0,
                          1e-30)) == float(Fraction(6) + Fraction(1e-30))


def _parents(n, d, seed):
    """Parents in [0, 1] with the hard cases in fixed rows: equal
    parents, genes at both bounds, coarse values (ties), parents closer
    than the 1e-14 guard can see in float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, d)).astype(np.float32)
    b = rng.uniform(0, 1, (n, d)).astype(np.float32)
    b[:8] = a[:8]
    a[8:16, :3] = 0.0
    b[16:24, d // 2:] = 1.0
    a[24:32] = np.round(a[24:32], 1)
    b[24:32] = np.round(b[24:32], 1)
    b[32:40] = np.nextafter(a[32:40], np.float32(2))
    return a, np.clip(b, 0, 1).astype(np.float32)


@pytest.mark.parametrize("bounds", ["scalar", "per-gene"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sbx_batched_against_operator_jitted_alone(bounds, seed):
    n, d = 400, 12
    a, b = _parents(n, d, seed)
    if bounds == "scalar":
        low, up = 0.0, 1.0
        jlow, jup = low, up
    else:
        low = np.linspace(-1, 0, d).astype(np.float32)
        up = np.linspace(1, 3, d).astype(np.float32)
        a = np.clip(low + (up - low) * a, low, up).astype(np.float32)
        b = np.clip(low + (up - low) * b, low, up).astype(np.float32)
        jlow, jup = jnp.asarray(low), jnp.asarray(up)
    key = jax.random.PRNGKey(seed + 10)
    w1, w2 = jax.jit(lambda k, x, y: jcx.cx_simulated_binary_bounded(
        k, x, y, eta=ETA, low=jlow, up=jup))(key, jnp.asarray(a),
                                              jnp.asarray(b))
    g1, g2 = tcx.cx_simulated_binary_bounded(
        interop.key_to_torch(key, device="cpu"), torch.from_numpy(a),
        torch.from_numpy(b), eta=ETA, low=low, up=up)
    span = float(np.max(np.asarray(up) - np.asarray(low)))
    assert _close_at_rate(g1.numpy(), w1, span)
    assert _close_at_rate(g2.numpy(), w2, span)
    changed = np.asarray(w1) != a
    assert 0.3 < changed[40:].mean() < 0.7         # about half the genes
    assert not changed[:8].any()                   # equal parents: untouched


@pytest.mark.parametrize("seed", [0, 1])
def test_sbx_per_row_against_operator_jitted_alone(seed):
    """One pair and one key, as ``jax.vmap`` over per-row keys calls it."""
    a, b = _parents(64, 12, seed + 2)
    keys = jax.random.split(jax.random.PRNGKey(seed), 64)
    w1, w2 = jax.jit(jax.vmap(lambda k, x, y: jcx.cx_simulated_binary_bounded(
        k, x, y, eta=ETA, low=0.0, up=1.0)))(keys, jnp.asarray(a),
                                             jnp.asarray(b))
    for i in (0, 9, 17, 25, 33, 50):
        g1, g2 = tcx.cx_simulated_binary_bounded(
            interop.key_to_torch(keys[i], device="cpu"),
            torch.from_numpy(a[i]), torch.from_numpy(b[i]), eta=ETA, low=0.0,
            up=1.0)
        assert np.abs(g1.numpy() - np.asarray(w1[i])).max() <= SBX_ALONE_ATOL
        assert np.abs(g2.numpy() - np.asarray(w2[i])).max() <= SBX_ALONE_ATOL


@pytest.mark.parametrize("bounds", ["scalar", "per-gene", "low==up"])
@pytest.mark.parametrize("seed", [0, 1])
def test_polynomial_mutation_batched_bitwise(bounds, seed):
    n, d = 400, 12
    a, _ = _parents(n, d, seed + 4)
    if bounds == "scalar":
        low, up = 0.0, 1.0
        jlow, jup = low, up
    else:
        low = np.linspace(-1, 0, d).astype(np.float32)
        up = np.linspace(1, 3, d).astype(np.float32)
        if bounds == "low==up":
            up[::4] = low[::4]                     # span guarded to 1
        a = np.clip(low + (up - low) * a, low, up).astype(np.float32)
        jlow, jup = jnp.asarray(low), jnp.asarray(up)
    key = jax.random.PRNGKey(seed + 20)
    want = np.asarray(jax.jit(lambda k, x: jmut.mut_polynomial_bounded(
        k, x, eta=ETA, low=jlow, up=jup, indpb=0.5))(key, jnp.asarray(a)))
    got = tmut.mut_polynomial_bounded(
        interop.key_to_torch(key, device="cpu"), torch.from_numpy(a),
        eta=ETA, low=low, up=up, indpb=0.5).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert 0.3 < (want != a).mean() < 0.6
    assert (got >= low).all() and (got <= up).all()


def test_polynomial_mutation_per_row_bitwise():
    a, _ = _parents(64, 30, 9)
    keys = jax.random.split(jax.random.PRNGKey(4), 64)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, x: jmut.mut_polynomial_bounded(
            k, x, eta=ETA, low=0.0, up=1.0, indpb=1.0 / 30)))(
        keys, jnp.asarray(a)))
    for i in (0, 9, 17, 25, 63):
        got = tmut.mut_polynomial_bounded(
            interop.key_to_torch(keys[i], device="cpu"),
            torch.from_numpy(a[i]), eta=ETA, low=0.0, up=1.0,
            indpb=1.0 / 30)
        assert np.array_equal(_bits(got.numpy()), _bits(want[i]))


@pytest.mark.parametrize("ndim", [12, 30])
@pytest.mark.parametrize("n", [256, 131])
def test_vary_genome_halves_bitwise(ndim, n):
    """The published variation step: ``vary_genome(cxpb 0.9, mutpb 1.0,
    pairing="halves")`` over SBX and the polynomial mutation, both
    through their batched forms; an odd population keeps its last row
    out of the mating."""
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    for tb, cx, mut in ((jtb, jcx, jmut), (ttb, tcx, tmut)):
        tb.register("mate", cx.cx_simulated_binary_bounded, low=0.0, up=1.0,
                    eta=ETA)
        tb.register("mutate", mut.mut_polynomial_bounded, low=0.0, up=1.0,
                    eta=ETA, indpb=1.0 / ndim)
    g = np.random.default_rng(n + ndim).uniform(0, 1, (n, ndim)).astype(
        np.float32)
    key = jax.random.PRNGKey(n)
    want, wt = jax.jit(lambda k, x: jalg.vary_genome(
        k, x, jtb, 0.9, 1.0, pairing="halves"))(key, jnp.asarray(g))
    got, gt = talg.vary_genome(interop.key_to_torch(key, device="cpu"),
                               torch.from_numpy(g), ttb, 0.9, 1.0,
                               pairing="halves")
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert np.array_equal(gt.numpy(), np.asarray(wt))
    assert (np.asarray(want) != g).any(1).mean() > 0.9


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sbx_poly.py
    # [scale]: the mismatch count of _xla_math.pow against jax.jit pow on
    # scale * 3.2e5 inputs per exponent (the suite runs scale 1)
    import sys
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    for e in (ETA + 1.0, -(ETA + 1.0), 1.0 / (ETA + 1.0)):
        x = _pow_inputs(int(abs(e) * 10) + 1, scale)
        print(f"exponent {e!r}: {int(_pow_mismatches(e, x).sum())} "
              f"mismatches on {len(x)} inputs")
