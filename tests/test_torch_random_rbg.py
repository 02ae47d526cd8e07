"""deap_tpu_torch.random's ``rbg`` keys against jitted JAX on typed keys.

The JAX side is driven with typed keys (``jax.random.wrap_key_data(data,
impl="rbg")``), never by flipping ``jax_default_prng_impl``.  Keys,
splits and fold-ins are threefry on each half; bits are XLA's
``rng_bit_generator`` on the CPU (Philox-4x32-10).  Every sampler the
port uses is held bitwise (tolerance 0), on single keys, on ``(n, 4)``
key batches under ``jax.vmap`` (which draws every row from the first
key) and at the narrow widths jax asks ``rng_bit_generator`` for
(``uint8`` for bfloat16 normals, ``uint16``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu_torch import interop
from deap_tpu_torch import random as tr

torch.set_num_threads(1)

# raw key words: zeros, small words, high words, the carry of the
# counter's low 64 bits into its high half, and random words
KEYS = [[0, 0, 0, 0], [1, 2, 3, 4], [0xDEADBEEF, 0x12345678, 0xFFFFFFFF,
        0xFFFFFFFE], [5, 6, 0xFFFFFFFF, 0xFFFFFFFF],
        [0xFFFFFFFF] * 4, [0, 7, 0, 7]] + [
    list(np.random.default_rng(s).integers(0, 2**32, 4)) for s in range(3)]
N = 4096

# jax.random.bits(key, (n,)) on jax 0.9.0's CPU backend
GOLDEN = [
    ([0, 0, 0, 0], [1713891541, 3781805453, 3159862348, 2600524760]),
    ([1, 2, 3, 4], [512747620, 1298009047, 1267190206]),
    ([0xDEADBEEF, 0x12345678, 0xFFFFFFFF, 0xFFFFFFFE],
     [65559129, 1930409553, 648285888]),
]


# jitted once: a lambda jitted inside a test would compile on every call
_split = jax.jit(jax.random.split, static_argnums=1)
_fold_in = jax.jit(jax.random.fold_in)
_bits = jax.jit(jax.random.bits, static_argnums=(1, 2))
_uniform = jax.jit(jax.random.uniform, static_argnums=(1, 2, 3, 4))
_bernoulli = jax.jit(jax.random.bernoulli, static_argnums=(1, 2))
_randint = jax.jit(jax.random.randint, static_argnums=(1, 2, 3))
_normal = jax.jit(jax.random.normal, static_argnums=(1, 2))



def _vm(f):
    return jax.jit(jax.vmap(f))


_vm_bits = _vm(lambda k: jax.random.bits(k, (3, 7)))
_vm_uniform = _vm(lambda k: jax.random.uniform(k, (3, 7)))
_vm_normal = _vm(lambda k: jax.random.normal(k, (33,)))
_vm_normal_bf16 = _vm(lambda k: jax.random.normal(k, (33,), jnp.bfloat16))
_vm_bernoulli = _vm(lambda k: jax.random.bernoulli(k, 0.3, (9,)))
_vm_randint = _vm(lambda k: jax.random.randint(k, (4,), 0, 77))
_vm_vm_bits = jax.jit(jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (4,)))))


def _jkey(words):
    return jax.random.wrap_key_data(
        jnp.asarray(np.asarray(words, np.uint64).astype(np.uint32)),
        impl="rbg")


def _tkey(words):
    return interop.key_to_torch(np.asarray(words, np.uint64)
                                .astype(np.uint32), device="cpu")


def _data(jkeys):
    return np.asarray(jax.random.key_data(jkeys)).astype(np.int64)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    view = {1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
    return np.array_equal(a.view(view), b.view(view))


@pytest.mark.parametrize("words,want", GOLDEN)
def test_golden_words(words, want):
    got = tr.bits(_tkey(words), (len(want),)).tolist()
    assert got == want
    jb = np.asarray(_bits(_jkey(words), (len(want),), jnp.uint32))
    assert jb.tolist() == want


def test_prng_key_and_default_impl():
    assert tr.PRNGKey(0, impl="rbg", device="cpu").tolist() == [0, 0, 0, 0]
    assert tr.PRNGKey(-5, impl="rbg", device="cpu").tolist() == [
        0, 2**32 - 5] * 2
    assert tr.PRNGKey(7, device="cpu").tolist() == [0, 7]
    with tr.default_impl("rbg"):
        k = tr.PRNGKey(7, device="cpu")
        assert tr.impl_of(k) == "rbg"
        # other functions follow the key, never the default
        assert tr.split(tr.PRNGKey(7, impl="threefry2x32",
                                   device="cpu")).shape == (2, 2)
    assert tr.PRNGKey(7, device="cpu").shape == (2,)
    prev = jax.config.jax_default_prng_impl
    try:
        jax.config.update("jax_default_prng_impl", "rbg")
        assert _same_bits(jax.random.PRNGKey(7), k.numpy().astype(np.uint32))
    finally:
        jax.config.update("jax_default_prng_impl", prev)
    with pytest.raises(ValueError):
        tr.PRNGKey(0, impl="unsafe_rbg", device="cpu")
    with pytest.raises(ValueError):
        tr.impl_of(torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("words", KEYS)
def test_split_fold_in_bits_bitwise(words):
    jk, tk = _jkey(words), _tkey(words)
    for num in (2, 3, (2, 3)):
        want = _data(_split(jk, num))
        assert np.array_equal(want, tr.split(tk, num).numpy())
    for data in (0, 9, 2**31 + 5):
        want = _data(_fold_in(jk, np.uint32(data)))
        assert np.array_equal(want, tr.fold_in(tk, data).numpy())
    for shape in ((1,), (7,), (N + 3,), (5, 3)):
        jb = _bits(jk, shape, jnp.uint32)
        assert _same_bits(jb, tr.bits(tk, shape).numpy().astype(np.uint32))


@pytest.mark.parametrize("words", KEYS)
def test_samplers_bitwise(words):
    jk, tk = _jkey(words), _tkey(words)
    assert _same_bits(_uniform(jk, (N,), jnp.float32, 0.0, 1.0),
                      tr.uniform(tk, (N,)).numpy())
    ju = _uniform(jk, (64, 100), jnp.float32, -5.12, 5.12)
    assert _same_bits(ju, tr.uniform(tk, (64, 100), minval=-5.12,
                                      maxval=5.12).numpy())
    for p in (0.05, 0.5, 0.9):
        jm = _bernoulli(jk, p, (N,))
        assert np.array_equal(np.asarray(jm), tr.bernoulli(tk, p, (N,))
                              .numpy())
    for lo, hi in ((0, 10), (1, 101), (-50, 50), (0, 1_000_003), (3, 3),
                   (-2**31, 2**31 - 1)):
        ji = _randint(jk, (N,), lo, hi)
        assert np.array_equal(np.asarray(ji),
                              tr.randint(tk, (N,), lo, hi).numpy()), (lo, hi)
    jn = _normal(jk, (N,), jnp.float32)
    assert _same_bits(jn, tr.normal(tk, (N,)).numpy())
    jh = _normal(jk, (N,), jnp.bfloat16)
    th = tr.normal(tk, (N,), torch.bfloat16).view(torch.int16).numpy()
    assert _same_bits(np.asarray(jh).view(np.uint16), th)


@pytest.mark.parametrize("words", KEYS[:4])
@pytest.mark.parametrize("dtype,mask", [(jnp.uint8, 0xFF),
                                        (jnp.uint16, 0xFFFF)])
def test_narrow_widths_are_the_low_bits(words, dtype, mask):
    """XLA's rng_bit_generator at 8 and 16 bits gives the low bits of its
    32-bit words, position for position: the port's narrow draws (the
    bfloat16 uniform's byte) take them from :func:`bits`."""
    jk = _jkey(words)
    for shape in ((4,), (6,), (1000,), (3, 7, 5)):
        jn = np.asarray(_bits(jk, shape, dtype)).astype(np.int64)
        assert np.array_equal(jn, tr.bits(_tkey(words), shape).numpy()
                              & mask), shape


@pytest.mark.parametrize("words", KEYS[:3])
def test_key_batches_follow_vmap(words):
    """On an ``(n, 4)`` batch every sampler equals jax's ``vmap`` over the
    keys, which reads only the first key (``rng_bit_generator``'s
    batching rule); splits and fold-ins stay per key."""
    jk, tk = _jkey(words), _tkey(words)
    jks, tks = jax.random.split(jk, 5), tr.split(tk, 5)
    assert np.array_equal(_data(jks), tks.numpy())
    assert np.array_equal(
        _data(jax.vmap(lambda k: jax.random.split(k, 3))(jks)),
        tr.split(tks, 3).numpy())
    assert np.array_equal(
        _data(jax.vmap(lambda k: jax.random.fold_in(k, 11))(jks)),
        tr.fold_in(tks, 11).numpy())

    assert _same_bits(_vm_bits(jks), tr.bits(tks, (3, 7)).numpy()
                      .astype(np.uint32))
    assert np.array_equal(tr.bits(tks, (3, 7)).numpy(),
                          tr.bits(tks[0], (5, 3, 7)).numpy())
    assert _same_bits(_vm_uniform(jks), tr.uniform(tks, (3, 7)).numpy())
    assert _same_bits(_vm_normal(jks), tr.normal(tks, (33,)).numpy())
    assert _same_bits(np.asarray(_vm_normal_bf16(jks)).view(np.uint16),
                      tr.normal(tks, (33,), torch.bfloat16)
                      .view(torch.int16).numpy())
    assert np.array_equal(_vm_bernoulli(jks),
                          tr.bernoulli(tks, 0.3, (9,)).numpy())
    assert np.array_equal(_vm_randint(jks),
                          tr.randint(tks, (4,), 0, 77).numpy())
    # a 2-d batch: nested vmaps read the first key of the flattened batch
    nested = np.asarray(_vm_vm_bits(jax.random.split(jk, (2, 3))))
    assert _same_bits(nested, tr.bits(tr.split(tk, (2, 3)), (4,)).numpy()
                      .astype(np.uint32))


def test_mulhilo_near_two_to_the_32():
    """The 32 x 32-bit products wrap int64's sign and keep their bits."""
    words = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
                      0xD2511F53, 0xCD9E8D57], dtype=np.int64)
    for m in tr._PHILOX_M:
        hi, lo = tr._mulhilo(torch.from_numpy(words), m)
        for w, h, lo_ in zip(words.tolist(), hi.tolist(), lo.tolist()):
            assert (h, lo_) == ((w * m) >> 32, (w * m) & 0xFFFFFFFF)


def test_interop_carries_rbg_keys_both_ways():
    jks = jax.random.split(_jkey([1, 2, 3, 4]), (2, 3))
    data = np.asarray(jax.random.key_data(jks))
    tks = interop.key_to_torch(data, device="cpu")
    assert tks.shape == (2, 3, 4) and tks.dtype == torch.int64
    back = interop.key_to_numpy(tks)
    assert back.dtype == np.uint32 and np.array_equal(back, data)
    rewrapped = jax.random.wrap_key_data(back, impl="rbg")
    assert np.array_equal(np.asarray(jax.random.key_data(rewrapped)), data)
    # a single threefry key keeps its (2,) shape; other widths refuse
    assert interop.key_to_torch(np.asarray(jax.random.PRNGKey(3)),
                                device="cpu").shape == (2,)
    with pytest.raises(ValueError):
        interop.key_to_torch(np.zeros(3, np.uint32), device="cpu")
    with pytest.raises(TypeError):
        interop.key_to_torch(jks, device="cpu")
