"""deap_tpu_torch.ops.generation against the JAX package's megakernel.

The plain versions of the two CUDA kernels run here on the CPU:

* K1's plain version ``_vary_tile_plain`` (through ``megakernel_vary``)
  against ``_megakernel_xla_exec``, the JAX package's traced form of the
  same tile function, for float32, bfloat16 and int8 storage;
* K2's plain version ``_gather_vary_plain`` against ``_megakernel_dma``
  in Pallas interpret mode, fed the same ``order``/``pos``/seed/knobs.

The crossover swap set, the mutation mask, the winner indices and the
untouched genes are checked bitwise on their own; the mutated genes are
held to ``MUTATED_ABS_BOUND``.  That bound is 0: the port reproduces
XLA's float32 ``erf_inv`` and its FMA contractions, so the whole output is
bitwise.  The hash, the seed word and the cut points are pinned bitwise
too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import generation_pallas as gp
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import base as tbase, interop, kernels
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import generation as tg
from deap_tpu_torch.ops import selection as tsel

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

POP, DIM = 512, 100
MUTATED_ABS_BOUND = 0.0
KNOBS = np.array([0.9, 0.5, 0.0, 0.3, 0.05], np.float32)
STORAGES = [("float32", 0.0), ("bfloat16", 0.0), ("int8", 5.12)]


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(0).uniform(
        -5.12, 5.12, (POP, DIM)).astype(np.float32)


def _storages(dtype, bound):
    js = gp.GenomeStorage(dtype, bound)
    return js, interop.storage_to_torch(js)


def _masks(seed, knobs, n, dim, row_base0=0):
    """The port's swap and mutation masks, from the integer hash alone."""
    useed = torch.tensor(int(np.uint32(np.int32(seed).view(np.uint32))))
    r = torch.arange(n)
    lanes = torch.arange(dim)
    u_pair = tg._uniform_at(useed, 1, ((r & ~16) + row_base0)[:, None],
                            torch.arange(3)[None])
    lo, hi = tg._cut_points(u_pair[:, 1:2], u_pair[:, 2:3], dim)
    kn = torch.from_numpy(knobs)
    swap = (u_pair[:, 0:1] < kn[0]) & (lanes >= lo) & (lanes < hi)
    rows = r + row_base0
    gate = tg._uniform_at(useed, 2, rows, 0) < kn[1]
    gene = tg._uniform_at(useed, 3, rows[:, None], lanes[None]) < kn[4]
    return swap.numpy(), (gate[:, None] & gene).numpy()


def _compare(jout, tout, js, ts, parents_f32, seed, knobs, row_base0=0):
    """Swap set and untouched genes bitwise, the mutation mask bitwise
    (no gene outside it moves), mutated genes within MUTATED_ABS_BOUND.
    Both outputs are widened to float32 by their own package."""
    j = np.asarray(js.to_compute(jout))
    t = ts.to_compute(tout).numpy()
    n, dim = t.shape
    swap, mut = _masks(seed, knobs, n, dim, row_base0)
    crossed = np.where(swap, parents_f32[np.arange(n) ^ 16], parents_f32)
    crossed = np.asarray(js.to_compute(js.to_storage(jnp.asarray(crossed))))
    assert np.array_equal(j[~mut].view(np.uint32), crossed[~mut].view(np.uint32))
    assert np.array_equal(t[~mut].view(np.uint32), crossed[~mut].view(np.uint32))
    if mut.any():
        assert np.abs(j[mut] - t[mut]).max() <= MUTATED_ABS_BOUND


def test_mix32_and_uniform_tile_bitwise():
    x = np.random.default_rng(1).integers(0, 2**32, 50_000, dtype=np.uint64)
    j = np.asarray(jax.jit(gp._mix32)(jnp.asarray(x.astype(np.uint32))))
    t = tg._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(j, t.astype(np.uint32))
    for seed in (0, 12345, 2**32 - 7):
        for draw in (1, 2, 3):
            for row_base in (0, 2**31 + 32):
                ju = np.asarray(jax.jit(
                    lambda s: gp._uniform_tile(s, draw, (64, 128),
                                               jnp.uint32(row_base)))(
                    jnp.uint32(seed)))
                tu = tg._uniform_tile(torch.tensor(seed), draw, (64, 128),
                                      row_base).numpy()
                assert np.array_equal(ju.view(np.uint32), tu.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 42, -3, 2**31 - 1])
def test_seed_from_key_bitwise(seed):
    for k in jax.random.split(jax.random.PRNGKey(seed), 4):
        js = np.asarray(gp._seed_from_key(k))
        ts = tg._seed_from_key(interop.key_to_torch(k, device="cpu")).numpy()
        assert js.dtype == ts.dtype == np.int32 and js == ts


def test_cut_points_bitwise(genome):
    """cxpb=1, mutpb=0: the JAX output's swapped columns are exactly the
    port's [lo, hi) cut ranges, row by row."""
    knobs = np.array([1.0, 0.0, 0.0, 0.3, 0.05], np.float32)
    seed = np.int32(99)
    ident = np.broadcast_to(np.arange(POP, dtype=np.float32)[:, None],
                            (POP, DIM)).copy()
    jo = np.asarray(gp._megakernel_xla_exec(
        jnp.asarray(ident), jnp.asarray(seed), jnp.asarray(knobs), dim=DIM,
        rows=128, storage_dtype="float32", scale=1.0))
    swap, _ = _masks(seed, knobs, POP, DIM)
    assert np.array_equal(jo != ident, swap)
    assert swap.any(axis=1).all()


@pytest.mark.parametrize("dtype,bound", STORAGES)
def test_vary_plain_matches_xla_exec(genome, dtype, bound):
    """K1's plain version against _megakernel_xla_exec."""
    js, ts = _storages(dtype, bound)
    jg = js.to_storage(jnp.asarray(genome))
    seed = np.int32(-123456789)
    for row_base0 in (0, 1024):
        jo = gp._megakernel_xla_exec(jg, jnp.asarray(seed),
                                     jnp.asarray(KNOBS), row_base0,
                                     dim=DIM, rows=128, storage_dtype=dtype,
                                     scale=js.scale)
        before = dict(kernels.LAUNCHES)
        tg_in = interop.genome_to_torch(np.asarray(jg), device="cpu")
        to = tg.megakernel_vary(tg_in, torch.tensor(seed),
                                torch.from_numpy(KNOBS),
                                dim=DIM, storage=ts, row_base0=row_base0)
        assert kernels.LAUNCHES == before      # CPU tensors: plain version
        assert to.dtype == ts.torch_dtype
        parents = np.asarray(js.to_compute(jg))
        _compare(jo, to, js, ts, parents, seed, KNOBS, row_base0)


@pytest.mark.parametrize("dtype,bound", STORAGES)
def test_gather_vary_plain_matches_dma_interpret(genome, dtype, bound):
    """K2's plain version against _megakernel_dma(interpret=True) fed the
    same order, positions, seed and knobs."""
    js, ts = _storages(dtype, bound)
    rng = np.random.default_rng(5)
    order = rng.permutation(POP).astype(np.int32)
    pos = rng.integers(0, POP, POP).astype(np.int32)
    seed = np.int32(77)
    jg = js.to_storage(jnp.asarray(genome))
    jpad = jnp.zeros((POP, gp.pad_dim(DIM)), jg.dtype).at[:, :DIM].set(jg)
    jo, jw = gp._megakernel_dma(
        jnp.asarray(order), jnp.asarray(pos), jnp.asarray(seed),
        jnp.asarray(KNOBS), jpad, dim=DIM, tournsize=3, rows=128,
        window=16, storage_dtype=dtype, scale=js.scale, hw_rng=False,
        interpret=True)
    to, tw = tg._gather_vary_plain(
        torch.from_numpy(order), torch.from_numpy(pos),
        interop.genome_to_torch(np.asarray(jg), device="cpu"),
        torch.tensor(seed), torch.from_numpy(KNOBS), DIM, ts)
    assert np.array_equal(np.asarray(jw)[:, 0], tw.numpy())
    assert np.array_equal(tw.numpy(), order[pos])
    parents = np.asarray(js.to_compute(jg))[order[pos]]
    _compare(jo[:, :DIM], to, js, ts, parents, seed, KNOBS)


@pytest.mark.parametrize("gather", ["dma", "host"])
def test_fused_generation_matches_jax(genome, gather):
    """The whole generation: sort, positions, gather and variation."""
    key = jax.random.PRNGKey(11)
    k_sel, k_var = jax.random.split(key)
    vals = np.sum(genome ** 2, axis=1, keepdims=True)
    w = -vals
    w[::7] = -np.inf                                       # invalid rows
    jg, jw = gp.fused_generation(k_sel, k_var, jnp.asarray(genome),
                                 jnp.asarray(w), dim=DIM, cxpb=0.9,
                                 mutpb=0.5, gather="host", vary_exec="xla")
    tgen, tw = tg.fused_generation(
        interop.key_to_torch(k_sel, device="cpu"),
        interop.key_to_torch(k_var, device="cpu"),
        torch.from_numpy(genome), torch.from_numpy(w), dim=DIM, cxpb=0.9,
        mutpb=0.5, gather=gather)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(jg).view(np.uint32),
                          tgen.numpy().view(np.uint32))
    ref = jsel.sel_tournament(k_sel, jnp.asarray(w), POP, 3,
                              tie_break="rank")
    assert np.array_equal(np.asarray(ref), tw.numpy())


def test_fused_generation_live_prefix_matches_jax(genome):
    key = jax.random.PRNGKey(3)
    k_sel, k_var = jax.random.split(key)
    w = -np.sum(genome ** 2, axis=1, keepdims=True)
    live_n = POP - 100
    jg, jw = gp.fused_generation(k_sel, k_var, jnp.asarray(genome),
                                 jnp.asarray(w), dim=DIM, cxpb=0.9,
                                 mutpb=0.5, gather="host", vary_exec="xla",
                                 live_n=live_n)
    tgen, tw = tg.fused_generation(
        interop.key_to_torch(k_sel, device="cpu"),
        interop.key_to_torch(k_var, device="cpu"),
        torch.from_numpy(genome), torch.from_numpy(w), dim=DIM, cxpb=0.9,
        mutpb=0.5, gather="host", live_n=torch.tensor(live_n))
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert (tw.numpy() < live_n).all()
    assert np.array_equal(np.asarray(jg).view(np.uint32),
                          tgen.numpy().view(np.uint32))
    assert np.array_equal(tgen.numpy()[live_n:], genome[live_n:])


def test_generation_validation(genome):
    k = tr.PRNGKey(0, device="cpu")
    g = torch.from_numpy(genome)
    w = torch.zeros(POP, 1)
    kw = dict(dim=DIM, cxpb=0.9, mutpb=0.5)
    with pytest.raises(tg.HardwareRngUnavailable):
        tg.fused_generation(k, k, g, w, hw_rng=True, **kw)
    with pytest.raises(ValueError, match="gather"):
        tg.fused_generation(k, k, g, w, gather="smem", **kw)
    with pytest.raises(ValueError, match="live"):
        tg.fused_generation(k, k, g, w, gather="dma", live_n=3, **kw)
    with pytest.raises(ValueError, match="rows"):
        tg.fused_generation(k, k, g, w, rows=48, **kw)
    with pytest.raises(ValueError, match="dim"):
        tg.fused_generation(k, k, g[:, :50], w, **kw)
    with pytest.raises(ValueError, match="storage"):
        tg.fused_generation(k, k, g.to(torch.bfloat16), w, **kw)
    with pytest.raises(ValueError, match="n % 32"):
        tg._vary_tile_plain(g[:40], torch.tensor(1), torch.from_numpy(KNOBS),
                            DIM)
    with pytest.raises(ValueError):
        tg.GenomeStorage("float16")
    with pytest.raises(ValueError, match="bound"):
        tg.GenomeStorage("int8")


def test_int8_scale_one_roundtrips_integers_exactly():
    st = tg.GenomeStorage("int8", 127.0)
    x = torch.arange(-127, 128, dtype=torch.float32)
    assert torch.equal(st.to_compute(st.to_storage(x)), x)


def test_megakernel_params_checks_operators():
    tb = tbase.Toolbox()
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_gaussian, mu=0.0, sigma=0.2, indpb=0.1)
    tb.register("select", tsel.sel_tournament, tournsize=4, tie_break="rank")
    assert tg.megakernel_params(tb) == {"mut_mu": 0.0, "mut_sigma": 0.2,
                                        "indpb": 0.1, "tournsize": 4}
    tb.register("select", tsel.sel_tournament, tournsize=4)
    with pytest.raises(ValueError, match="tie_break"):
        tg.megakernel_params(tb)
    tb.register("select", tsel.sel_random)
    with pytest.raises(ValueError, match="sel_tournament"):
        tg.megakernel_params(tb)
    tb.register("mutate", tmut.mut_gaussian, 0.0, 0.2, 0.1)
    with pytest.raises(ValueError, match="positional"):
        tg.megakernel_variation_params(tb)


def test_xla_engine_operators_match_jax(genome):
    """The default engine's batched operators: cut points, masks and
    untouched genes bitwise against the JAX package; mutated genes carry
    XLA's own association of sigma * sqrt(2) and stay within 1e-5."""
    key = jax.random.PRNGKey(21)
    A, B = jnp.asarray(genome[:256]), jnp.asarray(genome[256:])
    ja, jb = jcx.cx_two_point.batched(key, A, B)
    ta, tb_ = tcx.cx_two_point.batched(interop.key_to_torch(key, device="cpu"),
                                       torch.from_numpy(genome[:256]),
                                       torch.from_numpy(genome[256:]))
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jb), tb_.numpy())
    jm = np.asarray(jmut.mut_gaussian(key, jnp.asarray(genome), 0.0, 0.3,
                                      0.05))
    tm = tmut.mut_gaussian(interop.key_to_torch(key, device="cpu"),
                           torch.from_numpy(genome), 0.0, 0.3, 0.05).numpy()
    moved_j, moved_t = jm != genome, tm != genome
    assert np.array_equal(moved_j, moved_t)
    assert np.array_equal(jm[~moved_j], tm[~moved_t])
    assert np.abs(jm - tm).max() <= 1e-5
    w = jnp.asarray(-np.sum(genome ** 2, axis=1, keepdims=True))
    for tie in ("rank", "random"):
        ji = jsel.sel_tournament(key, w, POP, 3, tie_break=tie)
        ti = tsel.sel_tournament(interop.key_to_torch(key, device="cpu"),
                                 torch.from_numpy(np.asarray(w)), POP, 3,
                                 tie_break=tie)
        assert np.array_equal(np.asarray(ji), ti.numpy())
    ties = jnp.asarray(np.round(np.asarray(w) / 50.0) * 50.0)
    assert np.array_equal(
        np.asarray(jbase.lex_sort_indices(ties)),
        tbase.lex_sort_indices(torch.from_numpy(np.asarray(ties))).numpy())
    assert np.array_equal(
        np.asarray(jsel.sel_best(key, ties, 10)),
        tsel.sel_best(None, torch.from_numpy(np.asarray(ties)), 10).numpy())
    assert np.array_equal(
        np.asarray(jsel.sel_random(key, ties, 64)),
        tsel.sel_random(interop.key_to_torch(key, device="cpu"),
                        torch.from_numpy(np.asarray(ties)), 64).numpy())

