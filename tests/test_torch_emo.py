"""deap_tpu_torch.ops.emo and ops.dominance against the JAX package.

On the CPU the port runs the plain version of K4
(``_rows_dominate_counts_plain``); it is held against the JAX package's
``_rows_dominate_counts`` and against the Pallas kernel
``rows_dominate_counts_pallas`` in interpret mode.  Counts, ranks,
``n_fronts`` and ``sel_nsga2`` indices are integers and must be equal;
the crowding distance must be bitwise (0 ulp).  Inputs are made with
numpy and cover ties, duplicated points and ``-inf`` rows, with
``front_chunk`` 8 and 32 so that fronts span several chunks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.ops import emo as jemo
from deap_tpu.ops.dominance_pallas import rows_dominate_counts_pallas
from deap_tpu_torch import base as tbase, kernels
from deap_tpu_torch.ops import dominance as tdom, emo as temo

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)


def _points(kind: str, n: int, m: int, seed: int) -> np.ndarray:
    """``normal``: continuous; ``ties``: small integers (many equal
    coordinates and duplicated points); both with a few duplicated rows
    and a few all-``-inf`` rows."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        w = rng.integers(0, 4, size=(n, m)).astype(np.float32)
    else:
        w = rng.normal(size=(n, m)).astype(np.float32)
    w[:6] = w[6:12]
    w[rng.random(n) < 0.08] = -np.inf
    return w


# the four input classes of the JAX package's kernel test: random rows,
# -inf sentinel rows, rows equal to columns (self-pairs), and shapes that
# are not multiples of the Pallas tiles
@pytest.mark.parametrize("case", ["random", "sentinel", "self", "ragged"])
def test_rows_dominate_counts_matches_jax_and_pallas(case):
    rng = np.random.default_rng(["random", "sentinel", "self",
                                 "ragged"].index(case) + 17)
    C, n, m = {"random": (16, 200, 3), "sentinel": (24, 150, 2),
               "self": (20, 120, 4), "ragged": (13, 1031, 3)}[case]
    rows = rng.normal(size=(C, m)).astype(np.float32)
    w = rng.normal(size=(n, m)).astype(np.float32)
    if case == "sentinel":
        rows[2:] = -np.inf
    if case == "self":
        w[:C] = rows
    want = np.asarray(jemo._rows_dominate_counts(jnp.asarray(rows),
                                                 jnp.asarray(w)))
    pallas = np.asarray(rows_dominate_counts_pallas(
        jnp.asarray(rows), jnp.asarray(w), interpret=True))
    kernels.reset_launches()
    got = tdom.rows_dominate_counts(torch.from_numpy(rows),
                                    torch.from_numpy(w))
    assert kernels.LAUNCHES["rows_dominate_counts"] == 0    # CPU: plain
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pallas, want)


def test_plain_counts_block_over_rows(monkeypatch):
    """The plain version's row blocking (which bounds its memory at
    C = n on the card) does not change the counts."""
    w = _points("ties", 300, 3, 5)
    want = tdom.rows_dominate_counts(torch.from_numpy(w), torch.from_numpy(w))
    monkeypatch.setattr(tdom, "_PLAIN_BLOCK", 7 * 300 * 3)
    got = tdom.rows_dominate_counts(torch.from_numpy(w), torch.from_numpy(w))
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_dominator_counts_match_jax(m, kind):
    w = _points(kind, 230, m, m)
    active = np.random.default_rng(m).random(230) < 0.8
    want = np.asarray(jemo._dominator_counts(jnp.asarray(w),
                                             jnp.asarray(active), chunk=64))
    got = temo._dominator_counts(torch.from_numpy(w),
                                 torch.from_numpy(active), chunk=64)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("front_chunk", [8, 32])
@pytest.mark.parametrize("stop_at_k", [None, 70])
def test_peel_ranks_and_fronts_match_jax(m, kind, front_chunk, stop_at_k):
    w = _points(kind, 210, m, 10 * m + front_chunk)
    want, nf = jax.jit(lambda x: jemo.nondominated_ranks(
        x, method="peel", front_chunk=front_chunk, stop_at_k=stop_at_k))(
        jnp.asarray(w))
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w), method="peel",
                                       front_chunk=front_chunk,
                                       stop_at_k=stop_at_k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert tnf == int(nf) > 1


@pytest.mark.parametrize("front_chunk", [8, 32])
def test_peel_subtracts_only_front_rows(monkeypatch, front_chunk):
    """Each round subtracts its front's rows and nothing else: no padded
    chunk, at most ``front_chunk`` rows a call, every ranked point once."""
    w = torch.from_numpy(_points("ties", 210, 3, 9))
    sizes = []

    def counted(rows, cols):
        sizes.append(rows.shape[0])
        return tdom.rows_dominate_counts(rows, cols)

    monkeypatch.setattr(temo, "rows_dominate_counts", counted)
    ranks, nf = temo.nondominated_ranks(w, method="peel",
                                        front_chunk=front_chunk)
    assert sum(sizes) == 210 and max(sizes) <= front_chunk
    fronts = torch.bincount(ranks.long(), minlength=nf)
    want = sum(-(-int(f) // front_chunk) for f in fronts)
    assert len(sizes) == want


def test_peel_valid_mask_matches_jax():
    w = _points("normal", 150, 3, 2)
    valid = np.random.default_rng(2).random(150) < 0.7
    want, nf = jemo.nondominated_ranks(jnp.asarray(w), jnp.asarray(valid),
                                       front_chunk=8, method="peel")
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w),
                                       torch.from_numpy(valid),
                                       front_chunk=8, method="peel")
    assert np.array_equal(got.numpy(), np.asarray(want)) and tnf == int(nf)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_crowding_distance_bitwise(m):
    rng = np.random.default_rng(30 + m)
    vals = rng.normal(size=(180, m)).astype(np.float32)
    vals[:10] = vals[10:20]                       # duplicates in a front
    vals[20:25, 0] = vals[25, 0]                  # ties on one objective
    ranks, _ = jemo.nondominated_ranks(jnp.asarray(-vals), method="peel",
                                       front_chunk=8, stop_at_k=120)
    want = np.asarray(jax.jit(jemo.assign_crowding_dist)(
        jnp.asarray(vals), ranks))
    got = temo.assign_crowding_dist(torch.from_numpy(vals),
                                    torch.from_numpy(np.array(ranks)))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.isinf(want).any() and np.isfinite(want).any()


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("k", [40, 100, 150])
def test_sel_nsga2_indices_equal(m, k):
    rng = np.random.default_rng(k + m)
    vals = rng.integers(0, 6, size=(200, m)).astype(np.float32) \
        + rng.normal(size=(200, m)).astype(np.float32) * (k % 3 == 0)
    valid = rng.random(200) < 0.9
    weights = (-1.0,) * m
    jf = jbase.Fitness(values=jnp.asarray(vals), valid=jnp.asarray(valid),
                       weights=weights)
    tf = tbase.Fitness(values=torch.from_numpy(vals),
                       valid=torch.from_numpy(valid), weights=weights)
    want = np.asarray(jax.jit(lambda f: jemo.sel_nsga2(
        None, f, k, nd="peel", front_chunk=8))(jf))
    got = temo.sel_nsga2(None, tf, k, nd="peel", front_chunk=8)
    assert np.array_equal(got.numpy(), want)


def test_standard_methods_are_not_ported():
    """``nd="standard"`` resolves to ``grid`` at three objectives and
    n >= 16384, and to ``staircase`` at two; once refused as not ported,
    both now resolve and run, as does every other method name (held
    against the JAX package in ``tests/test_torch_emo_methods.py``)."""
    w = torch.zeros((16384, 3))
    fit = tbase.Fitness(values=w, valid=torch.ones(16384, dtype=torch.bool),
                        weights=(-1.0,) * 3)
    idx = temo.sel_nsga2(None, fit, 100)       # equal rows: one front
    assert idx.shape == (100,) and len(set(idx.tolist())) == 100
    ranks, nf = temo.nondominated_ranks(torch.zeros((64, 2)))
    assert nf == 1 and not ranks.any()
    for method in ("grid", "densegrid", "sweep2d"):
        ranks, nf = temo.nondominated_ranks(torch.zeros((64, 2)),
                                            method=method)
        assert nf == 1 and not ranks.any()
    with pytest.raises(ValueError, match="2 objectives"):
        temo.nondominated_ranks(torch.zeros((64, 3)), method="staircase")
    with pytest.raises(ValueError, match="unknown method"):
        temo.nondominated_ranks(torch.zeros((64, 3)), method="fortin")
    assert not hasattr(temo, "MethodNotPorted")
    # below 16384 points, "auto" at three objectives is the peel itself
    small = torch.from_numpy(_points("normal", 100, 3, 1))
    assert torch.equal(temo.nondominated_ranks(small)[0],
                       temo.nondominated_ranks(small, method="peel")[0])
