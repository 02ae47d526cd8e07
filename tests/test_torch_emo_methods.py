"""Every method of ``deap_tpu_torch.ops.emo.nondominated_ranks`` against
the jitted JAX ``nondominated_ranks``.

Ranks and ``n_fronts`` are integers and must be equal, with and without
``stop_at_k``, for ``peel``, ``grid``, ``densegrid``, ``staircase``,
``sweep2d`` and ``auto``, on continuous, discrete, heavily duplicated,
part-invalid (``-inf`` rows), chain-like and mixed inputs at 2, 3 and 5
objectives.  Inputs are made with numpy from a seed; ``front_chunk`` is
16 so that fronts span several chunks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase
from deap_tpu.ops import emo as jemo
from deap_tpu_torch import base as tbase
from deap_tpu_torch.ops import emo as temo

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

N = 150
KINDS = ("continuous", "discrete", "duplicated", "invalid", "chain", "mixed")
# densegrid's value-rank histogram has (2^24)^(1/m) cells per axis: at
# five objectives XLA's CPU compiler takes minutes over it, so the JAX
# side is asked for it at two and three objectives only
CASES = [(2, "auto"), (2, "staircase"), (2, "sweep2d"), (2, "peel"),
         (2, "grid"), (2, "densegrid"), (3, "auto"), (3, "peel"),
         (3, "grid"), (3, "densegrid"), (5, "peel"), (5, "grid")]


def _points(kind: str, n: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(KINDS.index(kind) * 10 + m)
    w = rng.normal(size=(n, m)).astype(np.float32)
    if kind == "discrete":
        w = rng.integers(0, 4, (n, m)).astype(np.float32)
    elif kind == "duplicated":
        w[n // 2:] = w[:n - n // 2]
        w[::7] = w[0]
    elif kind == "invalid":
        w[::5] = -np.inf
    elif kind == "chain":                   # one point a front, shuffled
        w = np.repeat(np.arange(n, dtype=np.float32)[:, None], m, 1)
        w = w[rng.permutation(n)]
    elif kind == "mixed":                   # one discrete axis: ties on it
        w[:, 0] = np.round(w[:, 0])
        w[:, -1] = np.where(rng.random(n) < 0.3, w[0, -1], w[:, -1])
    return w


@pytest.mark.parametrize("stop_at_k", [None, N // 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,method", CASES)
def test_method_ranks_equal_jax(m, method, kind, stop_at_k):
    w = _points(kind, N, m)
    want, nf = jemo._jit_ranks(jnp.asarray(w), method=method,
                               stop_at_k=stop_at_k, front_chunk=16)
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w), method=method,
                                       stop_at_k=stop_at_k, front_chunk=16)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tnf) == int(nf)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [2, 3, 5])
def test_all_methods_give_one_partition(m, kind):
    w = torch.from_numpy(_points(kind, 97, m))
    methods = ["peel", "grid", "densegrid", "auto"]
    if m == 2:
        methods += ["staircase", "sweep2d"]
    ranks = [temo.nondominated_ranks(w, method=me, front_chunk=8)
             for me in methods]
    for r, nf in ranks[1:]:
        assert torch.equal(r, ranks[0][0]) and int(nf) == int(ranks[0][1])


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("method", ["peel", "grid", "densegrid", "staircase",
                                    "sweep2d"])
def test_tiny_inputs(method, n):
    w = _points("continuous", 8, 2)[:n]
    want, nf = jemo._jit_ranks(jnp.asarray(w), method=method)
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w), method=method)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tnf) == int(nf)


def test_staircase_ties_in_f2_and_duplicated_points():
    """The staircase's prefix is a lexicographic minimum over (f2, f1):
    equal f2 values must be told apart by f1, and exact duplicates share
    a front."""
    f = np.array([[0, 5], [1, 5], [1, 5], [2, 5], [2, 4], [3, 4], [3, 4],
                  [3, 3], [4, 3], [0, 5], [5, 0], [5, 0], [2, 6], [1, 6]],
                 np.float32)
    w = -f
    want, nf = jemo._jit_ranks(jnp.asarray(w), method="staircase")
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w),
                                       method="staircase")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tnf) == int(nf)
    assert got[0] == got[9] == 0 and got[10] == got[11] == 0
    assert got[1] == got[2] == 1          # (1, 5) twice, behind (0, 5)


def test_densegrid_falls_back_to_the_count_peel():
    """More distinct values on an axis than the dense grid holds (512 at
    two objectives): the counts come from the count peel."""
    w = _points("continuous", 700, 2)
    assert not temo._dense_value_ok(torch.from_numpy(w), 512)
    assert temo._dense_value_ok(torch.from_numpy(_points("discrete", 700, 2)),
                                512)
    want, nf = jemo._jit_ranks(jnp.asarray(w), method="densegrid",
                               stop_at_k=200)
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w),
                                       method="densegrid", stop_at_k=200)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tnf) == int(nf)


@pytest.mark.parametrize("kind", ["continuous", "duplicated", "invalid"])
@pytest.mark.parametrize("src_share", [1.0, 0.4])
def test_grid_counts_equal_jax(kind, src_share):
    """The grid's dominator counts with and without a source mask."""
    w = _points(kind, 400, 3)
    src = np.random.default_rng(3).random(400) < src_share
    want = np.asarray(jax.jit(jemo._grid_dominator_counts)(
        jnp.asarray(w), jnp.asarray(src)))
    got = temo._grid_dominator_counts(torch.from_numpy(w),
                                      torch.from_numpy(src))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_grid_band_pass_blocks_over_slabs(monkeypatch):
    """The band pass's slab blocking (which bounds its memory) does not
    change the counts."""
    w = torch.from_numpy(_points("mixed", 500, 3))
    want = temo._grid_dominator_counts(w)
    monkeypatch.setattr(temo, "_BAND_BLOCK", 1)        # one slab a block
    assert torch.equal(temo._grid_dominator_counts(w), want)


@pytest.mark.parametrize("recount_min_front", [1, 10 ** 9],
                         ids=["always-recount", "always-subtract"])
@pytest.mark.parametrize("stop_at_k", [None, 200])
def test_hybrid_peel_both_branches(recount_min_front, stop_at_k):
    """The grid peel's two update rules — the source-masked grid pass
    for a fat front, the exact subtraction for a thin one — forced each
    way through ``recount_min_front``."""
    w = _points("continuous", 600, 3)
    want, nf = jax.jit(lambda x: jemo._grid_recount_ranks(
        x, stop_at_k, 16, recount_min_front=recount_min_front))(
        jnp.asarray(w))
    got, tnf = temo._grid_recount_ranks(
        torch.from_numpy(w), stop_at_k, 16,
        recount_min_front=recount_min_front)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tnf) == int(nf)
    peel = temo.nondominated_ranks(torch.from_numpy(w), method="peel",
                                   stop_at_k=stop_at_k, front_chunk=16)
    assert torch.equal(got, peel[0])


def test_hybrid_peel_takes_each_branch_by_front_width(monkeypatch):
    calls = {"grid": 0, "exact": 0}
    grid, dom = temo._grid_counts_from_views, temo.rows_dominate_counts

    def counted_grid(v, src):
        calls["grid"] += 1
        return grid(v, src)

    def counted_dom(rows, w):
        calls["exact"] += 1
        return dom(rows, w)

    monkeypatch.setattr(temo, "_grid_counts_from_views", counted_grid)
    monkeypatch.setattr(temo, "rows_dominate_counts", counted_dom)
    w = torch.from_numpy(_points("continuous", 600, 3))
    ranks, nf = temo._grid_recount_ranks(w, None, 16, recount_min_front=40)
    widths = torch.bincount(ranks.long())
    fat = int((widths >= 40).sum())
    assert 0 < fat < nf
    assert calls["grid"] == 1 + fat          # the initial counts, then one
    assert calls["exact"] == sum(-(-int(x) // 16) for x in widths
                                 if x < 40)


def test_auto_reaches_the_grid_at_16384_points():
    w = np.random.default_rng(11).normal(size=(16384, 3)).astype(np.float32)
    want, nf = jemo._jit_ranks(jnp.asarray(w), method="auto", stop_at_k=8192)
    got, tnf = temo.nondominated_ranks(torch.from_numpy(w), method="auto",
                                       stop_at_k=8192)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tnf) == int(nf)
    assert (got.numpy() == 16384).any()                  # the unpeeled tail


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("k", [40, 100, 150])
def test_sel_nsga2_standard_indices_equal(m, k):
    """``nd="standard"`` — the reference's default — resolves to the
    staircase at two objectives and runs."""
    rng = np.random.default_rng(k + m)
    vals = rng.integers(0, 6, size=(200, m)).astype(np.float32) \
        + rng.normal(size=(200, m)).astype(np.float32) * (k % 3 == 0)
    valid = rng.random(200) < 0.9
    weights = (-1.0,) * m
    jf = jbase.Fitness(values=jnp.asarray(vals), valid=jnp.asarray(valid),
                       weights=weights)
    tf = tbase.Fitness(values=torch.from_numpy(vals),
                       valid=torch.from_numpy(valid), weights=weights)
    want = np.asarray(jax.jit(lambda f: jemo.sel_nsga2(None, f, k))(jf))
    got = temo.sel_nsga2(None, tf, k)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("first_front_only", [False, True])
def test_sort_nondominated_fronts_equal(m, first_front_only):
    vals = _points("mixed", 120, m)
    weights = (-1.0,) * m
    jf = jbase.Fitness(values=jnp.asarray(vals),
                       valid=jnp.ones(120, bool), weights=weights)
    tf = tbase.Fitness(values=torch.from_numpy(vals),
                       valid=torch.ones(120, dtype=torch.bool),
                       weights=weights)
    want = jemo.sort_nondominated(jf, 60, first_front_only)
    for sort in (temo.sort_nondominated, temo.sort_log_nondominated):
        got = sort(tf, 60, first_front_only)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
