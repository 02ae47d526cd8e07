"""deap_tpu_torch.probes.ga against tools/pallas_probe_ga.py.

The JAX side is the unchanged tool, loaded from its file with ``POP =
2048``: each probe is called with ``pl.pallas_call`` watched and its timing
stubbed, which hands over the probe's own Pallas kernel, run here in
interpret mode on the inputs the test gives it.  The port's P1–P4
wrappers take their plain versions for CPU tensors (the kernels
themselves are held against the plain versions on the card, in
``tests/test_torch_kernels.py``).

Stated bounds: the copy, the chain, the rastrigin reduce, the uniforms and
normals of the counter hash and the row gather are bitwise (ulp bound 0);
the lookup is exact.  The chain is bitwise only with its fused
multiply-add: XLA's CPU backend contracts ``v * 1.0000001 + 1e-7``, and
two roundings differ on about a third of the elements.  The rastrigin
reduce is bitwise because it repeats XLA's form of the term
(``fma(v, v, -(10 cos(2 pi v))) + 10``) and its order of summation (four
windows of 32 lanes, each from 0, then their sum: a reduce-window in the
optimized HLO).  The TPU probe's hardware bits cannot run here
(``prng_seed`` has no CPU lowering), so P2's uniforms are held against the
JAX package's counter hash, ``_uniform_tile``, and its normals against a
jitted ``jnp`` form of the same law.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu.lint.rules_data import _schema_errors
from deap_tpu.ops.generation_pallas import _uniform_tile
from deap_tpu_torch import kernels, random as tr
from deap_tpu_torch.ops.generation import M32, _uniform_at
from deap_tpu_torch.probes import ga

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POP = 2048
ULP_BOUND = 0


@pytest.fixture(scope="module")
def pga():
    spec = importlib.util.spec_from_file_location(
        "pallas_probe_ga_reference", ROOT / "tools" / "pallas_probe_ga.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.POP = POP
    return mod


class _Watch:
    """``pl`` with ``pallas_call`` recorded."""

    def __init__(self, pl):
        self._pl, self.calls = pl, []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        fn = self._pl.pallas_call(*args, **kwargs)
        self.calls.append(fn)
        return fn


def _kernels_of(pga, probe, monkeypatch):
    """The Pallas kernels ``probe`` builds, in order (nothing timed)."""
    watch = _Watch(pga.pl)
    monkeypatch.setattr(pga, "pl", watch)
    monkeypatch.setattr(pga, "marginal", lambda *a, **k: (1.0, 2.0))
    monkeypatch.setattr(pga, "report", lambda *a, **k: None)
    probe()
    return watch.calls


def _bits(a):
    return np.asarray(a).view(np.int32)


def _x():
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                      (POP, ga.LANE), jnp.float32))
    port = tr.uniform(tr.PRNGKey(0, device="cpu"), (POP, ga.LANE))
    assert np.array_equal(_bits(port.numpy()), _bits(x))    # the tool's input
    return x


@pytest.mark.parametrize("rows", [512, 2048])
def test_stream_is_bitwise_to_the_tool_kernel(pga, monkeypatch, rows):
    runs = _kernels_of(pga, pga.probe_stream, monkeypatch)
    assert len(runs) == 3                          # rows 512, 2048, 8192
    x = _x()
    want = np.asarray(runs[(512, 2048).index(rows)](jnp.asarray(x)))
    got = ga.stream(torch.from_numpy(x.copy()), rows)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_chain_is_bitwise_to_the_tool_kernel_only_with_the_fma(
        pga, monkeypatch):
    (run,) = _kernels_of(pga, pga.probe_chain, monkeypatch)
    x = _x()
    want = _bits(run(jnp.asarray(x)))
    got = ga.chain24(torch.from_numpy(x.copy()))
    assert np.array_equal(_bits(got.numpy()), want)
    two = torch.from_numpy(x.copy())
    for _ in range(24):
        two = two * np.float32(1.0000001) + np.float32(1e-7)
    share = float(np.mean(_bits(two.numpy()) != want))
    assert 0.2 < share < 0.5, share


def test_rast_reduce_is_bitwise_to_the_tool_kernel(pga, monkeypatch):
    (run,) = _kernels_of(pga, pga.probe_rast, monkeypatch)
    x = _x()
    want = np.asarray(run(jnp.asarray(x)))[:, 0]
    got = ga.rast_reduce(torch.from_numpy(x.copy()), pga.DIM)
    assert got.shape == (POP,)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def _cosf_battery():
    """``(POP, 128)`` float32 rows whose lanes reach every branch of
    glibc's ``cosf`` on ``2 pi v``: below 2^-12, below 0.75, below 120, at
    120 or more, each of either sign, and -0.0; one row in 16 also holds
    +-inf, NaN or 1e30 (whose square overflows) at a random lane."""
    rng = np.random.default_rng(10)
    u = rng.random((POP, ga.LANE))
    scale = np.array([1e-5, 0.11, 19.0, 1e4])         # 2 pi v: the branches
    branch = rng.integers(0, len(scale), (POP, ga.LANE))
    v = u * scale[branch]
    v[branch == 3] += 19.2                            # 2 pi v >= 120
    v = np.where(rng.random((POP, ga.LANE)) < 0.5, -v, v)
    v[rng.random((POP, ga.LANE)) < 0.02] = -0.0
    rows = np.flatnonzero(rng.random(POP) < 1 / 16)
    v[rows, rng.integers(0, ga.LANE, rows.size)] = rng.choice(
        [np.inf, -np.inf, np.nan, 1e30], rows.size)
    return v.astype(np.float32)


@pytest.mark.parametrize("dim", [0, 1, 33, 96, 100, 128])
def test_rast_reduce_is_bitwise_to_the_tool_kernel_on_every_cosf_branch(
        pga, monkeypatch, dim):
    """The plain reduce against the tool's Pallas kernel (interpret mode)
    with its mask at ``dim``, on :func:`_cosf_battery`: every row's bits
    equal, except that a NaN row is NaN on both sides with either sign
    (x86's default NaN, which glibc's ``cosf(inf)`` returns, is negative;
    the port's cosine returns the positive quiet NaN)."""
    monkeypatch.setattr(pga, "DIM", dim)          # read when it is traced
    (run,) = _kernels_of(pga, pga.probe_rast, monkeypatch)
    x = _cosf_battery()
    want = np.asarray(run(jnp.asarray(x)))[:, 0]
    got = ga.rast_reduce(torch.from_numpy(x.copy()), dim).numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(_bits(got)[~nan], _bits(want)[~nan])
    live = x[:, :dim]
    assert nan.any() == (np.isnan(live) | np.isinf(live)).any()
    if dim >= 33:                       # every branch in the live lanes
        y = np.abs(live[np.isfinite(live)].astype(np.float64) * 2 * np.pi)
        for lo, hi in ((0, 2.0 ** -12), (2.0 ** -12, 0.75), (0.75, 120),
                       (120, np.inf)):
            assert ((y >= lo) & (y < hi)).any()


def test_rast_inputs_hold_both_cosine_paths_and_the_specials():
    """The card tests' reduce inputs: rows wholly inside the branch-free
    cosine's range, rows with one lane outside it, rows wholly outside,
    and NaN / +-inf rows; the plain reduce is NaN exactly on the latter."""
    x = ga.rast_inputs(2049, "cpu")
    assert x.shape == (2049, ga.LANE) and x.dtype == torch.float32
    inside = (x * ga._F32_2PI).abs() < 120        # NaN compares False
    whole = inside.all(1)
    assert whole.any() and (inside.sum(1) == ga.LANE - 1).any()
    assert (~inside).all(1).any()
    special = ~torch.isfinite(x)
    assert torch.isnan(x).any() and torch.isinf(x).any()
    got = ga.rast_reduce(x, ga.LANE)
    assert torch.equal(torch.isnan(got), special.any(1))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_lookup_inputs_are_views_at_every_offset(offset):
    order, pos = ga.lookup_inputs(1027, offset, "cpu")
    m = order.shape[0]
    assert m == 1027 // 3 + 17 and sorted(order.tolist()) == list(range(m))
    assert pos.shape == (1027,) and pos.storage_offset() == offset
    assert pos[0] == 0 and pos[-1] == m - 1 and int(pos.max()) < m
    assert torch.equal(ga.lookup(order, pos), order[pos.long()])


def test_tool_rng_kernel_has_no_cpu_oracle(pga, monkeypatch):
    """The TPU probe seeds the TPU's hardware generator: its kernel builds
    here but cannot run (``prng_seed`` has no CPU lowering)."""
    (run,) = _kernels_of(pga, pga.probe_rng, monkeypatch)
    with pytest.raises(NotImplementedError, match="prng_seed"):
        run(jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("seed", [0, 12345, -7])
def test_hash_normals_are_bitwise_to_the_jax_hash_and_law(seed):
    useed = jnp.uint32(seed & 0xFFFFFFFF)

    @jax.jit
    def law(s):
        u = _uniform_tile(s, 6, (POP, ga.LANE), 0)
        u2 = _uniform_tile(s, 7, (POP, ga.LANE), 0)
        u1 = u + 1e-7
        return u, u2, jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(
            2.0 * jnp.pi * u2)

    u, u2, normals = (np.asarray(a) for a in law(useed))
    s = torch.tensor([seed], dtype=torch.int32)
    rows = torch.arange(POP, dtype=torch.int64)[:, None]
    lanes = torch.arange(ga.LANE, dtype=torch.int64)[None]
    ws = torch.tensor(seed, dtype=torch.int64) & M32
    for draw, want in ((6, u), (7, u2)):
        got = _uniform_at(ws, draw, rows, lanes)
        assert np.array_equal(_bits(got.numpy()), _bits(want))
    got = ga.hash_normal(s, POP)
    assert got.shape == (POP, ga.LANE)
    assert np.array_equal(_bits(got.numpy()), _bits(normals))


def test_lookup_is_exact_against_the_tool_kernel(pga, monkeypatch):
    (run,) = _kernels_of(pga, pga.probe_lookup, monkeypatch)
    rng = np.random.default_rng(4)
    order = rng.permutation(POP).astype(np.int32)
    pos = rng.integers(0, POP, POP).astype(np.int32)
    want = np.asarray(run(jnp.asarray(pos)[:, None],
                          jnp.asarray(order).reshape(POP // ga.LANE,
                                                     ga.LANE)))[:, 0]
    got = ga.lookup(torch.from_numpy(order), torch.from_numpy(pos))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_row_gather_is_bitwise_to_the_tool_kernel(pga, monkeypatch):
    (run,) = _kernels_of(pga, pga.probe_dmagather, monkeypatch)
    rng = np.random.default_rng(5)
    genome = rng.standard_normal((POP, ga.LANE)).astype(np.float32)
    idx = rng.integers(0, POP, POP).astype(np.int32)
    want = np.asarray(run(jnp.asarray(idx)[:, None], jnp.asarray(genome)))
    got = ga.row_gather(torch.from_numpy(genome), torch.from_numpy(idx))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    x = tr.uniform(tr.PRNGKey(1, device="cpu"), (64, ga.LANE))
    idx = torch.arange(64, dtype=torch.int32).flip(0)
    kernels.reset_launches()
    ga.stream(x)
    ga.chain24(x)
    ga.rast_reduce(x)
    ga.hash_normal(torch.zeros(1, dtype=torch.int32), 64)
    ga.lookup(idx, idx)
    ga.row_gather(x, idx)
    assert not any(kernels.LAUNCHES.values())


def test_probe_launchers_refuse_cpu_tensors():
    x = torch.zeros((64, ga.LANE))
    idx = torch.zeros(64, dtype=torch.int32)
    for call in (lambda: kernels.launch_probe_stream_copy(x, rows=512),
                 lambda: kernels.launch_probe_chain24(x),
                 lambda: kernels.launch_probe_rast_reduce(x, dim=100),
                 lambda: kernels.launch_probe_hash_normal(
                     torch.zeros(1, dtype=torch.int32), 64),
                 lambda: kernels.launch_probe_lookup(idx, idx),
                 lambda: kernels.launch_probe_row_gather(x, idx)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_bounds_are_the_stated_shapes_work():
    pop = 1 << 20
    assert ga.kernel_bound("stream", pop) == pytest.approx(
        (2 * 4 * pop * 128 / 3.35e12 * 1e3, "bytes"))
    assert ga.kernel_bound("chain", pop)[1] == "bytes"
    assert ga.kernel_bound("rast", pop) == pytest.approx(
        (22 * pop * ga.DIM / 16.75e12 * 1e3, "operations"))
    assert ga.kernel_bound("rast", pop, 0) == pytest.approx(
        (4 * pop / 3.35e12 * 1e3, "bytes"))
    assert ga.kernel_bound("rng", pop)[1] == "operations"
    assert ga.kernel_bound("lookup", pop)[0] == pytest.approx(
        12 * pop / 3.35e12 * 1e3)
    assert ga.kernel_bound("dmagather", pop)[0] == pytest.approx(
        (1024 * pop + 4 * pop) / 3.35e12 * 1e3)


def test_recommendation_reads_the_gather_probes():
    rows = [{"probe": "cuda_dmagather_rows512_w16", "eff_gbps": 2000.0},
            {"probe": "torch_grow_pib_d128", "eff_gbps": 1500.0}]
    rec = ga.recommend_defaults(rows, "gpu")
    assert rec["gather"] == "dma" and "2000.0 GB/s" in rec["basis"][0]
    rows[1]["eff_gbps"] = 2500.0
    assert ga.recommend_defaults(rows, "gpu")["gather"] == "host"
    assert ga.recommend_defaults(rows[:1], "gpu")["gather"] == "dma"
    assert "unmeasured" in ga.recommend_defaults(rows[:1], "gpu")["basis"][0]
    assert ga.recommend_defaults(rows, "cpu")["gather"] == "host"


def test_tool_document_passes_the_jax_packages_schema(monkeypatch, tmp_path):
    monkeypatch.setattr(ga, "K_ITERS", 2)
    path = tmp_path / "probe_ga.json"
    doc = ga.main(["stream", "chain", "rast", "lookup", "dmagather", "sort",
                   "--pop", "2048", "--device", "cpu", "--recommend",
                   "--json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    assert _schema_errors("probe_ga", doc) == []
    res = doc["result"]
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["errors"] == [] and res["recommend"]["gather"] == "host"
    names = [r["probe"] for r in res["probes"]]
    assert names == ["plain_stream_rows512", "plain_stream_rows2048",
                     "plain_stream_rows8192", "plain_chain24",
                     "plain_rastrigin_reduce", "plain_lookup_l2_scalar",
                     "plain_dmagather_rows512_w16",
                     "torch_sort_argsort_f32_1m", "torch_sort_i32_1m"]
    for r in res["probes"]:
        assert r["device"] == "cpu" and r["k"] == 2
        assert r["route"] == ("torch" if r["probe"].startswith("torch_")
                              else "plain")
        assert ("bound_ms" in r) == (r["route"] == "plain")


def test_varveval_records_threefry_and_errors_on_rbg(monkeypatch):
    monkeypatch.setattr(ga, "K_ITERS", 1)
    doc = ga.main(["varveval", "--pop", "64", "--device", "cpu"])
    res = doc["result"]
    # the rbg leg is ported: both legs are recorded and nothing errs
    assert [r["probe"] for r in res["probes"]] == [
        "torch_varveval_threefry2x32", "torch_varveval_rbg"]
    assert res["errors"] == []
