"""The hypervolume tiers of deap_tpu_torch against the JAX package.

* host tier (``ops/hv.py``, native C++ WFG or numpy WFG): equal to
  ``deap_tpu.ops.hv.hypervolume`` within 1e-12, d = 2..6;
* ``hypervolume_2d`` (torch): bitwise against the jitted JAX staircase in
  float32 up to the final sum's order (``SUM_RTOL``); the running minima
  and strips are bitwise;
* the plain 3-D sweep ``hypervolume_3d`` — the version K5 is held
  against on the card — in float32 against the jitted JAX sweep and
  against the Pallas kernel in interpret mode (relative 2e-5, the JAX
  package's own pin), blocks 16 and 128; in float64 against the host
  tier within 1e-12;
* the router, the ``Toolbox`` slot, and the typed refusals.

Inputs are made with numpy from a seed.  On the CPU nothing launches K5:
the ``gpu``-marked tests of ``tests/test_torch_kernels.py`` hold the
kernel against the plain version on a card.
"""

import importlib
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu_torch import _device, base as tbase, kernels
from deap_tpu_torch.benchmarks import tools as ttools
from deap_tpu_torch.native import hv as tnative
from deap_tpu_torch.ops import hv as thost, hypervolume as thv

# ``deap_tpu.ops`` exports a function named hypervolume: take the modules
jhost = importlib.import_module("deap_tpu.ops.hv")
jhv = importlib.import_module("deap_tpu.ops.hypervolume")
jtools = importlib.import_module("deap_tpu.benchmarks.tools")

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

F32_RTOL = 2e-5        # the JAX package's pin of its own two 3-D forms
SUM_RTOL = 1e-6        # one float32 sum of n strips in another order


def _dtlz2_front(n_side: int) -> np.ndarray:
    """Grid sample of the DTLZ2 front, the unit sphere's positive
    octant; its hypervolume at ref (1, 1, 1) tends to ``1 - pi/6``."""
    th = np.linspace(0.0, np.pi / 2, n_side)
    t, p = np.meshgrid(th, th)
    return np.stack([np.cos(t) * np.cos(p), np.cos(t) * np.sin(p),
                     np.sin(t)], axis=-1).reshape(-1, 3)


def _cases_3d():
    rng = np.random.default_rng(11)
    return {
        "random": (rng.random((64, 3)), np.full(3, 1.1)),
        "duplicates": (np.repeat(rng.random((20, 3)), 3, axis=0),
                       np.full(3, 1.5)),
        "beyond-ref": (rng.random((50, 3)) * 2.0, np.full(3, 1.0)),
        "dtlz2-front": (_dtlz2_front(12), np.full(3, 1.0)),
    }


@pytest.mark.parametrize("d", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("n", [1, 8, 40])
def test_host_tier_equals_jax_host(d, n):
    pts = np.random.default_rng(7 * d + n).random((n, d))
    ref = np.full(d, 1.5)
    want = jhost.hypervolume(pts, ref)
    assert thost.hypervolume(pts, ref) == pytest.approx(want, abs=1e-12)
    assert thost.hypervolume(torch.from_numpy(pts),
                             torch.from_numpy(ref)) == pytest.approx(
        want, abs=1e-12)
    # the numpy WFG, whatever tier answers above
    sub = pts[np.all(pts < ref, axis=1)]
    assert thost._wfg(thost._nds_min(sub), ref) == pytest.approx(want,
                                                                 abs=1e-12)


def test_host_tier_discards_points_beyond_ref_and_takes_one_point():
    assert thost.hypervolume([[1.0, 1.0], [2.0, 2.0], [1.5, 1.5]],
                             [3.0, 3.0]) == pytest.approx(4.0)
    assert thost.hypervolume([0.5, 0.5, 0.5], [1.0, 1.0, 1.0]) == 0.125
    assert thost.hypervolume([[2.0, 0.1, 0.1]], [1.0, 1.0, 1.0]) == 0.0
    assert thost.hypervolume(np.zeros((0, 3)), [1.0, 1.0, 1.0]) == 0.0


def test_native_library_builds_and_names_its_tier():
    """With a host compiler the native tier answers and the library
    lies in the ignored build directory; without one the numpy WFG
    answers."""
    from deap_tpu_torch.native import build
    have_cxx = bool(os.environ.get("CXX") or shutil.which("g++")
                    or shutil.which("c++"))
    lib = build.build()
    if have_cxx:
        assert thost.host_tier() == "native" and tnative.load() is not None
        assert lib.parent == build.BUILD_DIR
        assert lib.name.startswith("libdeap_tpu_hv-")
    else:
        assert lib is None and thost.host_tier() == "numpy"


def test_numpy_wfg_answers_without_a_compiler(monkeypatch):
    """No compiler, no library: the numpy WFG answers (the reference's
    policy for its one native component)."""
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "_lib", None)
    assert thost.host_tier() == "numpy"
    pts, ref = _cases_3d()["random"]
    assert thost.hypervolume(pts, ref) == pytest.approx(
        jhost.hypervolume(pts, ref), abs=1e-12)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.hypervolume(pts, ref)


def test_native_build_returns_none_without_a_compiler(monkeypatch, tmp_path):
    from deap_tpu_torch.native import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert build.build() is None


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_hypervolume_2d_against_jax(n):
    rng = np.random.default_rng(n)
    pts = rng.uniform(0, 1.2, (n, 2)).astype(np.float32)
    pts[::4, 1] = pts[0, 1]                        # ties in y
    ref = np.array([1.1, 1.0], np.float32)
    want = np.asarray(jax.jit(jhost.hypervolume_2d)(jnp.asarray(pts),
                                                    jnp.asarray(ref)))
    got = thost.hypervolume_2d(torch.from_numpy(pts), ref)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL)
    # the running minimum is XLA's associative_scan(minimum) bit for bit
    y = np.minimum(pts, ref)[np.argsort(np.minimum(pts, ref)[:, 0],
                                        kind="stable"), 1]
    scan = np.asarray(jax.jit(lambda v: jax.lax.associative_scan(
        jnp.minimum, v))(jnp.asarray(y)))
    assert np.array_equal(torch.cummin(torch.from_numpy(y), 0).values.numpy()
                          .view(np.uint32), scan.view(np.uint32))
    assert float(got) == pytest.approx(
        jhost.hypervolume(pts.astype(np.float64), ref.astype(np.float64)),
        rel=1e-5)


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("n", [7, 100, 130])
def test_plain_3d_float32_against_jax_and_pallas_interpret(n, block):
    rng = np.random.default_rng(n)
    pts = rng.uniform(0, 1.2, (n, 3)).astype(np.float32)
    pts[::5] = pts[1]                              # duplicates, equal z
    ref = np.array([1.0, 1.1, 0.9], np.float32)
    got = thv.hypervolume_3d(torch.from_numpy(pts), ref, block=block)
    assert got.dtype == torch.float32 and got.ndim == 0
    xla = float(jhv.hypervolume_3d(jnp.asarray(pts), jnp.asarray(ref),
                                   block=block))
    pallas = float(jhv.hypervolume_3d_pallas(
        jnp.asarray(pts), jnp.asarray(ref), block=block, interpret=True))
    assert float(got) == pytest.approx(xla, rel=F32_RTOL)
    assert float(got) == pytest.approx(pallas, rel=F32_RTOL)
    # the slab partials K5 writes, one per block of prefixes
    parts = thv._slab_volumes(torch.from_numpy(pts), ref, block)
    assert parts.shape == (-(-n // min(block, n)),)
    assert float(parts.double().sum()) == pytest.approx(float(got),
                                                        rel=F32_RTOL)


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("case", list(_cases_3d()))
def test_plain_3d_float64_equals_host_tier(case, block):
    pts, ref = _cases_3d()[case]
    got = thv.hypervolume_3d(torch.from_numpy(pts), ref, block=block)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(jhost.hypervolume(pts, ref),
                                       abs=1e-12)
    with jax.enable_x64(True):
        xla = float(jhv.hypervolume_3d(jnp.asarray(pts, jnp.float64),
                                       jnp.asarray(ref, jnp.float64),
                                       block=block))
    assert float(got) == pytest.approx(xla, abs=1e-12)


def test_dtlz2_front_known_value():
    pts, ref = _dtlz2_front(40), np.full(3, 1.0)
    exact = 1.0 - np.pi / 6.0
    got = float(thv.hypervolume_3d(torch.from_numpy(pts), ref))
    assert got == pytest.approx(jhost.hypervolume(pts, ref), abs=1e-12)
    assert exact - 0.08 < got < exact + 1e-12


def test_prep_sorts_are_stable_and_ranks_are_a_permutation():
    pts = torch.tensor([[0.5, 0.2, 0.3], [0.5, 0.1, 0.3], [0.1, 0.9, 0.3],
                        [0.5, 0.4, 0.1]], dtype=torch.float64)
    ref = torch.ones(3, dtype=torch.float64)
    xs, ys, zr, dz, width = thv._hv3d_prep(pts, ref)
    assert zr.dtype == torch.int32 and sorted(zr.tolist()) == [0, 1, 2, 3]
    assert xs.tolist() == [0.1, 0.5, 0.5, 0.5]
    assert ys.tolist() == [0.9, 0.4, 0.2, 0.1]     # ties in x keep z order
    assert dz.tolist() == pytest.approx([0.2, 0.0, 0.0, 0.7])
    assert width.tolist() == pytest.approx([0.4, 0.0, 0.0, 0.5])


@pytest.mark.parametrize("d", [2, 3, 4])
def test_router_and_toolbox_slot_on_the_cpu(d):
    pts = np.random.default_rng(d).random((60, d))
    ref = np.full(d, 1.1)
    want = jhost.hypervolume(pts, ref)
    kernels.reset_launches()
    tb = tbase.Toolbox()
    assert tb.hypervolume.func is thv.hypervolume
    for p in (pts, torch.from_numpy(pts), torch.from_numpy(pts).float()):
        got = tb.hypervolume(p, ref, device="cpu")
        assert isinstance(got, float)
        tol = 1e-12 if not (torch.is_tensor(p) and p.dtype == torch.float32) \
            else 1e-6
        assert got == pytest.approx(want, abs=tol)
    assert kernels.LAUNCHES["hv3d_sweep"] == 0          # CPU: plain sweep
    assert thv.hypervolume(pts[0], ref, device="cpu") == pytest.approx(
        float(np.prod(ref - pts[0])), abs=1e-12)


def test_router_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    pts = np.random.default_rng(0).random((10, 3))
    with pytest.raises(_device.NoCudaDevice):
        thv.hypervolume(pts, [1.1] * 3)
    with pytest.raises(_device.NoCudaDevice):
        tbase.Toolbox().hypervolume(pts, [1.1] * 3)
    # two objectives and four never touch a device: the host answers
    assert thv.hypervolume(pts[:, :2], [1.1] * 2) > 0


def test_device_entry_routes_by_dimension_and_device():
    rng = np.random.default_rng(2)
    p2 = torch.from_numpy(rng.random((30, 2)))
    p3 = torch.from_numpy(rng.random((30, 3)).astype(np.float32))
    assert float(thv.hypervolume_device(p2, [1.1, 1.1])) == pytest.approx(
        jhost.hypervolume(p2.numpy(), [1.1, 1.1]), abs=1e-12)
    got = thv.hypervolume_device(p3, [1.1] * 3)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(
        jhost.hypervolume(p3.numpy().astype(np.float64), [1.1] * 3),
        rel=F32_RTOL)
    with pytest.raises(ValueError, match="2 or 3 objectives"):
        thv.hypervolume_device(torch.zeros((4, 4)), [1.0] * 4)
    with pytest.raises(ValueError, match="CUDA points"):
        thv.hypervolume_3d_cuda(p3, [1.1] * 3)          # no quiet fallback


def test_hypervolume_sharded_is_a_typed_refusal(tmp_path):
    """``hypervolume_sharded`` now runs (``tests/test_torch_parallel.py``
    holds it over 1, 2 and 4 ranks): on a one-rank mesh it is the plain
    sweep bit for bit at d == 3 and the staircase at d == 2, and it still
    refuses other objective counts."""
    import _torch_dist_cases
    rng = np.random.default_rng(4)
    p3 = torch.from_numpy(rng.random((200, 3)))
    p2 = torch.from_numpy(rng.random((200, 2)))
    with _torch_dist_cases.one_rank_mesh(tmp_path) as mesh:
        got3 = thv.hypervolume_sharded(p3, [1.0] * 3, mesh)
        assert torch.equal(got3, thv.hypervolume_3d(p3, [1.0] * 3))
        got2 = thv.hypervolume_sharded(p2, [1.0] * 2, mesh)
        assert got2.item() == pytest.approx(
            jhost.hypervolume(p2.numpy(), [1.0, 1.0]), rel=1e-12)
        with pytest.raises(ValueError, match="2 or 3 objectives"):
            thv.hypervolume_sharded(torch.zeros((8, 4)), [1.0] * 4, mesh)
    assert not hasattr(thv, "ShardedNotPorted")


def test_launcher_refuses_cpu_tensors_and_bad_threads():
    ys = torch.zeros(8)
    zr = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.launch_hv3d_sweep(ys, zr, ys, ys, 1.0)
    with pytest.raises(ValueError, match="multiple of 32"):
        kernels.launch_hv3d_sweep(ys, zr, ys, ys, 1.0, threads=100)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.launch_hv3d_sweep(ys.half(), zr, ys, ys, 1.0)


@pytest.mark.parametrize("metric", ["hypervolume", "hypervolume-default-ref",
                                    "diversity", "convergence", "igd"])
def test_benchmark_tools_equal_jax(metric):
    rng = np.random.default_rng(4)
    x = np.sort(rng.random(25))
    vals = np.stack([x, 1 - np.sqrt(x)], 1).astype(np.float32)
    opt = np.stack([np.linspace(0, 1, 50), 1 - np.sqrt(np.linspace(0, 1, 50))],
                   1)
    fit = tbase.Fitness(values=torch.from_numpy(vals),
                        valid=torch.ones(25, dtype=torch.bool),
                        weights=(-1.0, -1.0))
    pop = tbase.Population(torch.zeros((25, 3)), fit)
    if metric == "hypervolume":
        want = jtools.hypervolume(vals, [11.0, 11.0])
        gots = [ttools.hypervolume(f, [11.0, 11.0])
                for f in (fit, pop, vals, torch.from_numpy(vals))]
    elif metric == "hypervolume-default-ref":
        want = jtools.hypervolume(vals)
        gots = [ttools.hypervolume(f) for f in (fit, pop, vals)]
    elif metric == "diversity":
        want = jtools.diversity(vals, vals[0], vals[-1])
        gots = [ttools.diversity(f, vals[0], vals[-1])
                for f in (fit, pop, vals)]
    elif metric == "convergence":
        want = jtools.convergence(vals, opt)
        gots = [ttools.convergence(f, opt) for f in (fit, pop, vals)]
    else:
        want = jtools.igd(vals, opt)
        gots = [ttools.igd(vals, opt), ttools.igd(torch.from_numpy(vals),
                                                  torch.from_numpy(opt))]
    for got in gots:
        assert got == pytest.approx(want, abs=1e-12)
