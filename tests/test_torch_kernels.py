"""The CUDA kernels of deap_tpu_torch and their wrappers.

Tests marked ``gpu`` need a card and skip without one; run them on the
machine with the card (the file imports no JAX, and ``--noconftest``
skips the suite's JAX-based conftest):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

On the card each kernel must equal its plain version bit for bit (the
stated ulp bound is 0).  The CPU tests pin the wrappers' contract: CPU
tensors take the plain version and count no launch, the launchers refuse
CPU tensors, and a missing compiler raises instead of falling back.
"""

import pytest
import torch

from deap_tpu_torch import kernels, random
from deap_tpu_torch.kernels import build
from deap_tpu_torch.ops import generation as G

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

DIM = 100
KNOBS = [0.9, 0.5, 0.0, 0.3, 0.05]
STORAGES = [G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
            G.GenomeStorage("int8", 5.12)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, pop, st):
    key = random.PRNGKey(5, device=dev)
    k_g, k_o, k_p, k_s = random.split(key, 4)
    g = st.to_storage(random.uniform(k_g, (pop, DIM), minval=-5.12,
                                     maxval=5.12))
    order = torch.argsort(random.uniform(k_o, (pop,))).to(torch.int32)
    pos = random.randint(k_p, (pop,), 0, pop)
    knobs = torch.tensor(KNOBS, dtype=torch.float32, device=dev)
    return g, order, pos, G._seed_from_key(k_s), knobs


def _same(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("st", STORAGES, ids=lambda s: s.dtype)
def test_kernels_equal_plain_versions_on_card(st):
    dev = _cuda()
    pop = 1_000_000
    g, order, pos, seed, knobs = _inputs(dev, pop, st)
    kernels.reset_launches()
    k1 = G.megakernel_vary(g, seed, knobs, dim=DIM, storage=st)
    p1 = G._narrow(G._vary_tile_plain(G._widen(g, st.dtype, st.scale), seed,
                                      knobs, DIM), st.dtype, st.scale)
    k2, w2 = G.megakernel_gather_vary(order, pos, g, seed, knobs, dim=DIM,
                                      storage=st)
    p2, pw = G._gather_vary_plain(order, pos, g, seed, knobs, DIM, st)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"megakernel_vary": 1,
                                "megakernel_gather_vary": 1}
    assert _same(k1, p1) and _same(k2, p2) and torch.equal(w2, pw)


@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["dma", "host"])
def test_generation_on_card_equals_cpu(gather):
    dev = _cuda()
    st = G.GenomeStorage()
    g, _, _, _, _ = _inputs(dev, 1024, st)
    w = -(g * g).sum(1, keepdim=True)
    k_sel, k_var = random.split(random.PRNGKey(8, device=dev))
    outs = [G.fused_generation(k_sel.to(d), k_var.to(d), g.to(d), w.to(d),
                               dim=DIM, cxpb=0.9, mutpb=0.5, gather=gather)
            for d in (dev, "cpu")]
    assert _same(outs[0][0].cpu(), outs[1][0])
    assert torch.equal(outs[0][1].cpu().long(), outs[1][1].long())


def test_cpu_tensors_take_the_plain_version():
    st = G.GenomeStorage()
    g, order, pos, seed, knobs = _inputs("cpu", 256, st)
    kernels.reset_launches()
    out = G.megakernel_vary(g, seed, knobs, dim=DIM, storage=st)
    new, widx = G.megakernel_gather_vary(order, pos, g, seed, knobs,
                                         dim=DIM, storage=st)
    assert kernels.LAUNCHES == {"megakernel_vary": 0,
                                "megakernel_gather_vary": 0}
    assert out.shape == new.shape == (256, DIM)
    assert torch.equal(widx, order[pos.long()])


def test_launchers_refuse_cpu_tensors_before_building():
    st = G.GenomeStorage()
    g, order, pos, seed, knobs = _inputs("cpu", 64, st)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_vary(g, seed, knobs, dim=DIM, dtype="float32",
                            scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_gather_vary(order, pos, g, seed, knobs, dim=DIM,
                                   dtype="float32", scale=1.0)



def test_missing_compiler_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
