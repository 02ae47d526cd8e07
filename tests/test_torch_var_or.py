"""deap_tpu_torch's var_or against the JAX package's.

* ``fused_var_or`` (the megakernel engine; on the CPU K3's plain version
  ``_var_or_plain``) against the JAX package's ``fused_var_or(
  vary_exec="xla")``, and K3's plain tile against ``_var_or_xla_exec``
  and ``_var_or_pallas`` in interpret mode: bitwise in float32, bfloat16
  and int8 storage (the noise goes through XLA's own ``erf_inv`` and FMA
  placement, so the stated ulp bound is 0);
* ``var_or`` on the plain ``xla`` engine: bitwise in float32.  On a
  narrow genome the JAX package draws its Gaussian noise in the genome's
  dtype (and rejects int8); the port has float32 normals only and raises.

Also the genome widths 1, 3 and 1000, the all-reproduction case, the
``cxpb + mutpb > 1`` assertion, lambda != mu, and the clip at the
slice's indpb = 1/12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import algorithms as jalg, base as jbase
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import generation_pallas as gp
from deap_tpu_torch import algorithms as talg, base as tbase, interop, kernels
from deap_tpu_torch import random as tr
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import generation as tg

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

N, LAMBDA, DIM = 96, 160, 12
INDPB, SIGMA = 1.0 / 12, 0.1
STORAGES = [("float32", 0.0), ("bfloat16", 0.0), ("int8", 5.12)]
WEIGHTS = (-1.0, -1.0, -1.0)


def _toolboxes(engine, dtype="float32", bound=0.0):
    out = []
    for base, cx, mut, storage in (
            (jbase, jcx, jmut, gp.GenomeStorage),
            (tbase, tcx, tmut, tg.GenomeStorage)):
        tb = base.Toolbox()
        tb.register("mate", cx.cx_two_point)
        tb.register("mutate", mut.mut_gaussian, mu=0.0, sigma=SIGMA,
                    indpb=INDPB)
        tb.generation_engine = engine
        if dtype != "float32":
            tb.genome_storage = storage(dtype, bound)
        out.append(tb)
    return out


def _pops(dtype="float32", bound=0.0, n=N, seed=0, dim=DIM):
    g = np.random.default_rng(seed).uniform(-5.12, 5.12, (n, dim))
    jg = gp.GenomeStorage(dtype, bound).to_storage(
        jnp.asarray(g, jnp.float32))
    jp = jbase.Population(jg, jbase.Fitness.empty(n, WEIGHTS))
    tp = interop.population_to_torch(np.asarray(jg), np.zeros((n, 3)),
                                     np.zeros(n, bool), WEIGHTS,
                                     device="cpu")
    return jp, tp


def _bits(x):
    a = x if isinstance(x, np.ndarray) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a.view(np.uint8)


def _same(jgenome, tgenome):
    return np.array_equal(_bits(jgenome),
                          _bits(interop.genome_to_numpy(tgenome)))


@pytest.mark.parametrize("dtype,bound", STORAGES)
@pytest.mark.parametrize("cxpb,mutpb", [(0.6, 0.3), (0.0, 1.0), (1.0, 0.0)])
def test_fused_var_or_matches_jax_bitwise(dtype, bound, cxpb, mutpb):
    jtb, ttb = _toolboxes("megakernel", dtype, bound)
    jp, tp = _pops(dtype, bound)
    key = jax.random.PRNGKey(7)
    jo = gp.fused_var_or(key, jp, jtb, LAMBDA, cxpb, mutpb, vary_exec="xla")
    kernels.reset_launches()
    to = talg.var_or(interop.key_to_torch(key, device="cpu"), tp, ttb,
                     LAMBDA, cxpb, mutpb)
    assert kernels.LAUNCHES["megakernel_var_or"] == 0     # CPU: plain
    assert to.genome.dtype == tp.genome.dtype
    assert tuple(to.genome.shape) == (LAMBDA, DIM)
    assert _same(jo.genome, to.genome)
    assert not to.fitness.valid.any() and to.fitness.weights == WEIGHTS


@pytest.mark.parametrize("dtype,bound", STORAGES)
@pytest.mark.parametrize("dim", [1, 3, 1000])
def test_fused_var_or_matches_jax_bitwise_at_dims(dtype, bound, dim):
    """As above at other genome widths: one gene (the cut pair over a
    single gene), three, and 1000 (many vector chunks a row on the
    card)."""
    jtb, ttb = _toolboxes("megakernel", dtype, bound)
    jp, tp = _pops(dtype, bound, dim=dim)
    key = jax.random.PRNGKey(dim)
    jo = gp.fused_var_or(key, jp, jtb, LAMBDA, 0.6, 0.3, vary_exec="xla")
    to = talg.var_or(interop.key_to_torch(key, device="cpu"), tp, ttb,
                     LAMBDA, 0.6, 0.3)
    assert tuple(to.genome.shape) == (LAMBDA, dim)
    assert _same(jo.genome, to.genome)


@pytest.mark.parametrize("dtype,bound", STORAGES)
def test_all_reproduction_copies_parents(dtype, bound):
    """cxpb = mutpb = 0: every child is a bitwise copy of its parent row
    ``ir`` — in both packages and both engines."""
    jtb, ttb = _toolboxes("megakernel", dtype, bound)
    jp, tp = _pops(dtype, bound)
    key = jax.random.PRNGKey(3)
    jo = gp.fused_var_or(key, jp, jtb, LAMBDA, 0.0, 0.0, vary_exec="xla")
    to = talg.var_or(interop.key_to_torch(key, device="cpu"), tp, ttb,
                     LAMBDA, 0.0, 0.0)
    ir = np.asarray(jax.random.randint(jax.random.split(key, 7)[6],
                                       (LAMBDA,), 0, N))
    assert _same(np.asarray(jp.genome)[ir], to.genome)
    assert _same(jo.genome, to.genome)


@pytest.mark.parametrize("lam", [64, 96, 192])
def test_var_or_xla_engine_matches_jax_bitwise(lam):
    """Against the jitted ``var_or`` (the parity oracle): under ``jit``
    XLA folds ``sigma * sqrt(2)`` and fuses ``mut_gaussian``'s add into
    an FMA, as the port computes it; eager JAX rounds otherwise."""
    jtb, ttb = _toolboxes("xla")
    jp, tp = _pops(seed=lam)
    key = jax.random.PRNGKey(lam)
    for cxpb, mutpb in ((0.6, 0.3), (0.0, 0.0), (0.2, 0.8)):
        jo = jax.jit(lambda k, p: jalg.var_or(k, p, jtb, lam, cxpb, mutpb))(
            key, jp)
        to = talg.var_or(interop.key_to_torch(key, device="cpu"), tp, ttb,
                         lam, cxpb, mutpb)
        assert _same(jo.genome, to.genome)


@pytest.mark.parametrize("dtype,bound", STORAGES[1:])
def test_var_or_xla_engine_refuses_narrow_genomes(dtype, bound):
    """Mutation on a narrow genome draws normals in the genome's dtype:
    both packages refuse int8; bfloat16 normals are drawn as jax draws
    them, so a bfloat16 genome varies bitwise as in the JAX package."""
    jtb, ttb = _toolboxes("xla")
    jp, tp = _pops(dtype, bound)
    key = jax.random.PRNGKey(1)
    if dtype == "int8":
        with pytest.raises(ValueError):
            jalg.var_or(key, jp, jtb, LAMBDA, 0.5, 0.5)
        with pytest.raises(TypeError, match="float32 and bfloat16"):
            talg.var_or(interop.key_to_torch(key, device="cpu"), tp, ttb,
                        LAMBDA, 0.5, 0.5)
        return
    jo = jalg.var_or(key, jp, jtb, LAMBDA, 0.5, 0.5)
    to = talg.var_or(interop.key_to_torch(key, device="cpu"), tp, ttb,
                     LAMBDA, 0.5, 0.5)
    assert to.genome.dtype == torch.bfloat16
    assert _same(jo.genome, to.genome)


@pytest.mark.parametrize("engine", ["megakernel", "xla"])
def test_var_or_probability_sum_asserted(engine):
    _, ttb = _toolboxes(engine)
    _, tp = _pops()
    with pytest.raises(AssertionError, match="smaller or equal to 1.0"):
        talg.var_or(tr.PRNGKey(0, device="cpu"), tp, ttb, LAMBDA, 0.7, 0.4)


@pytest.mark.parametrize("dtype,bound", STORAGES)
def test_var_or_tile_plain_matches_xla_exec_and_pallas(dtype, bound):
    """K3's plain tile (behind ``megakernel_var_or``) against the JAX
    package's two executors of ``_var_or_tile``, on parents widened by
    each package and the same code / seed / knobs."""
    rng = np.random.default_rng(11)
    n = 64
    js = gp.GenomeStorage(dtype, bound)
    ts = interop.storage_to_torch(js)
    genome = js.to_storage(jnp.asarray(rng.uniform(-5, 5, (n, DIM)),
                                       jnp.float32))
    ia = rng.integers(0, n, n).astype(np.int32)
    i2 = rng.integers(0, n, n).astype(np.int32)
    code = rng.integers(0, 3, n).astype(np.int32)
    seed = np.int32(-123456789)
    knobs = np.array([0.1, SIGMA, INDPB], np.float32)
    a = js.to_compute(genome[ia])
    b = js.to_compute(genome[i2])
    jx = gp._var_or_xla_exec(a, b, jnp.asarray(code), jnp.asarray(seed),
                             jnp.asarray(knobs), dim=DIM, rows=32)
    jp_ = gp._var_or_pallas(
        jnp.pad(a, ((0, 0), (0, 128 - DIM))),
        jnp.pad(b, ((0, 0), (0, 128 - DIM))), jnp.asarray(code),
        jnp.asarray(seed), jnp.asarray(knobs), dim=DIM, rows=32,
        interpret=True)[:, :DIM]
    assert np.array_equal(np.asarray(jx).view(np.uint32),
                          np.asarray(jp_).view(np.uint32))
    tout = tg.megakernel_var_or(
        interop.genome_to_torch(np.asarray(genome), "cpu"),
        torch.from_numpy(ia), torch.from_numpy(i2), torch.from_numpy(code),
        torch.tensor(seed), torch.from_numpy(knobs), dim=DIM, storage=ts)
    assert _same(js.to_storage(jx), tout)


def test_mutation_clip_never_reaches_one_at_slice_indpb():
    """At indpb = 1/12 the largest gated uniform, 1398101 / 2**24, times
    float32(1 / indpb) stays below 1, so erf_inv never sees +-1 and the
    noise stays finite (the clip's upper end rounds to 1.0)."""
    inv = np.float32(1.0) / np.float32(INDPB)
    top = np.float32(1398101) * np.float32(2.0 ** -24)
    assert top < np.float32(INDPB) <= np.float32(1398102 * 2.0 ** -24)
    un = np.float32(top * inv)
    assert un < np.float32(1.0)
    assert float(un) == pytest.approx(1 - 2.4e-7, abs=5e-8)
    z = tg.erf_inv(torch.tensor([2.0 * float(un) - 1.0]))
    assert torch.isfinite(z).all() and float(z) > 3.5
