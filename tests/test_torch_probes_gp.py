"""deap_tpu_torch.probes.gp against tools/pallas_probe_gp.py.

The JAX side is the unchanged tool, loaded from its file with
``PROBE_POP=16`` and ``PROBE_POINTS=128`` in the environment (it reads
them when it is imported); its stripped kernels run here in interpret
mode.  The port's P5 takes its plain version for CPU tensors (the kernel
is held against it on the card, in ``tests/test_torch_kernels.py``).

Stated bound: bitwise (ulp bound 0), with the branches' ``top * scale +
const`` as one fused multiply-add (XLA contracts it) and ``stackrw``'s
read as ``fma(top, scale, row) + const``.  ``noswitch`` and ``dispatch``
equal the tool on every tree.  ``stackrw`` carries its stack from tree to
tree; the tool's carry runs over the whole grid (the TPU runs it in
order) from an uninitialised scratch (NaN in interpret mode), the port's
over the ``tb`` trees of a block from zero (blocks on the card run in no
order).  The two agree on a population that is one block whose first
token writes the stack before any token reads it, and the cases below pin
where they part.
"""

import importlib.util
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deap_tpu_torch import kernels
from deap_tpu_torch.probes import gp as pg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POP, NPTS, CAP = 16, 128, 64


@pytest.fixture(scope="module")
def pgp():
    with mock.patch.dict(os.environ, {"PROBE_POP": str(POP),
                                      "PROBE_POINTS": str(NPTS)}):
        spec = importlib.util.spec_from_file_location(
            "pallas_probe_gp_reference",
            ROOT / "tools" / "pallas_probe_gp.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert (mod.POP, mod.NPTS, mod.CAP) == (POP, NPTS, CAP)
    return mod


@pytest.fixture(scope="module")
def trees(pgp):
    jax_trees = pgp.full_binary_trees(pgp.bench_pset(),
                                      np.random.default_rng(0))
    port = pg.full_binary_trees(pg.bench_pset(), np.random.default_rng(0),
                                POP, CAP, "cpu")
    return [np.asarray(a) for a in jax_trees], port


def _jax(pgp, mode, tb, unroll, codes, consts, lengths):
    run = pgp.make_probe_kernel(mode, 9, tb, unroll)
    return np.asarray(run(jnp.asarray(codes), jnp.asarray(consts),
                          jnp.asarray(lengths), jnp.zeros((1, 1))))


def _port(mode, tb, unroll, codes, consts, lengths):
    run = pg.make_probe_kernel(mode, 9, tb, unroll, n_points=NPTS)
    return run(torch.as_tensor(codes), torch.as_tensor(consts),
               torch.as_tensor(lengths), torch.zeros((1, 1))).numpy()


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_full_binary_trees_give_the_tools_codes(trees):
    (jc, jk, jl), (c, k, ln) = trees
    assert c.dtype == torch.int32 and k.dtype == torch.float32
    assert np.array_equal(c.numpy(), jc)
    assert np.array_equal(_bits(k.numpy()), _bits(jk))
    assert np.array_equal(ln.numpy(), jl)
    assert (ln == pg.LEN).all() and (c[:, pg.LEN:] == 0).all()


@pytest.mark.parametrize("unroll", [False, 63], ids=["unroll1", "unroll63"])
@pytest.mark.parametrize("mode", ["noswitch", "dispatch"])
def test_stateless_modes_are_bitwise_on_every_tree(pgp, trees, mode,
                                                   unroll):
    _, (c, k, ln) = trees
    want = _jax(pgp, mode, 8, unroll, c.numpy(), k.numpy(), ln.numpy())
    got = _port(mode, 8, unroll, c, k, ln)
    assert got.shape == (POP, NPTS)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("unroll", [False, 63], ids=["unroll1", "unroll63"])
def test_stackrw_is_bitwise_on_one_block(pgp, trees, unroll):
    _, (c, k, ln) = trees
    assert int(c[0, pg.LEN - 1]) % 2 == 1       # the first token writes
    want = _jax(pgp, "stackrw", POP, unroll, c.numpy(), k.numpy(), ln.numpy())
    got = _port("stackrw", POP, unroll, c, k, ln)
    assert not np.isnan(want).any()
    assert np.array_equal(_bits(got), _bits(want))


def _short_programs(c, k, seed):
    """The trees with lengths drawn in [1, 63) and a few codes outside
    the nine branches (both sides clamp them)."""
    rng = np.random.default_rng(seed)
    c = c.clone()
    c[:, :8] = torch.as_tensor(rng.integers(-4, 14, (POP, 8)),
                               dtype=torch.int32)
    ln = torch.as_tensor(rng.integers(1, pg.LEN, POP), dtype=torch.int32)
    return c, k, ln


@pytest.mark.parametrize("unroll", [False, 63], ids=["unroll1", "unroll63"])
@pytest.mark.parametrize("mode", ["noswitch", "dispatch"])
def test_stateless_modes_are_bitwise_with_missing_trees_and_short_trees(
        pgp, trees, mode, unroll):
    """tb = 5: the last group holds one tree and four missing ones; the
    lengths lie below 63 (the unrolled loop runs 63 tokens on both
    sides)."""
    _, (c, k, _) = trees
    c, k, ln = _short_programs(c, k, 4)
    assert POP % 5 and (ln < pg.LEN).all()
    want = _jax(pgp, mode, 5, unroll, c.numpy(), k.numpy(), ln.numpy())
    got = _port(mode, 5, unroll, c, k, ln)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("unroll", [False, 63], ids=["unroll1", "unroll63"])
def test_stackrw_is_bitwise_on_one_group_with_missing_trees(pgp, trees,
                                                            unroll):
    """tb = 32: one group of the 16 trees and 16 missing ones, lengths
    below 63, the first token that runs a write."""
    _, (c, k, _) = trees
    c, k, ln = _short_programs(c, k, 5)
    first = pg.LEN - 1 if unroll else int(ln[0]) - 1
    c[0, first] = 7                              # the ephemeral: a write
    want = _jax(pgp, "stackrw", 32, unroll, c.numpy(), k.numpy(), ln.numpy())
    got = _port("stackrw", 32, unroll, c, k, ln)
    assert not np.isnan(want).any()
    assert np.array_equal(_bits(got), _bits(want))


def test_tool_stack_starts_uninitialised_and_the_ports_at_zero(pgp, trees):
    """A population whose first token reads the stack: interpret mode's
    scratch starts as NaN, the port's stack as zeros."""
    _, (c, k, ln) = trees
    c = c.clone()
    c[0, pg.LEN - 1] = 8                         # ARG0, an even code: a read
    want = _jax(pgp, "stackrw", POP, False, c.numpy(), k.numpy(), ln.numpy())
    got = _port("stackrw", POP, False, c, k, ln)
    assert np.isnan(want[0]).all()
    assert np.isfinite(got).all()


def test_stackrw_blocks_restart_their_stack(pgp, trees):
    """tb = 8: the first block equals the tool; a later block starts from
    zero where the tool carries the last block's row, so exactly the
    block starts whose first token reads differ; each block equals the
    port on its trees alone."""
    _, (c, k, ln) = trees
    tb = 8
    want = _jax(pgp, "stackrw", tb, False, c.numpy(), k.numpy(), ln.numpy())
    got = _port("stackrw", tb, False, c, k, ln)
    differ = {i for i in range(POP)
              if not np.array_equal(_bits(got[i]), _bits(want[i]))}
    reads_first = {s for s in range(tb, POP, tb)
                   if int(c[s, pg.LEN - 1]) % 2 == 0}
    assert differ == reads_first and differ
    for s in range(0, POP, tb):
        alone = _port("stackrw", tb, False, c[s:s + tb], k[s:s + tb],
                      ln[s:s + tb])
        assert np.array_equal(_bits(got[s:s + tb]), _bits(alone))


def test_probe_tool_runs_on_cpu(monkeypatch):
    monkeypatch.setenv("PROBE_POP", str(POP))
    monkeypatch.setenv("PROBE_POINTS", str(NPTS))
    monkeypatch.setenv("PROBE_ITERS", "1")
    out = pg.main(["noswitch", "stackrw", "real63", "dispatch_tb32",
                   "stackrw_unrollfull", "--device", "cpu"])
    assert out["platform"] == "cpu" and out["device"] == "cpu"
    assert out["shape"] == {"pop": POP, "cap": CAP, "points": NPTS,
                            "len": pg.LEN}
    pr = out["probes"]
    assert pr["dispatch_tb32"]["tb"] == 32
    assert pr["stackrw_unrollfull"]["unroll"] == pg.LEN
    assert pr["real63"]["route"] == "plain"
    assert out["fraction_of_floor"] == pytest.approx(
        pr["stackrw"]["ns_per_token"] / pr["real63"]["ns_per_token"])
    for r in pr.values():
        assert np.isfinite(r["eval_ms"]) and r["ns_per_token"] > 0


def test_probe_kernel_takes_the_plain_version_on_cpu_and_launcher_refuses(
        trees):
    _, (c, k, ln) = trees
    kernels.reset_launches()
    _port("dispatch", 8, False, c, k, ln)
    assert kernels.LAUNCHES["probe_gp"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_probe_gp(c, k, ln, n_points=NPTS, mode="stackrw",
                                tb=8, unroll=False, n_branches=9)
    with pytest.raises(ValueError, match="mode"):
        pg.make_probe_kernel("switch", 9, 8, False, n_points=NPTS)


def test_probe_bound_counts_the_stated_work(trees):
    _, (c, _, _) = trees
    tokens = POP * pg.LEN * NPTS
    reads = int(((c[:, :pg.LEN] & 1) == 0).sum()) * NPTS
    nbytes = 8 * POP * CAP + 4 * POP + 4 * POP * NPTS
    ops = pg.probe_bound("stackrw", c, NPTS)
    assert ops[0] == pytest.approx(max(
        nbytes / 3.35e12, (tokens + reads) / (67e12 / 2)) * 1e3)
    assert pg.probe_bound("dispatch", c, NPTS)[0] == pytest.approx(max(
        nbytes / 3.35e12, tokens / (67e12 / 2)) * 1e3)
