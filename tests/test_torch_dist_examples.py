"""The port's three distributed examples against the JAX package's, at
the published sizes: ``onemax_sharded`` (4096 x 100, 40 generations) at
R = 2 and 4 gloo ranks, ``onemax_island`` as published (one process)
and in its ``mesh=`` form at R = 5 ranks (one island a rank), and
``onemax_multihost`` launched as R = 2 processes with the
``DEAP_TPU_*`` variables.  Genomes and fitness are compared bit for
bit with JAX on an R-device sub-mesh of the 8 virtual CPU devices (the
island run on a 5-device one) and with the port's single-device run."""

import importlib
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import base as tbase
from deap_tpu_torch import random as trandom
from deap_tpu_torch.parallel import launch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = str(ROOT / "tests")
SHARDED_N, SHARDED_GEN = 4096, 40


def _jmesh(R, axis):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:R]), (axis,))


def _bits(x):
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _run(target, R, tmp_path, **kwargs):
    return launch.run_ranks(target, R, kwargs=kwargs, env=dict(
        os.environ, PYTHONPATH=TESTS), timeout=60, deadline=240, threads=2,
        workdir=tmp_path / f"{target.split(':')[1]}{R}")


@pytest.fixture(scope="module")
def sharded_single():
    """The port's single-device run of the example's population."""
    from deap_tpu_torch.examples.ga import onemax_sharded as tm
    key = trandom.PRNGKey(0, device="cpu")
    key, k_init = trandom.split(key)
    g = trandom.bernoulli(k_init, 0.5, (SHARDED_N, 100)).to(torch.float32)
    pop = tbase.Population(g, tbase.Fitness.empty(SHARDED_N, (1.0,),
                                                  device="cpu"))
    final, _ = talg.ea_simple(key, pop, tm.toolbox(), 0.5, 0.2, SHARDED_GEN)
    return final


@pytest.mark.parametrize("R", (2, 4))
def test_onemax_sharded(R, tmp_path, monkeypatch, sharded_single):
    jm = importlib.import_module("examples.ga.onemax_sharded")
    monkeypatch.setattr(jm, "default_mesh", lambda axis: _jmesh(R, axis))
    jpop = jm.main(seed=0, pop_size=SHARDED_N, ngen=SHARDED_GEN)
    assert np.array_equal(_bits(sharded_single.genome), _bits(jpop.genome))
    assert np.array_equal(_bits(sharded_single.fitness.values),
                          _bits(jpop.fitness.values))
    for genome, values in _run("_torch_dist_cases:sharded_example", R,
                               tmp_path, ngen=SHARDED_GEN,
                               pop_size=SHARDED_N):
        assert torch.equal(genome, sharded_single.genome)
        assert torch.equal(values, sharded_single.fitness.values)


def test_onemax_island_as_published():
    jm = importlib.import_module("examples.ga.onemax_island")
    from deap_tpu_torch.examples.ga import onemax_island as tm
    jpops = jm.main(seed=0)
    pops = tm.main(seed=0, device="cpu")
    assert np.array_equal(_bits(pops.genome), _bits(jpops.genome))
    assert np.array_equal(_bits(pops.fitness.values),
                          _bits(jpops.fitness.values))


def test_onemax_island_mesh_form_at_five_ranks(tmp_path):
    jm = importlib.import_module("examples.ga.onemax_island")
    from deap_tpu_torch.examples.ga import onemax_island as tm
    jpops = jm.main(seed=0, mesh=_jmesh(5, "island"))
    single = tm.main(seed=0, device="cpu", verbose=False)
    assert np.array_equal(_bits(single.genome), _bits(jpops.genome))
    for genome, values in _run("_torch_dist_cases:island_example", 5,
                               tmp_path, ngen=tm.NGEN):
        assert torch.equal(genome, single.genome)
        assert torch.equal(values, single.fitness.values)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_multihost(R, ngen, per):
    """JAX's ``ea_simple`` on the global population the JAX example
    builds: R blocks under ``fold_in(PRNGKey(11), p)``."""
    import jax
    import jax.numpy as jnp
    jm = importlib.import_module("examples.ga.onemax_multihost")
    from deap_tpu import algorithms, base
    from deap_tpu.ops import crossover, mutation, selection
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (jnp.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    key = jax.random.PRNGKey(11)
    g = jnp.concatenate([jax.random.bernoulli(
        jax.random.fold_in(key, p), 0.5, (per, jm.NBITS)).astype(
        jnp.float32) for p in range(R)])
    pop = base.Population(g, base.Fitness.empty(R * per, (1.0,)))
    return algorithms.ea_simple(key, pop, tb, cxpb=0.5, mutpb=0.2,
                                ngen=ngen)[0]


def test_onemax_multihost_two_processes(tmp_path):
    """Two processes joined by ``DEAP_TPU_COORDINATOR`` (rank 1 by the
    legacy set, as ``tests/test_multihost.py`` does): the global
    population is the two folded-in blocks, and the run equals the
    single-process ``ea_simple`` on it (the port's and JAX's)."""
    from deap_tpu_torch.examples.ga import onemax_multihost as tm
    R, ngen, per = 2, tm.NGEN, tm.POP_PER_PROCESS
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith(("XLA_", "JAX_", "DEAP_TPU_"))
                and k not in ("NPROC", "PROC_ID")}
    env_base.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = tmp_path / "final.pt"
    procs = []
    for pid in range(R):
        if pid == 0:
            env = dict(env_base, DEAP_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DEAP_TPU_NPROC=str(R), DEAP_TPU_PROC_ID=str(pid))
        else:
            env = dict(env_base, JAX_COORDINATOR=f"127.0.0.1:{port}",
                       NPROC=str(R), PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deap_tpu_torch.examples.ga."
             "onemax_multihost", "--device", "cpu", "--out", str(out)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the multihost example's processes timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert f"processes={R} global_pop={R * per}" in logs[0]
    got = torch.load(out, weights_only=False)

    key = trandom.PRNGKey(11, device="cpu")
    g = torch.cat([trandom.bernoulli(trandom.fold_in(key, p), 0.5,
                                     (per, tm.NBITS)).to(torch.float32)
                   for p in range(R)])
    pop = tbase.Population(g, tbase.Fitness.empty(R * per, (1.0,),
                                                  device="cpu"))
    single, _ = talg.ea_simple(key, pop, tm.toolbox(), 0.5, 0.2, ngen)
    assert torch.equal(got["genome"], single.genome)
    assert torch.equal(got["values"], single.fitness.values)
    assert got["best"] == float(single.fitness.values.max())
    jout = _jax_multihost(R, ngen, per)
    assert np.array_equal(_bits(got["genome"]), _bits(jout.genome))
    assert np.array_equal(_bits(got["values"]), _bits(jout.fitness.values))
