"""The port's remaining GA examples (``deap_tpu_torch/examples/ga/``:
onemax, onemax_short, knapsack, xkcd, sortingnetwork with evosn, and
mo_rhv) against the JAX package's (``examples/ga/``); their
``tests/test_examples.py`` checks are
``tests/test_torch_examples_rest_smoke.py``'s.

Each example runs in both packages from the same seed (at its published
depth, or a cut one where ``DEPTH`` names it), the JAX loop compiled as
published; the final population (genomes, fitness, validity), the
logbook and the hall of fame where the example keeps them, and its own
result must be equal bit for bit.  The sorting-network model's level
assignment, network run and assessment are held against the JAX
example's jitted functions on random networks, and the port's
``draw`` gives the JAX one's text.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

# the examples' depths here (the rest at their defaults)
DEPTH = {"ga.evosn": 12, "ga.mo_rhv": 40}


def _mods(name):
    return (importlib.import_module(f"examples.{name}"),
            importlib.import_module(f"deap_tpu_torch.examples.{name}"))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b):
    a, b = np.atleast_1d(_np(a)), np.atleast_1d(_np(b))
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _leaves(g):
    if isinstance(g, dict):
        return [g[k] for k in sorted(g)]
    return [g]


def _same_population(want, got):
    for a, b in zip(_leaves(want.genome), _leaves(got.genome)):
        _same(a, b)
    _same(want.fitness.values, got.fitness.values)
    _same(want.fitness.valid, got.fitness.valid)


def test_onemax_population_logbook_and_hall_of_fame():
    jm, tm = _mods("ga.onemax")
    jpop, jlog, jhof = jm.main(verbose=False)
    tpop, tlog, thof = tm.main(verbose=False, device="cpu")
    _same_population(jpop, tpop)
    assert len(jlog) == len(tlog) == jm.NGEN + 1
    for field in ("gen", "nevals", "avg", "std", "min", "max"):
        assert jlog.select(field) == tlog.select(field), field
    _same(jhof.state.genome, thof.state.genome)
    _same(jhof.state.values, thof.state.values)


def test_onemax_short():
    jm, tm = _mods("ga.onemax_short")
    _same_population(jm.main(), tm.main(verbose=False, device="cpu"))


@pytest.mark.parametrize("name", ["ga.knapsack", "ga.xkcd"])
def test_staircase_examples(name):
    jm, tm = _mods(name)
    _same_population(jm.main(verbose=False),
                     tm.main(verbose=False, device="cpu"))


def test_evosn_population_and_best():
    jm, tm = _mods("ga.evosn")
    kw = dict(pop_size=200, ngen=DEPTH["ga.evosn"])
    jpop, jbest = jm.main(verbose=False, **kw)
    tpop, tbest = tm.main(verbose=False, device="cpu", **kw)
    _same_population(jpop, tpop)
    _same(np.asarray(jbest), tbest)


def test_mo_rhv_population_and_hypervolume():
    jm, tm = _mods("ga.mo_rhv")
    jpop, jhv = jm.main(ngen=DEPTH["ga.mo_rhv"], verbose=False)
    tpop, thv = tm.main(ngen=DEPTH["ga.mo_rhv"], verbose=False,
                        device="cpu")
    _same_population(jpop, tpop)
    assert jhv == thv


def _networks(rng, n, cap, dim):
    wires = rng.integers(0, dim, (n, cap, 2)).astype(np.int32)
    lengths = rng.integers(0, cap + 1, n).astype(np.int32)
    return wires, lengths


@pytest.mark.parametrize("cap,dim", [(24, 6), (9, 4), (16, 8)])
def test_sortingnetwork_model_against_jax(cap, dim):
    """``assign_levels``, ``apply_network`` and ``assess`` on 32 random
    networks (random lengths from 0 to ``cap``, repeated wires for no-op
    connectors) against the JAX example's, jitted and vmapped."""
    jm, tm = _mods("ga.sortingnetwork")
    rng = np.random.default_rng(cap * dim)
    wires, lengths = _networks(rng, 32, cap, dim)
    cases = jm.all_binary_cases(dim)
    _same(cases, tm.all_binary_cases(dim))
    jl, jd = jax.jit(jax.vmap(lambda w, n: jm.assign_levels(w, n, cap, dim)))(
        wires, lengths)
    tl, td = tm.assign_levels(torch.from_numpy(wires),
                              torch.from_numpy(lengths), cap, dim)
    _same(jl, tl)
    _same(jd, td)
    jout = jax.jit(jax.vmap(lambda w, n: jm.apply_network(w, n, cases)))(
        wires, lengths)
    tcases = torch.from_numpy(np.array(cases))
    tout = tm.apply_network(torch.from_numpy(wires), torch.from_numpy(lengths),
                            tcases.expand(32, -1, -1))
    _same(jout, tout)
    jmiss = jax.jit(jax.vmap(lambda w, n: jm.assess(w, n, cases)))(
        wires, lengths)
    tmiss = tm.assess(torch.from_numpy(wires), torch.from_numpy(lengths),
                      tcases)
    np.testing.assert_array_equal(np.asarray(jmiss), tmiss.numpy())


def test_sortingnetwork_draw_against_jax():
    jm, tm = _mods("ga.sortingnetwork")
    rng = np.random.default_rng(7)
    for length in (1, 2, 5, 12):
        wires = rng.integers(0, 6, (12, 2)).astype(np.int32)
        assert tm.draw(wires, length, 6) == jm.draw(jnp.asarray(wires),
                                                    length, 6)
