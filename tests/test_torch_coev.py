"""The port's co-evolution loops against the JAX package's on the CPU.

``ea_cooperative`` and ``ea_host_parasite`` run in both packages from
the same numpy-seeded populations and keys (the JAX loops are scanned
and compiled); the species, the representatives, hosts and parasites,
their fitness and the logbooks must be equal bit for bit.  The
encounter and the collaboration count are exact in float32, so no
tolerance is needed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, coev as jcoev
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.utils.support import Statistics as JStats
from deap_tpu_torch import base as tbase, coev as tcoev, interop
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.ops._dispatch import batched_op
from deap_tpu_torch.utils.support import Statistics as TStats

torch.set_num_threads(1)


def _tk(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


def _same(a, b):
    a = np.atleast_1d(np.asarray(a))
    b = np.atleast_1d(b.numpy() if torch.is_tensor(b) else np.asarray(b))
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _toolboxes(mutate="flip"):
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    jtb.register("mate", jcx.cx_two_point)
    ttb.register("mate", tcx.cx_two_point)
    if mutate == "flip":
        jtb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
        ttb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    else:
        jtb.register("mutate", jmut.mut_uniform_int, low=0, up=4, indpb=0.1)
        ttb.register("mutate", tmut.mut_uniform_int, low=0, up=4, indpb=0.1)
    jtb.register("select", jsel.sel_tournament, tournsize=3)
    ttb.register("select", tsel.sel_tournament, tournsize=3)
    return jtb, ttb


def _stats():
    js = JStats(lambda p: p.fitness.values[:, 0])
    ts = TStats(lambda p: p.fitness.values[:, 0])
    js.register("max", jnp.max)
    ts.register("max", torch.max)
    return js, ts


def _weighted_ones(collab):
    """A weighted count: species ``i``'s ones count ``i + 1`` times."""
    w = jnp.arange(1, collab.shape[0] + 1, dtype=jnp.float32)[:, None]
    return jnp.sum(collab * w),


def _weighted_ones_rows(collab):
    w = torch.arange(1, collab.shape[1] + 1, dtype=torch.float32)[:, None]
    return (collab * w).sum((-2, -1)),


def _weighted_ones_one(collab):
    return _weighted_ones_rows(collab[None])[0][0],


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("nspecies,pop,bits", [(3, 16, 10), (4, 24, 8)])
def test_ea_cooperative_against_jax(nspecies, pop, bits, batched):
    rng = np.random.default_rng(nspecies)
    g = (rng.uniform(size=(nspecies, pop, bits)) < 0.5).astype(np.float32)
    jtb, ttb = _toolboxes()
    jtb.register("evaluate", _weighted_ones)
    fn = _weighted_ones_one
    if batched:
        def fn(collab):                          # noqa: F811
            return _weighted_ones_one(collab)
        batched_op(fn, _weighted_ones_rows)
    ttb.register("evaluate", fn)
    js, ts = _stats()
    key = jax.random.PRNGKey(20 + nspecies)
    jsp = jbase.Population(jnp.asarray(g), jbase.Fitness(
        jnp.zeros((nspecies, pop, 1)), jnp.zeros((nspecies, pop), bool),
        (1.0,)))
    tsp = tbase.Population(torch.from_numpy(g), tbase.Fitness(
        torch.zeros(nspecies, pop, 1),
        torch.zeros(nspecies, pop, dtype=torch.bool), (1.0,)))
    want, wreps, wlog = jcoev.ea_cooperative(key, jsp, jtb, 0.6, 0.3, 5,
                                             stats=js)
    got, treps, tlog = tcoev.ea_cooperative(_tk(key), tsp, ttb, 0.6, 0.3, 5,
                                            stats=ts)
    assert _same(want.genome, got.genome)
    assert _same(want.fitness.values, got.fitness.values)
    assert _same(want.fitness.valid, got.fitness.valid)
    assert _same(wreps, treps)
    assert tlog.header == wlog.header
    assert tlog.select("max") == [float(v) for v in wlog.select("max")]


def _encounter_jax(host, parasite):
    """How many of the parasite's values the host's values miss."""
    return jnp.sum(jnp.abs(host[:, None] - parasite[None, :]).min(0) > 0.5
                   ).astype(jnp.float32)


def _encounter_rows(hosts, parasites):
    d = (hosts[:, :, None] - parasites[:, None, :]).abs().amin(1)
    return (d > 0.5).sum(-1).to(torch.float32)


def _encounter_one(host, parasite):
    return _encounter_rows(host[None], parasite[None])[0]


@pytest.mark.parametrize("batched", [True, False])
def test_ea_host_parasite_against_jax(batched):
    rng = np.random.default_rng(5)
    hosts = rng.integers(0, 5, (20, 12)).astype(np.int32)
    paras = rng.integers(0, 5, (20, 6)).astype(np.float32)
    jh, th = _toolboxes("int")
    jp, tp = _toolboxes("flip")
    js, ts = _stats()
    enc = _encounter_one
    if batched:
        def enc(h, p):                           # noqa: F811
            return _encounter_one(h, p)
        batched_op(enc, _encounter_rows)
    key = jax.random.PRNGKey(21)
    wh, wp, wlog = jcoev.ea_host_parasite(
        key, jbase.Population(jnp.asarray(hosts), jbase.Fitness.empty(
            20, (-1.0,))),
        jbase.Population(jnp.asarray(paras), jbase.Fitness.empty(20, (1.0,))),
        jh, jp, _encounter_jax, 0.6, 0.3, 6, stats=js)
    gh, gp, tlog = tcoev.ea_host_parasite(
        _tk(key), tbase.Population(torch.from_numpy(hosts),
                                   tbase.Fitness.empty(20, (-1.0,),
                                                       device="cpu")),
        tbase.Population(torch.from_numpy(paras),
                         tbase.Fitness.empty(20, (1.0,), device="cpu")),
        th, tp, enc, 0.6, 0.3, 6, stats=ts)
    for a, b in ((wh, gh), (wp, gp)):
        assert _same(a.genome, b.genome)
        assert _same(a.fitness.values, b.fitness.values)
    assert tlog.header == wlog.header
    assert tlog.select("nevals") == [int(v) for v in wlog.select("nevals")]
    assert tlog.select("max") == [float(v) for v in wlog.select("max")]


def test_host_parasite_sizes_must_match():
    pop = tbase.Population(torch.zeros(4, 2), tbase.Fitness.empty(
        4, (1.0,), device="cpu"))
    other = tbase.Population(torch.zeros(5, 2), tbase.Fitness.empty(
        5, (1.0,), device="cpu"))
    tb = tbase.Toolbox()
    with pytest.raises(ValueError, match="equal size"):
        tcoev.ea_host_parasite(_tk(jax.random.PRNGKey(0)), pop, other, tb,
                               tb, _encounter_one, 0.5, 0.5, 1)


def test_cooperative_verbose_prints_the_stream(capsys):
    rng = np.random.default_rng(1)
    g = (rng.uniform(size=(2, 8, 6)) < 0.5).astype(np.float32)
    _, ttb = _toolboxes()
    ttb.register("evaluate", _weighted_ones_one)
    _, ts = _stats()
    tcoev.ea_cooperative(_tk(jax.random.PRNGKey(2)), tbase.Population(
        torch.from_numpy(g), tbase.Fitness(torch.zeros(2, 8, 1),
                                           torch.zeros(2, 8,
                                                       dtype=torch.bool),
                                           (1.0,))),
        ttb, 0.5, 0.2, 3, stats=ts, verbose=True)
    out = capsys.readouterr().out
    assert "gen" in out and "max" in out and len(out.splitlines()) == 4
