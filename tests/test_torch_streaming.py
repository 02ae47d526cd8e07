"""``stream_every`` / ``stream_mode`` on the port's four loops
(``ea_simple``, ``ea_mu_plus_lambda``, ``ea_mu_comma_lambda``,
``ea_generate_update``) against the JAX package's, mirroring
``tests/test_algorithms.py``'s streaming tests.

The same run in both packages, with a ``stream_every`` that does not
divide ``ngen``: the lines the port prints are byte-equal to the lines
the JAX loop prints (``callback``: a line at every generation that
``stream_every`` divides; ``segmented``: those and one after the last
generation; ``auto`` is ``callback`` on both), and the port's
population, state and logbook are bit for bit those of its run with
``stream_every=0``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import algorithms as jalg, base as jbase, eda as jeda
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.utils.support import Statistics as JStatistics
from deap_tpu_torch import algorithms as talg, base as tbase, eda as teda
from deap_tpu_torch import random as tr
from deap_tpu_torch._xla_math import row_mean
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.ops._dispatch import batched_op
from deap_tpu_torch.utils.support import Statistics as TStatistics

torch.set_num_threads(1)

POP, DIM, NGEN, EVERY = 32, 16, 7, 3
LOOPS = ["ea_simple", "ea_mu_plus_lambda", "ea_mu_comma_lambda",
         "ea_generate_update"]


def _ones(g):
    return g.sum(-1).to(torch.float32),


batched_op(_ones, _ones)


def _toolboxes(loop):
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    if loop == "ea_generate_update":
        js = jeda.PBIL(ndim=DIM, learning_rate=0.3, mut_prob=0.1,
                       mut_shift=0.05, lambda_=POP, seed=3)
        ts = teda.PBIL(ndim=DIM, learning_rate=0.3, mut_prob=0.1,
                       mut_shift=0.05, lambda_=POP, seed=3, device="cpu")
        jtb.register("evaluate", lambda g: (jnp.sum(g),))
        jtb.register("generate", js.generate)
        jtb.register("update", js.update)
        ttb.register("evaluate", _ones)
        ttb.register("generate", ts.generate)
        ttb.register("update", ts.update)
        return jtb, ttb, js.init(), ts.init()
    jtb.register("evaluate", lambda g: jnp.sum(g).astype(jnp.float32))
    jtb.register("mate", jcx.cx_two_point)
    jtb.register("mutate", jmut.mut_flip_bit, indpb=0.05)
    jtb.register("select", jsel.sel_tournament, tournsize=3)
    ttb.register("evaluate", _ones)
    ttb.register("mate", tcx.cx_two_point)
    ttb.register("mutate", tmut.mut_flip_bit, indpb=0.05)
    ttb.register("select", tsel.sel_tournament, tournsize=3)
    return jtb, ttb, None, None


def _stats():
    js = JStatistics(lambda p: p.fitness.values[:, 0])
    js.register("max", jnp.max)
    js.register("mean", jnp.mean)
    ts = TStatistics(lambda p: p.fitness.values[:, 0])
    ts.register("max", torch.max)
    ts.register("mean", row_mean)
    return js, ts


def _run(loop, pkg, tb, state, stats, **kw):
    """One run of ``loop`` in ``pkg`` ("jax" or "torch"): ``(population,
    state or None, logbook)``."""
    alg = jalg if pkg == "jax" else talg
    key = jax.random.PRNGKey(11) if pkg == "jax" else tr.PRNGKey(
        11, device="cpu")
    if loop == "ea_generate_update":
        return alg.ea_generate_update(key, tb, state, ngen=NGEN,
                                      weights=(1.0,), stats=stats, **kw)
    bits = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(5), 0.5,
                                           (POP, DIM))).astype(np.int32)
    if pkg == "jax":
        pop = jbase.Population(jnp.asarray(bits),
                               jbase.Fitness.empty(POP, (1.0,)))
    else:
        pop = tbase.Population(torch.from_numpy(bits),
                               tbase.Fitness.empty(POP, (1.0,),
                                                   device="cpu"))
    if loop == "ea_simple":
        out = alg.ea_simple(key, pop, tb, 0.5, 0.2, ngen=NGEN, stats=stats,
                            **kw)
    else:
        lam = POP if loop == "ea_mu_plus_lambda" else 2 * POP
        out = getattr(alg, loop)(key, pop, tb, POP, lam, 0.5, 0.2,
                                 ngen=NGEN, stats=stats, **kw)
    return out[0], None, out[1]


def _lines(capfd):
    jax.effects_barrier()
    return [line for line in capfd.readouterr().out.splitlines()
            if line.startswith("gen=")]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_run(a, b):
    """Two port runs: population, state and logbook bit for bit."""
    pa, sa, la = a
    pb, sb, lb = b
    for x, y in ((pa.genome, pb.genome), (pa.fitness.values,
                                         pb.fitness.values)):
        assert np.array_equal(_np(x), _np(y))
    if sa is not None:
        assert np.array_equal(_np(sa.prob_vector), _np(sb.prob_vector))
    assert len(la) == len(lb)
    for ra, rb in zip(la, lb):
        assert ra == rb


@pytest.mark.parametrize("mode", ["callback", "segmented", "auto"])
@pytest.mark.parametrize("loop", LOOPS)
def test_stream_lines_equal_jax_and_trajectory_unchanged(loop, mode, capfd):
    jtb, ttb, jstate, tstate = _toolboxes(loop)
    jstats, tstats = _stats()
    capfd.readouterr()
    _run(loop, "jax", jtb, jstate, jstats, stream_every=EVERY,
         stream_mode=mode)
    want = _lines(capfd)
    got_run = _run(loop, "torch", ttb, tstate, tstats, stream_every=EVERY,
                   stream_mode=mode)
    got = _lines(capfd)
    gens = [3, 6, 7] if mode == "segmented" else [3, 6]
    assert [line.split("\t")[0] for line in got] == [f"gen={g}"
                                                     for g in gens]
    assert got == want
    plain = _run(loop, "torch", ttb, tstate, tstats)
    assert _lines(capfd) == []
    _same_run(got_run, plain)


def test_stream_every_generation_in_order(capfd):
    """``stream_every=1``: a line a generation, in order, as the JAX
    package's ordered callback gives them."""
    jtb, ttb, _, _ = _toolboxes("ea_simple")
    jstats, tstats = _stats()
    capfd.readouterr()
    _run("ea_simple", "jax", jtb, None, jstats, stream_every=1,
         stream_mode="callback")
    want = _lines(capfd)
    _run("ea_simple", "torch", ttb, None, tstats, stream_every=1,
         stream_mode="callback")
    got = _lines(capfd)
    assert [int(line.split("\t")[0][4:]) for line in got] == list(
        range(1, NGEN + 1))
    assert got == want


def test_unknown_stream_mode_raises_as_jax():
    jtb, ttb, _, _ = _toolboxes("ea_simple")
    with pytest.raises(ValueError) as jerr:
        _run("ea_simple", "jax", jtb, None, None, stream_every=2,
             stream_mode="bogus")
    with pytest.raises(ValueError) as terr:
        _run("ea_simple", "torch", ttb, None, None, stream_every=2,
             stream_mode="bogus")
    assert str(terr.value) == str(jerr.value)
    # no stream_every: the mode is not read, as in the JAX package
    _run("ea_simple", "torch", ttb, None, None, stream_mode="bogus")
