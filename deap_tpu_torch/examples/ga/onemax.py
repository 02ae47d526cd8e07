"""OneMax, the canonical GA — the port's counterpart of
``examples/ga/onemax.py`` (reference ``examples/ga/onemax.py`` and its
README): maximise the ones of a 100-bit string, with statistics and a
hall of fame, 300 individuals for 40 generations through
``ea_simple``.  The statistics are XLA's float32 forms (the mean as
:func:`~deap_tpu_torch._xla_math.row_mean`, :func:`std` below), so the
logbook equals the JAX example's."""

from __future__ import annotations

import numpy as np
import torch

from ... import algorithms, base, random
from ..._xla_math import row_mean
from ...ops import crossover, mutation, selection
from ...utils.support import HallOfFame, Statistics

POP, N_BITS, NGEN = 300, 100, 40


def onemax(g):
    return g.sum(-1),


def std(x):
    """``jnp.std`` over the last axis: the root of the mean squared
    distance to the mean, each mean :func:`row_mean`."""
    c = x - row_mean(x)[..., None]
    return torch.sqrt(row_mean(c * c))


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", onemax)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def initial(seed, n=POP, device=None):
    """``(key, population)``: the example's key split and random bits."""
    key = random.PRNGKey(seed, device=device)
    key, k_init = random.split(key)
    genome = random.bernoulli(k_init, 0.5, (n, N_BITS)).to(torch.float32)
    return key, base.Population(genome, base.Fitness.empty(
        n, (1.0,), device=genome.device))


def statistics():
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("avg", row_mean)
    stats.register("std", std)
    stats.register("min", torch.min)
    stats.register("max", torch.max)
    return stats


def main(seed=42, verbose=True, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns ``(population, logbook, hall of
    fame)``."""
    key, pop = initial(seed, device=device)
    hof = HallOfFame(1)
    pop, logbook = algorithms.ea_simple(
        key, pop, toolbox(), cxpb=0.5, mutpb=0.2, ngen=ngen,
        stats=statistics(), halloffame=hof, verbose=verbose)
    best = float(np.max(pop.fitness.values.cpu().numpy()))
    if verbose:
        print(f"Best individual has fitness {best}")
    return pop, logbook, hof


if __name__ == "__main__":
    main()
