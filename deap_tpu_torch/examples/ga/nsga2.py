"""NSGA-II on ZDT1 — the port's counterpart of ``examples/ga/nsga2.py``:
bounded SBX crossover, polynomial mutation, the dominance/crowding
tournament for the mating pool and NSGA-II environmental selection.

A generation splits its key five ways (next, mating, crossover,
mutation, selection), draws the mating pool with
:func:`~deap_tpu_torch.ops.emo.sel_tournament_dcd`, crosses pairs
``(2i, 2i + 1)`` under ``split(k_cx, mu // 2)`` and mutates every row
under ``split(k_mut, mu)`` — a key a pair or a row, as the JAX example's
``jax.vmap`` over per-row keys, through the operators' key-batch form —
then evaluates the offspring and keeps ``sel_nsga2`` of the
(mu + mu) pool.

Quality gate (reference ``deap/tests/test_algorithms.py:32,110-113``):
hypervolume at the reference point (11, 11) > 116 after 100
generations.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import base, benchmarks, random
from ...algorithms import evaluate_population
from ...benchmarks import tools as btools
from ...ops import crossover, emo, mutation

MU, NGEN, NDIM = 64, 100, 30
LOW, UP = 0.0, 1.0


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.zdt1)
    tb.register("mate", crossover.cx_simulated_binary_bounded,
                eta=20.0, low=LOW, up=UP)
    tb.register("mutate", mutation.mut_polynomial_bounded,
                eta=20.0, low=LOW, up=UP, indpb=1.0 / NDIM)
    return tb


def vary(tb, k_cx, k_mut, genome):
    """SBX on pairs ``(2i, 2i + 1)`` under ``split(k_cx, n // 2)``, then
    polynomial mutation of every row under ``split(k_mut, n)``; the
    children of a pair stay adjacent."""
    n, ndim = genome.shape
    ca, cb = tb.mate(random.split(k_cx, n // 2), genome[0::2], genome[1::2])
    child = torch.stack([ca, cb], 1).reshape(n, ndim)
    return tb.mutate(random.split(k_mut, n), child)


def generation(tb, key, pop):
    """One generation of the example: ``(key, population)`` in and out."""
    mu = pop.size
    key, k_mate, k_cx, k_mut, k_sel = random.split(key, 5)
    off = pop.take(emo.sel_tournament_dcd(k_mate, pop.fitness, mu))
    child = vary(tb, k_cx, k_mut, off.genome)
    off = base.Population(child, base.Fitness.empty(
        mu, (-1.0, -1.0), device=child.device))
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(emo.sel_nsga2(k_sel, pool.fitness, mu))


def initial(tb, key, mu: int = MU):
    """``(key, population)`` before the first generation: the example's
    key split and uniform genomes in ``[LOW, UP)``, evaluated."""
    key, k_init = random.split(key)
    genome = random.uniform(k_init, (mu, NDIM), minval=LOW, maxval=UP)
    pop = base.Population(genome, base.Fitness.empty(
        mu, (-1.0, -1.0), device=genome.device))
    return key, evaluate_population(tb, pop)[0]


def main(seed=1, mu=MU, ngen=NGEN, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns ``(population, hypervolume)``."""
    tb = toolbox()
    key, pop = initial(tb, random.PRNGKey(seed, device=device), mu)
    for _ in range(ngen):
        key, pop = generation(tb, key, pop)
    hv = btools.hypervolume(pop.fitness, ref=np.array([11.0, 11.0]))
    if verbose:
        print(f"final hypervolume {hv:.3f} (ZDT1 optimum ≈ 120.777, "
              f"gate > 116)")
    return pop, hv


if __name__ == "__main__":
    main()
