"""NSGA-III on DTLZ2 — the port's counterpart of ``examples/ga/nsga3.py``:
Das–Dennis reference points (3 objectives, 12 divisions, 91 points) and
niche-preserving selection, a random mating pool
(:func:`~deap_tpu_torch.random.permutation`), bounded SBX (eta 30) on
pairs and polynomial mutation (eta 20), a key a pair or a row as in
:mod:`deap_tpu_torch.examples.ga.nsga2`.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import base, benchmarks, random
from ...algorithms import evaluate_population
from ...ops import crossover, emo, mutation
from .nsga2 import vary

NOBJ, P = 3, 12
NDIM = NOBJ + 4
LOW, UP = 0.0, 1.0


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.dtlz2, obj=NOBJ)
    tb.register("mate", crossover.cx_simulated_binary_bounded,
                eta=30.0, low=LOW, up=UP)
    tb.register("mutate", mutation.mut_polynomial_bounded,
                eta=20.0, low=LOW, up=UP, indpb=1.0 / NDIM)
    return tb


def population_size(ref_points) -> int:
    """The population: the reference points rounded up to a multiple of
    four (92 for 91)."""
    return int(np.ceil(len(ref_points) / 4) * 4)


def generation(tb, key, pop, ref_points):
    """One generation of the example: ``(key, population)`` in and out."""
    mu = pop.size
    key, k_sel, k_cx, k_mut, k_env = random.split(key, 5)
    off = pop.take(random.permutation(k_sel, mu).long())
    child = vary(tb, k_cx, k_mut, off.genome)
    off = base.Population(child, base.Fitness.empty(
        mu, pop.fitness.weights, device=child.device))
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(emo.sel_nsga3(k_env, pool.fitness, mu,
                                        ref_points))


def initial(tb, key, mu: int):
    key, k_init = random.split(key)
    genome = random.uniform(k_init, (mu, NDIM), minval=LOW, maxval=UP)
    pop = base.Population(genome, base.Fitness.empty(
        mu, (-1.0,) * NOBJ, device=genome.device))
    return key, evaluate_population(tb, pop)[0]


def front_error(values: torch.Tensor) -> float:
    """Mean ``|sum f_i^2 - 1|`` over the population (0 on the true
    front), on the host in float32 as the JAX example reads it."""
    f = values.cpu().numpy()
    return float(np.mean(np.abs(np.sum(f ** 2, axis=1) - 1.0)))


def main(seed=1, ngen=100, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns ``(population, front error)``."""
    ref_points = emo.uniform_reference_points(NOBJ, P)
    mu = population_size(ref_points)
    tb = toolbox()
    key, pop = initial(tb, random.PRNGKey(seed, device=device), mu)
    for _ in range(ngen):
        key, pop = generation(tb, key, pop, ref_points)
    err = front_error(pop.fitness.values)
    if verbose:
        print(f"mean |Σf²-1| on final pop: {err:.4f} (0 on the true "
              "front)")
    return pop, err


if __name__ == "__main__":
    main()
