"""Kursawe's function with a simple multi-objective GA — the port's
counterpart of ``examples/ga/kursawefct.py``: blend crossover and
Gaussian mutation, both decorated to clip their outputs into [-5, 5]
(``toolbox.decorate``, the reference's checkBounds), ``var_and`` and
NSGA-II selection of the (mu + mu) pool.  The decorated operators lose
their batched forms, so ``var_and`` calls them one row at a time under
``split`` keys, as the JAX package's vmap over the wrapper."""

from __future__ import annotations

import torch

from ... import base, benchmarks, random
from ...algorithms import evaluate_population, var_and
from ...ops import crossover, emo, mutation

NDIM, MU, NGEN = 3, 64, 50
BOUND = 5.0


def check_bounds(op):
    """Clip an operator's outputs into ``[-BOUND, BOUND]``."""
    def wrapped(key, *args, **kw):
        out = op(key, *args, **kw)
        if isinstance(out, tuple):
            return tuple(torch.clamp(o, -BOUND, BOUND) for o in out)
        return torch.clamp(out, -BOUND, BOUND)
    return wrapped


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.kursawe)
    tb.register("mate", crossover.cx_blend, alpha=1.5)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=3.0,
                indpb=0.3)
    tb.decorate("mate", check_bounds)
    tb.decorate("mutate", check_bounds)
    return tb


def generation(tb, key, pop):
    """One generation: ``(key, population)`` in and out."""
    key, k_var, k_sel = random.split(key, 3)
    off = var_and(k_var, pop, tb, cxpb=0.5, mutpb=0.3)
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(emo.sel_nsga2(k_sel, pool.fitness, MU))


def initial(tb, key):
    """``(key, evaluated population)`` before the first generation."""
    key, k_init = random.split(key)
    genome = random.uniform(k_init, (MU, NDIM), minval=-BOUND, maxval=BOUND)
    pop = base.Population(genome, base.Fitness.empty(MU, (-1.0, -1.0),
                                                     device=key.device))
    return key, evaluate_population(tb, pop)[0]


def main(seed=5, verbose=True, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)``; returns the final
    population."""
    tb = toolbox()
    key, pop = initial(tb, random.PRNGKey(seed, device=device))
    for _ in range(ngen):
        key, pop = generation(tb, key, pop)
    in_bounds = bool((pop.genome.abs() <= BOUND).all())
    if verbose:
        print("front size:", pop.size, "all in bounds:", in_bounds)
    assert in_bounds
    return pop


if __name__ == "__main__":
    main()
