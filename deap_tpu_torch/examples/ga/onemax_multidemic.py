"""Multi-demic OneMax — the port's counterpart of
``examples/ga/onemax_multidemic.py``: three demes with different
variation pressure evolving side by side, with ring migration of each
deme's five best every ``MIG_FREQ`` generations.

The demes are a leading axis of one population.  JAX vmaps the deme
step over ``split(k_gen, N_DEMES)`` with each deme's ``cxpb``/``mutpb``;
here a loop over the demes takes the same keys."""

from __future__ import annotations

import torch

from ... import base, random
from ...algorithms import evaluate_population, var_and
from ...ops import crossover, mutation, selection
from ...ops.migration import mig_ring_stacked
from ...ops.selection import sel_best

N_DEMES, POP, N_BITS, NGEN, MIG_FREQ = 3, 50, 100, 40, 5
CXPBS = (0.4, 0.5, 0.6)
MUTPBS = (0.05, 0.1, 0.2)


def onemax(g):
    return g.sum(-1),


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", onemax)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def _deme(pops, i):
    f = pops.fitness
    return base.Population(pops.genome[i], base.Fitness(
        f.values[i], f.valid[i], f.weights))


def _stack(demes):
    return base.Population(
        torch.stack([d.genome for d in demes]),
        base.Fitness(torch.stack([d.fitness.values for d in demes]),
                     torch.stack([d.fitness.valid for d in demes]),
                     demes[0].fitness.weights))


def island_gen(tb, key, pop, cxpb, mutpb):
    k_sel, k_var = random.split(key)
    off = pop.take(tb.select(k_sel, pop.fitness, pop.size))
    off = var_and(k_var, off, tb, cxpb, mutpb)
    return evaluate_population(tb, off)[0]


def migrate(key, pops):
    bundle = dict(genome=pops.genome, values=pops.fitness.values,
                  valid=pops.fitness.valid)
    w = torch.stack([_deme(pops, i).fitness.masked_wvalues()
                     for i in range(N_DEMES)])
    new, _ = mig_ring_stacked(key, bundle, w, 5, sel_best)
    return base.Population(new["genome"], base.Fitness(
        new["values"], new["valid"], (1.0,)))


def initial(seed, device=None):
    """``(key, demes)``: bits drawn at ``(N_DEMES, POP, N_BITS)``."""
    key = random.PRNGKey(seed, device=device)
    key, k_init = random.split(key)
    genome = random.bernoulli(k_init, 0.5, (N_DEMES, POP, N_BITS)).to(
        torch.float32)
    dev = key.device
    return key, base.Population(genome, base.Fitness(
        torch.zeros((N_DEMES, POP, 1), device=dev),
        torch.zeros((N_DEMES, POP), dtype=torch.bool, device=dev), (1.0,)))


def generation(tb, key, pops, gen):
    """One generation ``gen`` (from 1): the demes' steps, then migration
    when ``gen % MIG_FREQ == 0``.  Returns ``(key, demes)``."""
    ks = random.split(key, 3)
    key, k_gen, k_mig = ks[0], ks[1], ks[2]
    keys = random.split(k_gen, N_DEMES)
    pops = _stack([island_gen(tb, keys[i], _deme(pops, i), CXPBS[i],
                              MUTPBS[i]) for i in range(N_DEMES)])
    if gen % MIG_FREQ == 0:
        pops = migrate(k_mig, pops)
    return key, pops


def main(seed=0, ngen=NGEN, verbose=True, device=None):
    """Returns the final demes (a population stacked on the deme axis)."""
    tb = toolbox()
    key, pops = initial(seed, device)
    pops = _stack([evaluate_population(tb, _deme(pops, i))[0]
                   for i in range(N_DEMES)])
    for gen in range(1, ngen + 1):
        key, pops = generation(tb, key, pops, gen)
    if verbose:
        print("per-deme best (last gen):",
              pops.fitness.values.amax(1)[:, 0].tolist())
    return pops


if __name__ == "__main__":
    main()
