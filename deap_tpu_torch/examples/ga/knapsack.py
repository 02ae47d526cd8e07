"""Multi-objective 0/1 knapsack — the port's counterpart of
``examples/ga/knapsack.py`` (reference ``examples/ga/knapsack.py``): a
bag is the indicator mask of its items; crossover is the intersection
and the symmetric difference, mutation adds or removes one random item;
minimise the weight and maximise the value under NSGA-II selection
(the 2-objective staircase ranks)."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ..._xla_math import row_sum
from ...algorithms import evaluate_population, var_and
from ...ops import emo
from ...ops._dispatch import batched_op, rowwise_op

N_ITEMS, MU, NGEN = 20, 50, 50
MAX_ITEM, MAX_WEIGHT = 5, 50


def items(device=None):
    """``(weights, values)`` of the items, from ``RandomState(64)``."""
    rng = np.random.RandomState(64)
    w = rng.randint(1, 10, N_ITEMS).astype(np.float32)
    v = rng.uniform(0, 100, N_ITEMS).astype(np.float32)
    return (torch.tensor(w, device=device), torch.tensor(v, device=device))


def make_evaluate(weights, values):
    """``evaluate(mask) -> (weight, value)`` over a leading row axis: a
    bag over ``MAX_WEIGHT`` or ``MAX_ITEM`` scores ``(1e4, 0)``."""
    def evaluate(mask):
        w = row_sum(mask * weights)
        v = row_sum(mask * values)
        bad = (w > MAX_WEIGHT) | (mask.sum(-1) > MAX_ITEM)
        return (torch.where(bad, 1e4, w), torch.where(bad, 0.0, v))
    return batched_op(evaluate, evaluate)


def cx_set(key, a, b):
    """Reference cxSet: the intersection and the symmetric difference."""
    return a * b, (a - b).abs()


batched_op(cx_set, cx_set)


@rowwise_op
def mut_set(keys, mask):
    """Reference mutSet: set one random item in or out, a key a row."""
    ks = random.split(keys)
    i = random.randint(ks[:, 1], (), 0, N_ITEMS).long()
    add = random.bernoulli(ks[:, 0])
    out = mask.clone()
    out[torch.arange(mask.shape[0], device=mask.device), i] = \
        add.to(mask.dtype)
    return out


def toolbox(device=None):
    tb = base.Toolbox()
    tb.register("evaluate", make_evaluate(*items(device)))
    tb.register("mate", cx_set)
    tb.register("mutate", mut_set)
    return tb


def generation(tb, key, pop):
    """One generation: ``(key, population)`` in and out."""
    key, k_var, k_sel = random.split(key, 3)
    off = var_and(k_var, pop, tb, cxpb=0.3, mutpb=0.2)
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(emo.sel_nsga2(k_sel, pool.fitness, MU))


def main(seed=2, verbose=True, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the final population."""
    key = random.PRNGKey(seed, device=device)
    tb = toolbox(key.device)
    key, k_init = random.split(key)
    genome = (random.uniform(k_init, (MU, N_ITEMS)) < 0.25).to(torch.float32)
    pop = base.Population(genome, base.Fitness.empty(
        MU, (-1.0, 1.0), device=genome.device))
    pop, _ = evaluate_population(tb, pop)
    for _ in range(ngen):
        key, pop = generation(tb, key, pop)
    if verbose:
        vals = pop.fitness.values.cpu().numpy()
        feasible = vals[:, 0] <= MAX_WEIGHT
        print(f"feasible: {feasible.sum()}/{MU}; "
              f"best value {vals[feasible, 1].max():.1f} at weight "
              f"{vals[feasible][np.argmax(vals[feasible, 1]), 0]:.0f}")
    return pop


if __name__ == "__main__":
    main()
