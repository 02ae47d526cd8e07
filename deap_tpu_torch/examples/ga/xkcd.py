"""The xkcd #287 "NP-complete" menu — the port's counterpart of
``examples/ga/xkcd.py`` (reference ``examples/ga/xkcd.py``): order
appetizers totalling exactly $15.05, minimising the price error and the
item count.  A genome is the count (0-3) of each menu item; NSGA-II
selection (the 2-objective staircase ranks)."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ..._xla_math import row_sum
from ...algorithms import evaluate_population, var_and
from ...ops import emo
from ...ops._dispatch import batched_op, rowwise_op

ITEMS = [("Mixed Fruit", 2.15), ("French Fries", 2.75), ("Side Salad", 3.35),
         ("Hot Wings", 3.55), ("Mozzarella Sticks", 4.20),
         ("Sampler Plate", 5.80)]
TARGET = 15.05
MU, NGEN, MAX_COUNT = 40, 60, 3


def make_evaluate(device=None):
    """``evaluate(counts) -> (|total - TARGET|, items)`` over a leading
    row axis."""
    prices = torch.tensor([p for _, p in ITEMS], dtype=torch.float32,
                          device=device)

    def evaluate(counts):
        total = row_sum(counts * prices)
        return (total - TARGET).abs(), row_sum(counts)
    return batched_op(evaluate, evaluate)


@rowwise_op
def mate(keys, a, b):
    """Uniform count exchange, a key a row."""
    m = random.bernoulli(keys, 0.5, a.shape[1:])
    return torch.where(m, a, b), torch.where(m, b, a)


@rowwise_op
def mutate(keys, counts):
    """One random item's count moved by one, within ``[0, MAX_COUNT]``
    (``jax.random.choice`` of ``(-1, 1)``: a ``randint`` index)."""
    ks = random.split(keys)
    rows = torch.arange(counts.shape[0], device=counts.device)
    i = random.randint(ks[:, 0], (), 0, len(ITEMS)).long()
    delta = torch.tensor([-1.0, 1.0], device=counts.device)[
        random.randint(ks[:, 1], (), 0, 2).long()]
    out = counts.clone()
    out[rows, i] = torch.clamp(counts[rows, i] + delta, 0, MAX_COUNT)
    return out


def toolbox(device=None):
    tb = base.Toolbox()
    tb.register("evaluate", make_evaluate(device))
    tb.register("mate", mate)
    tb.register("mutate", mutate)
    return tb


def generation(tb, key, pop):
    key, k_var, k_sel = random.split(key, 3)
    off = var_and(k_var, pop, tb, cxpb=0.3, mutpb=0.6)
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(emo.sel_nsga2(k_sel, pool.fitness, MU))


def main(seed=6, verbose=True, ngen=None, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the final population."""
    ngen = NGEN if ngen is None else int(ngen)
    key = random.PRNGKey(seed, device=device)
    tb = toolbox(key.device)
    key, k_init = random.split(key)
    genome = random.randint(k_init, (MU, len(ITEMS)), 0, 2).to(torch.float32)
    pop = base.Population(genome, base.Fitness.empty(
        MU, (-1.0, -1.0), device=genome.device))
    pop, _ = evaluate_population(tb, pop)
    for _ in range(ngen):
        key, pop = generation(tb, key, pop)
    if verbose:
        vals = pop.fitness.values.cpu().numpy()
        best = np.argmin(vals[:, 0])
        counts = pop.genome[best].cpu().numpy().astype(np.int32)
        order = [f"{c}x {n}" for c, (n, _) in zip(counts, ITEMS) if c]
        print(f"best order (err ${vals[best, 0]:.2f}): {', '.join(order)}")
    return pop


if __name__ == "__main__":
    main()
