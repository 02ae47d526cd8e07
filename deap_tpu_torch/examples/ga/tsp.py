"""Travelling salesman with permutation genomes — the port's counterpart
of ``examples/ga/tsp.py``: partially matched crossover and index-shuffle
mutation over city orderings through ``ea_simple``.

The tour length is written over a leading row axis and registered as its
own batched form: the cities of each tour and of its rotation by one are
gathered, each leg's length is ``sqrt`` of the fused sum of its two
squared coordinates (``jnp.linalg.norm`` as XLA compiles it inside the
vmapped evaluation), and the 25 legs are summed as the JAX example's
jitted ``ea_simple`` sums them: in order in the initial evaluation,
vectorized (eight lanes, :func:`~deap_tpu_torch._xla_math.
row_sum_vectorized`) inside the scanned generation."""

from __future__ import annotations

import numpy as np
import torch

from ... import algorithms, base, random
from ..._xla_math import row_dot, row_sum, row_sum_vectorized, sqrt
from ...ops import crossover, mutation, selection
from ...ops._dispatch import batched_op

N_CITIES, POP, NGEN = 25, 200, 80


def cities(device) -> torch.Tensor:
    """The example's fixed city coordinates (``RandomState(169)``)."""
    rng = np.random.RandomState(169)
    return torch.tensor(rng.rand(N_CITIES, 2), dtype=torch.float32,
                        device=device)


def make_evaluate(coords: torch.Tensor, in_loop: bool = True):
    total = row_sum_vectorized if in_loop else row_sum

    def evaluate(perm):
        p = perm.long()
        d = coords[p] - coords[torch.roll(p, -1, -1)]
        return total(sqrt(row_dot(d, d, fused=True))),
    return batched_op(evaluate, evaluate)


def toolbox(coords, in_loop: bool = True):
    tb = base.Toolbox()
    tb.register("evaluate", make_evaluate(coords, in_loop))
    tb.register("mate", crossover.cx_partialy_matched)
    tb.register("mutate", mutation.mut_shuffle_indexes, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def initial(key, n: int, size: int):
    """``(key, genome)``: the example's split, then a random permutation
    a row from ``split(k_init, n)``."""
    key, k_init = random.split(key)
    return key, random.permutation(random.split(k_init, n), size)


def main(seed=3, verbose=True, ngen=None, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device`` (default
    the card).  Returns ``(population, shortest tour length)``."""
    ngen = NGEN if ngen is None else int(ngen)
    key = random.PRNGKey(seed, device=device)
    coords = cities(key.device)
    tb = toolbox(coords)
    key, genome = initial(key, POP, N_CITIES)
    pop = base.Population(genome, base.Fitness.empty(POP, (-1.0,),
                                                     device=key.device))
    pop, _ = algorithms.evaluate_population(toolbox(coords, False), pop)
    pop, _ = algorithms.ea_simple(key, pop, tb, cxpb=0.7, mutpb=0.2,
                                  ngen=ngen)
    best = float(pop.fitness.values.min())
    tours = pop.genome.sort(1).values.cpu()
    assert torch.equal(tours, torch.arange(N_CITIES, dtype=tours.dtype
                                           ).expand_as(tours))
    if verbose:
        print(f"shortest tour length: {best:.3f}")
    return pop, best


if __name__ == "__main__":
    main()
