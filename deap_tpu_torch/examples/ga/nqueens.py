"""N-Queens with a permutation encoding — the port's counterpart of
``examples/ga/nqueens.py``: one queen a column, the genome the row
permutation, the fitness the count of diagonal conflicts (0 solves
it), through ``ea_simple`` with a ``HallOfFame(1)``."""

from __future__ import annotations

import torch

from ... import algorithms, base, random
from ...ops import crossover, mutation, selection
from ...ops._dispatch import batched_op
from ...utils.support import HallOfFame
from .tsp import initial

N, POP, NGEN = 20, 300, 150


def evaluate(perm):
    """Pairs of queens on a common diagonal (``|drow| == |dcol|``), each
    counted once; over a leading row axis too."""
    p = perm.long()
    cols = torch.arange(perm.shape[-1], device=perm.device)
    dr = (p[..., :, None] - p[..., None, :]).abs()
    dc = (cols[:, None] - cols[None, :]).abs()
    conflicts = torch.triu((dr == dc) & (dc > 0))
    return conflicts.sum((-2, -1)).to(torch.float32),


batched_op(evaluate, evaluate)


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("mate", crossover.cx_partialy_matched)
    tb.register("mutate", mutation.mut_shuffle_indexes, indpb=2.0 / N)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def main(seed=4, verbose=True, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)``.  Returns
    ``(population, fewest conflicts in the hall of fame)``."""
    key = random.PRNGKey(seed, device=device)
    key, genome = initial(key, POP, N)
    pop = base.Population(genome, base.Fitness.empty(POP, (-1.0,),
                                                     device=key.device))
    hof = HallOfFame(1)
    pop, _ = algorithms.ea_simple(key, pop, toolbox(), cxpb=0.5, mutpb=0.4,
                                  ngen=ngen, halloffame=hof)
    best = float(hof.state.values.min())
    if verbose:
        print(f"fewest conflicts: {best:.0f} "
              f"({'solved' if best == 0 else 'not solved'})")
    return pop, best


if __name__ == "__main__":
    main()
