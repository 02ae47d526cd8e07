"""OneMax with an island model — the port's counterpart of
``examples/ga/onemax_island.py`` (reference
``examples/ga/onemax_island.py:40-150`` and the SCOOP variant): several
demes evolving independently, exchanging their best individuals around
a ring every few generations.

As published it runs in one process.  With ``mesh=`` every rank of the
mesh runs this same ``main`` and holds ``N_ISLANDS / R`` of the islands;
migration's cross-rank leg is a ring exchange (``batch_isend_irecv``).
The island count (5) must divide by the rank count."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ...ops import crossover, mutation, selection
from ...parallel import ea_simple_islands, fetch_global

N_ISLANDS, POP, N_BITS, NGEN, MIG_FREQ = 5, 60, 100, 40, 5


def onemax(g):
    return g.sum(-1),


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", onemax)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def initial(seed, device=None):
    """``(key, islands)``: bits drawn at ``(N_ISLANDS, POP, N_BITS)``."""
    key = random.PRNGKey(seed, device=device)
    key, k_init = random.split(key)
    genome = random.bernoulli(k_init, 0.5, (N_ISLANDS, POP, N_BITS)).to(
        torch.float32)
    dev = genome.device
    return key, base.Population(genome, base.Fitness(
        torch.zeros((N_ISLANDS, POP, 1), device=dev),
        torch.zeros((N_ISLANDS, POP), dtype=torch.bool, device=dev),
        (1.0,)))


def main(seed=0, mesh=None, device=None, ngen=NGEN, verbose=True):
    """Returns the islands (with a mesh: this rank's, as a
    :class:`~deap_tpu_torch.parallel.ShardedPopulation`)."""
    if mesh is not None:
        device = mesh.device
    key, pops = initial(seed, device)
    pops, _ = ea_simple_islands(key, pops, toolbox(), cxpb=0.5, mutpb=0.2,
                                ngen=ngen, mig_freq=MIG_FREQ, mig_k=5,
                                mesh=mesh)
    if verbose and (mesh is None or mesh.rank == 0):
        values = pops.fitness.values
        if mesh is not None:
            values = fetch_global(values, mesh)
        per_island_best = np.asarray(values.amax(1).cpu())[:, 0]
        print("per-island best:", per_island_best)
    return pops


if __name__ == "__main__":
    main()
