"""OneMax with the population sharded over a mesh — the port's
counterpart of ``examples/ga/onemax_sharded.py`` (reference
``examples/ga/onemax_mp.py:57-59``, which registers
``multiprocessing.Pool.map`` as ``toolbox.map``).

Every rank of the mesh runs this same ``main`` (SPMD).  Each draws only
its own rows of the initial population (:func:`deap_tpu_torch.random.
row_range`), and ``ea_simple`` on the :class:`~deap_tpu_torch.parallel.
ShardedPopulation` evaluates and varies the rank's rows, selects on one
gathered fitness table and fetches the parents through one genome
all-gather a generation: the same trajectory as one device.

Run on the CPU over two gloo ranks::

    python -m deap_tpu_torch.parallel.launch --ranks 2 --device cpu \\
        deap_tpu_torch.examples.ga.onemax_sharded:main
"""

from __future__ import annotations

import torch

from ... import algorithms, base, random
from ...ops import crossover, mutation, selection
from ...parallel import (ShardedPopulation, default_mesh, fetch_global,
                         initialize_cluster, population_sharding)


def onemax(g):
    return g.sum(-1),


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", onemax)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def initial(seed, pop_size, n_bits, mesh):
    """``(key, this rank's block)``: the example's key split, and the
    rank's rows of the ``(pop_size, n_bits)`` draw (quantum 2: mating
    pairs stay on one rank)."""
    key = random.PRNGKey(seed, device=mesh.device)
    key, k_init = random.split(key)
    sh = population_sharding(mesh, pop_size, quantum=2)
    with random.row_range((pop_size, sh.start, sh.stop)):
        genome = random.bernoulli(k_init, 0.5, (sh.rows, n_bits)).to(
            torch.float32)
    pop = ShardedPopulation(genome, base.Fitness.empty(
        sh.rows, (1.0,), device=mesh.device), mesh, pop_size, 2)
    return key, pop


def main(seed=0, pop_size=4096, n_bits=100, ngen=40, device=None,
         mesh=None, verbose=True):
    """Run on every rank of ``mesh`` (default: a mesh over the process
    group, joined here when there is none).  Returns this rank's block of
    the final population."""
    if mesh is None:
        initialize_cluster(backend="gloo" if device == "cpu" else None)
        mesh = default_mesh("pop", device=device)
    key, pop = initial(seed, pop_size, n_bits, mesh)
    pop, _ = algorithms.ea_simple(key, pop, toolbox(), cxpb=0.5, mutpb=0.2,
                                  ngen=ngen)
    best = float(fetch_global(pop).fitness.values.max())
    if verbose and mesh.rank == 0:
        print("devices:", mesh.size, "best:", best)
    return pop


if __name__ == "__main__":
    main()
