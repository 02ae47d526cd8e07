"""OneMax across processes — the port's counterpart of
``examples/ga/onemax_multihost.py`` (reference
``examples/ga/onemax_island_scoop.py:28,49``).

Every process launches the SAME script; after ``initialize_cluster()``
each seeds its own rows (``fold_in(key, process_index())``), the rows
combine into one global population sharded over the ranks, and the
unmodified ``ea_simple`` runs on it as on one device.

Single process::

    python -m deap_tpu_torch.examples.ga.onemax_multihost

Several processes (one a rank; ``--backend gloo`` on the CPU)::

    DEAP_TPU_COORDINATOR=127.0.0.1:1234 DEAP_TPU_NPROC=2 DEAP_TPU_PROC_ID=0 \\
        python -m deap_tpu_torch.examples.ga.onemax_multihost
    DEAP_TPU_COORDINATOR=127.0.0.1:1234 DEAP_TPU_NPROC=2 DEAP_TPU_PROC_ID=1 \\
        python -m deap_tpu_torch.examples.ga.onemax_multihost
"""

from __future__ import annotations

import argparse

import torch

from ... import algorithms, base, random
from ...ops import crossover, mutation, selection
from ...parallel import (cluster_mesh, distribute_population, fetch_global,
                         initialize_cluster, process_count, process_index)

NBITS = 100
POP_PER_PROCESS = 150
NGEN = 40


def onemax(g):
    return g.sum(-1),


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", onemax)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def local_rows(key, pop_per_process, device=None):
    """This process's own rows: bits under ``fold_in(key,
    process_index())``."""
    k_local = random.fold_in(key, process_index())
    genome = random.bernoulli(k_local, 0.5, (pop_per_process, NBITS)).to(
        torch.float32)
    return base.Population(genome, base.Fitness.empty(
        pop_per_process, (1.0,), device=device))


def run(ngen=NGEN, pop_per_process=POP_PER_PROCESS, device=None,
        backend=None):
    """Join the cluster (from the ``DEAP_TPU_*`` variables) and run:
    ``(final global population, logbook)``, equal on every process."""
    initialize_cluster(backend=backend or ("gloo" if device == "cpu"
                                           else None))
    mesh = cluster_mesh(("pop",), device=device)
    key = random.PRNGKey(11, device=mesh.device)
    pop = distribute_population(
        local_rows(key, pop_per_process, mesh.device), mesh)
    pop, logbook = algorithms.ea_simple(key, pop, toolbox(), cxpb=0.5,
                                        mutpb=0.2, ngen=ngen)
    return fetch_global(pop), logbook


def main(ngen=NGEN, pop_per_process=POP_PER_PROCESS, verbose=True,
         device=None, backend=None):
    """:func:`run`, then the best fitness of the global population (equal
    on every process)."""
    pop, _ = run(ngen, pop_per_process, device, backend)
    best = float(pop.fitness.values[:, 0].max())
    if verbose and process_index() == 0:
        print(f"processes={process_count()} devices={process_count()} "
              f"global_pop={pop_per_process * process_count()} best={best}")
    return best


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--ngen", type=int, default=NGEN)
    ap.add_argument("--pop-per-process", type=int, default=POP_PER_PROCESS)
    ap.add_argument("--out", default=None,
                    help="process 0 saves the final global population, "
                         "its best and the logbook's maxima here")
    args = ap.parse_args()
    final, log = run(args.ngen, args.pop_per_process, args.device,
                     args.backend)
    best = float(final.fitness.values[:, 0].max())
    if process_index() == 0:
        print(f"processes={process_count()} "
              f"global_pop={final.size} best={best}", flush=True)
        if args.out:
            torch.save({"genome": final.genome.cpu(),
                        "values": final.fitness.values.cpu(), "best": best,
                        "nevals": log.select("nevals")}, args.out)
    import torch.distributed as dist
    dist.destroy_process_group()
