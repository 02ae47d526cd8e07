"""Island-model EA — the port's counterpart of
``deap_tpu/parallel/islands.py``.

Demes are a stacked leading axis ``(n_islands, pop, ...)``.  The JAX
package vmaps the per-island generation over ``split(k_gen,
n_islands)``; here a loop over the islands takes the same keys, which
draws the same numbers under threefry keys.  Ring migration is
:func:`deap_tpu_torch.ops.migration.mig_ring_stacked` without a mesh.

With ``mesh=``, rank ``r`` of ``R`` holds islands ``[r L, (r + 1) L)``
(``L = n_islands / R``), runs their generations, and migration is the
only exchange (:func:`~deap_tpu_torch.ops.migration.mig_ring_sharded`):
each rank picks its islands' emigrants, and a cyclic destination map
(the default ring) moves them with
:func:`~deap_tpu_torch.parallel.collectives.ring_shift`
(``batch_isend_irecv``), any other map with one gather of the
emigrants.  The trajectory equals the one-process run, island for
island.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import random
from ..algorithms import evaluate_population, var_and
from ..base import Fitness, Population, _map
from ..ops.migration import mig_ring_sharded, mig_ring_stacked
from ..ops.selection import sel_best
from . import collectives
from .mapper import Mesh, ShardedPopulation, check_axis

__all__ = ["ea_simple_islands", "stack_populations", "unstack_populations"]


def stack_populations(populations) -> Population:
    """List of per-island populations -> one Population with leaves
    ``(n_islands, pop, ...)``."""
    first = populations[0]
    return Population(
        _map(lambda *xs: torch.stack(xs), first.genome,
             *(p.genome for p in populations[1:])),
        Fitness(torch.stack([p.fitness.values for p in populations]),
                torch.stack([p.fitness.valid for p in populations]),
                first.fitness.weights))


def _island(stacked: Population, i: int) -> Population:
    f = stacked.fitness
    return Population(_map(lambda x: x[i], stacked.genome),
                      Fitness(f.values[i], f.valid[i], f.weights))


def unstack_populations(stacked: Population):
    n = stacked.fitness.values.shape[0]
    return [_island(stacked, i) for i in range(n)]


def _migrate(key, pops: Population, k: int, selection: Callable, migarray,
             mesh=None, n_isl: int = 0) -> Population:
    """Ring migration of the stacked islands: :func:`mig_ring_stacked`
    without a mesh, :func:`mig_ring_sharded` on this rank's islands with
    one."""
    bundle = dict(genome=pops.genome, values=pops.fitness.values,
                  valid=pops.fitness.valid)
    L = pops.fitness.values.shape[0]
    w = torch.stack([_island(pops, i).fitness.masked_wvalues()
                     for i in range(L)])
    if mesh is None:
        new, _ = mig_ring_stacked(key, bundle, w, k, selection,
                                  migarray=migarray)
    else:
        new, _ = mig_ring_sharded(key, bundle, w, k, selection, mesh, n_isl,
                                  migarray=migarray)
    return Population(new["genome"], Fitness(new["values"], new["valid"],
                                             pops.fitness.weights))


def _local_islands(populations, mesh):
    """``(local stacked population, n_islands, first island)``."""
    if mesh is None:
        return populations, populations.fitness.values.shape[0], 0
    if isinstance(populations, ShardedPopulation):
        n_isl = populations.n
        local = populations.local()
    else:
        n_isl = populations.fitness.values.shape[0]
        local = None
    if n_isl % mesh.size:
        raise ValueError(f"{n_isl} islands do not divide over the "
                         f"{mesh.size}-rank mesh")
    L = n_isl // mesh.size
    i0 = mesh.rank * L
    if local is None:
        f = populations.fitness
        local = Population(
            _map(lambda x: x[i0:i0 + L].to(mesh.device), populations.genome),
            Fitness(f.values[i0:i0 + L].to(mesh.device),
                    f.valid[i0:i0 + L].to(mesh.device), f.weights))
    return local, n_isl, i0


def ea_simple_islands(key, populations: Population, toolbox, cxpb: float,
                      mutpb: float, ngen: int, mig_freq: int, mig_k: int = 5,
                      mig_selection: Callable = sel_best,
                      migarray=None, stats=None, mesh: Mesh | None = None,
                      island_axis: str | None = None, verbose: bool = False,
                      telemetry=None):
    """eaSimple per island with periodic ring migration (reference
    examples/ga/onemax_island.py:112-150).

    ``populations``: stacked leaves ``(n_islands, pop, ...)``
    (:func:`stack_populations`).  Every ``mig_freq`` generations the
    ``mig_k`` best of each island replace the emigrant slots of the next
    island in the ring.  With ``mesh``, ``populations`` is the global
    stacked population (the same on every rank) or this rank's islands
    as a :class:`~deap_tpu_torch.parallel.ShardedPopulation` (``n`` the
    island count); each rank runs its islands and migration is the only
    exchange.

    Returns ``(populations, per_gen_stats)``: with a mesh, this rank's
    islands as a :class:`~deap_tpu_torch.parallel.ShardedPopulation`;
    the stats dict holds stacked ``(ngen, n_islands, ...)`` records
    (``nevals`` per island), equal on every rank.  ``island_axis``, when
    given, must be the mesh's axis name."""
    del verbose                     # unused by the JAX function too
    check_axis(mesh, island_axis)
    if telemetry is not None:
        raise NotImplementedError("telemetry is not ported to "
                                  "deap_tpu_torch yet")
    pops, n_isl, i0 = _local_islands(populations, mesh)
    L = pops.fitness.values.shape[0]

    def gather_isl(x):
        return x if mesh is None else collectives.all_gather(x, mesh)

    def global_pops(p):
        if mesh is None:
            return p
        return Population(_map(gather_isl, p.genome),
                          Fitness(gather_isl(p.fitness.values),
                                  gather_isl(p.fitness.valid),
                                  p.fitness.weights))

    keys0 = random.split(key, n_isl + 1)
    key = keys0[0]
    pops = stack_populations([evaluate_population(toolbox, _island(pops, i))[0]
                              for i in range(L)])
    records = []
    for gen in range(1, ngen + 1):
        key, k_gen, k_mig = random.split(key, 3)
        keys = random.split(k_gen, n_isl)
        out, nevals = [], []
        for i in range(L):
            k_sel, k_var = random.split(keys[i0 + i])
            isl = _island(pops, i)
            off = isl.take(toolbox.select(k_sel, isl.fitness, isl.size))
            off = var_and(k_var, off, toolbox, cxpb, mutpb)
            off, nev = evaluate_population(toolbox, off)
            out.append(off)
            nevals.append(torch.as_tensor(nev))
        pops = stack_populations(out)
        if mig_freq > 0 and gen % mig_freq == 0:
            pops = _migrate(k_mig, pops, mig_k, mig_selection, migarray,
                            mesh, n_isl)
        rec = dict(stats.compile(global_pops(pops))) if stats is not None \
            else {}
        rec["nevals"] = gather_isl(torch.stack(nevals))
        records.append(rec)
    stacked = {k: torch.stack([r[k] for r in records]) for k in records[0]} \
        if records else {}
    if mesh is not None:
        pops = ShardedPopulation(pops.genome, pops.fitness, mesh, n_isl, 1)
    return pops, stacked
