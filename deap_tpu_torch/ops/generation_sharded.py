"""Mesh-sharded fused GA generation — the port's counterpart of
``deap_tpu/ops/generation_sharded.py``: the megakernel
(:mod:`deap_tpu_torch.ops.generation`) stretched over the ranks of a
:class:`~deap_tpu_torch.parallel.mapper.Mesh`.

Tournament selection is population-global, the variation row-local.
Each rank holds ``n_loc`` rows and, per generation:

* **gathers the genome and the fitness table once** (two all-gathers in
  rank order), then derives the rank table ``order =
  lex_sort_indices(w_full)`` on its own: every rank decodes the same
  table, so selection needs no reduction;
* **replays the winner positions** :func:`~deap_tpu_torch.ops.selection.
  tournament_positions` under the same ``k_sel`` as the single-card
  paths, over the whole population, and slices its own rows at
  ``row_base0 = rank * n_loc``;
* **varies its rows at their global coordinates**: ``gather="dma"`` is
  K2 (:func:`~deap_tpu_torch.ops.generation.megakernel_gather_vary`) on
  the gathered genome at that ``row_base0``; ``gather="host"`` an
  ``index_select`` and then K1 (``megakernel_vary``).  The counter hash
  draws from global (row, lane) coordinates, so the output rows equal
  the single-card generation's, whatever the rank count.

Populations that do not tile the mesh ride the live-prefix protocol, as
in the JAX package: :func:`fused_ea_step_sharded` pads rows up to an
``R x 32`` quantum (the layout of
:func:`~deap_tpu_torch.parallel.mapper.population_sharding` with
``quantum=32``), marks the real rows live, and the pad rows (``-inf``
fitness, frozen genome) never win: a position landing in the pad
remaps into the live prefix by ``idx % live_n``.

On CUDA tensors the wrappers launch their kernels or raise; the plain
versions serve CPU tensors only.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import random
from ..base import lex_sort_indices
from ..engines import EngineError
from ..parallel import collectives
from ..parallel.mapper import (ShardedPopulation, check_axis,
                               population_sharding)
from .generation import (GenomeStorage, HardwareRngUnavailable, QUANTUM,
                         _fresh_fitness, _knobs, _seed_from_key,
                         _two_d_genome,
                         megakernel_gather_vary, megakernel_params,
                         megakernel_variation_params, megakernel_vary,
                         storage_of)
from .selection import tournament_positions

__all__ = ["fused_generation_sharded", "fused_ea_step_sharded",
           "fused_nsga2_step_sharded"]

#: the smallest megakernel tile; populations are padded to a multiple of
#: ``R * _MIN_ROWS`` rows so every rank tiles evenly
_MIN_ROWS = QUANTUM


def fused_generation_sharded(k_sel, k_var, genome, wvalues, *, mesh,
                             axis: Optional[str] = None, dim: int,
                             cxpb, mutpb, mut_mu=0.0, mut_sigma=0.3,
                             indpb=0.05, tournsize: int = 3,
                             storage: Optional[GenomeStorage] = None,
                             live_n=None, rows: Optional[int] = None,
                             gather: Optional[str] = None,
                             hw_rng: bool = False):
    """One sharded fused generation: ``genome`` ``(n_loc, dim)`` and
    ``wvalues`` ``(n_loc, nobj)`` are this rank's rows of a ``pop = R *
    n_loc`` population; returns ``(new rows, winner indices)`` of this
    rank, bitwise the rows ``[rank n_loc, (rank + 1) n_loc)`` of the
    single-card :func:`~deap_tpu_torch.ops.generation.fused_generation`
    under the same keys.  ``n_loc`` must be a multiple of 32
    (:func:`fused_ea_step_sharded` pads).  ``live_n`` (host gather only)
    is the global live-prefix count.  ``rows`` is kept for the JAX
    signature (a multiple of 32 dividing ``n_loc``); ``axis``, when
    given, must be the mesh's."""
    check_axis(mesh, axis)
    if hw_rng:
        raise HardwareRngUnavailable(
            "hw_rng=True draws the TPU's hardware PRNG stream, which has "
            "no counterpart on the card; use the counter hash (default)")
    storage = storage or GenomeStorage()
    n_loc, width = genome.shape
    pop = n_loc * mesh.size
    if genome.dtype != storage.torch_dtype:
        raise ValueError(f"genome dtype {genome.dtype} != declared "
                         f"storage {storage.dtype}")
    if width != dim:
        raise ValueError(f"genome trailing axis {width} != dim {dim}")
    gather = gather or "dma"
    if gather not in ("dma", "host"):
        raise ValueError(f"gather {gather!r}: expected 'dma' or 'host'")
    if gather == "dma" and live_n is not None:
        raise ValueError("live-masked megakernel steps use gather='host' "
                         "(the serving composition); the dma form is the "
                         "fixed-shape flagship path")
    rows = rows or QUANTUM
    if rows % QUANTUM or n_loc % rows:
        raise ValueError(f"rows {rows} must be a multiple of {QUANTUM} "
                         f"dividing the rank's rows {n_loc} (= pop {pop} / "
                         f"{mesh.size} ranks); fused_ea_step_sharded pads")

    g_full = collectives.all_gather(genome.contiguous(), mesh)
    w_full = collectives.all_gather(
        wvalues.to(torch.float32).contiguous(), mesh)
    order = lex_sort_indices(w_full, descending=True).to(torch.int32)
    row_base0 = mesh.rank * n_loc
    pos = tournament_positions(k_sel, pop, pop, tournsize)
    pos_loc = pos[row_base0:row_base0 + n_loc].contiguous()
    seed = _seed_from_key(k_var)
    knobs = _knobs((cxpb, mutpb, mut_mu, mut_sigma, indpb), genome.device)

    if gather == "dma":
        return megakernel_gather_vary(order, pos_loc, g_full, seed, knobs,
                                      dim=dim, storage=storage,
                                      row_base0=row_base0)
    widx = order[pos_loc.long()]
    if live_n is not None:
        live_n = torch.clamp(torch.as_tensor(live_n, device=widx.device),
                             min=1).to(widx.dtype)
        widx = torch.where(widx < live_n, widx, widx % live_n)
    varied = megakernel_vary(g_full.index_select(0, widx.long()), seed,
                             knobs, dim=dim, storage=storage,
                             row_base0=row_base0)
    if live_n is not None:
        glob = torch.arange(row_base0, row_base0 + n_loc,
                            device=genome.device)[:, None]
        varied = torch.where(glob < live_n, varied, genome)
    return varied, widx


def _sharded_of(population, toolbox, quantum: int) -> ShardedPopulation:
    mesh = getattr(toolbox, "generation_mesh", None)
    if mesh is None:
        raise EngineError(
            "toolbox.generation_engine 'megakernel_sharded' requires "
            "toolbox.generation_mesh (a deap_tpu_torch.parallel Mesh)")
    if not isinstance(population, ShardedPopulation):
        raise ValueError(
            "the megakernel_sharded engine takes this rank's block of the "
            "population: parallel.shard_population(pop, mesh, quantum=32)")
    if population.mesh is not mesh:
        raise ValueError("the population is sharded over another mesh than "
                         "toolbox.generation_mesh")
    if population.sharding != population_sharding(mesh, population.n,
                                                  quantum):
        raise ValueError(
            f"the megakernel_sharded engine needs the row layout of "
            f"quantum {quantum}: shard the population with "
            f"shard_population(pop, mesh, quantum={quantum})")
    return population


def fused_ea_step_sharded(key, population, toolbox, cxpb, mutpb, *,
                          live=None, gather: Optional[str] = None,
                          hw_rng: bool = False):
    """The sharded form of one megakernel ``ea_step`` generation,
    selected by ``toolbox.generation_engine = "megakernel_sharded"`` (or
    ``"megakernel"`` plus ``toolbox.generation_mesh``).  ``population``
    is this rank's block, laid out with ``quantum=32``; ``live`` is this
    rank's block of the global live-prefix mask.  Same reevaluate-all
    contract and key split as :func:`~deap_tpu_torch.ops.generation.
    fused_ea_step`.  Returns ``(key, this rank's new block)``."""
    pop_sh = _sharded_of(population, toolbox, _MIN_ROWS)
    mesh = pop_sh.mesh
    genome = _two_d_genome(pop_sh, "megakernel generation")
    params = megakernel_params(toolbox)
    storage = storage_of(toolbox) or GenomeStorage()
    sh = pop_sh.sharding
    pop, dim = pop_sh.n, genome.shape[1]

    key, k_sel, k_var = random.split(key, 3)
    live_n = None
    if live is not None:
        live = live.to(torch.bool)
        live_n = collectives.gather_sum(live.to(torch.int32).sum(), mesh)
    if sh.n_pad != pop and live_n is None:
        live_n = torch.tensor(pop, dtype=torch.int32, device=genome.device)
    if live_n is not None and gather is None:
        gather = "host"

    pad = sh.n_loc - sh.rows
    padded, wv = genome, pop_sh.fitness.masked_wvalues()
    if pad:
        padded = torch.cat([padded, padded.new_zeros((pad, dim))], 0)
        wv = torch.cat([wv, wv.new_full((pad, wv.shape[1]),
                                        float("-inf"))], 0)
    new_loc, _ = fused_generation_sharded(
        k_sel, k_var, padded, wv, mesh=mesh, dim=dim, cxpb=cxpb,
        mutpb=mutpb, storage=storage, tournsize=params["tournsize"],
        mut_mu=params["mut_mu"], mut_sigma=params["mut_sigma"],
        indpb=params["indpb"], live_n=live_n, gather=gather, hw_rng=hw_rng)
    return key, ShardedPopulation(new_loc[:sh.rows],
                                  _fresh_fitness(pop_sh.local(), live),
                                  mesh, pop, pop_sh.quantum)


def fused_nsga2_step_sharded(key, population, toolbox, cxpb, mutpb, *,
                             live=None):
    """The sharded NSGA-II head of the megakernel engine: the registered
    ``sel_nsga2_sharded`` picks the parents (indices equal on every
    rank), one genome all-gather brings them, and K1 varies this rank's
    rows at ``row_base0 = rank * n_loc`` — the rows of the single-card
    :func:`~deap_tpu_torch.ops.generation.fused_nsga2_step`.  The
    population must tile the mesh in blocks of 32 rows."""
    pop_sh = _sharded_of(population, toolbox, _MIN_ROWS)
    mesh = pop_sh.mesh
    sh = pop_sh.sharding
    if sh.n_pad != pop_sh.n:
        raise ValueError(f"the sharded NSGA-II head needs the population "
                         f"({pop_sh.n}) to be a multiple of {mesh.size} x "
                         f"{_MIN_ROWS}")
    genome = _two_d_genome(pop_sh, "megakernel generation")
    params = megakernel_variation_params(toolbox)
    storage = storage_of(toolbox) or GenomeStorage()
    dim = genome.shape[1]

    key, k_sel, k_var = random.split(key, 3)
    idx = toolbox.select(k_sel, pop_sh.fitness, pop_sh.n, n=pop_sh.n,
                         quantum=pop_sh.quantum)
    if live is not None:
        live = live.to(torch.bool)
        live_n = torch.clamp(collectives.gather_sum(
            live.to(idx.dtype).sum(), mesh), min=1)
        idx = torch.where(idx < live_n, idx, idx % live_n)
    g_full = collectives.all_gather(genome.contiguous(), mesh)
    idx_loc = idx[sh.start:sh.stop].long()
    seed = _seed_from_key(k_var)
    knobs = _knobs((cxpb, mutpb, params["mut_mu"], params["mut_sigma"],
                    params["indpb"]), genome.device)
    varied = megakernel_vary(g_full.index_select(0, idx_loc), seed, knobs,
                             dim=dim, storage=storage, row_base0=sh.start)
    if live is not None:
        glob = torch.arange(sh.start, sh.stop, device=genome.device)[:, None]
        varied = torch.where(glob < live_n, varied, genome)
    return key, ShardedPopulation(varied, _fresh_fitness(pop_sh.local(),
                                                         live),
                                  mesh, pop_sh.n, pop_sh.quantum)
