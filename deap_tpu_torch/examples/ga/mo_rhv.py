"""Regular hypervolume-based algorithm, greedy form — the port's
counterpart of ``examples/ga/mo_rhv.py`` (reference
``examples/ga/mo_rhv.py``): ZDT1 with random parents, bounded SBX and
polynomial mutation, and an environmental selection that keeps whole
Pareto fronts while they fit and truncates the split front by its
points' exclusive hypervolume contributions (the closed 2-D form,
:func:`~deap_tpu_torch.ops.indicator.hypervolume_contributions_2d`).

XLA compiles ZDT1 two ways in the JAX example: alone for the first
evaluation (``benchmarks.zdt1``) and, inside its scanned generation,
with the genes summed in the loop vectorizer's eight lanes
(:func:`zdt1_scanned`); the port takes each where the JAX example does,
so the runs are equal bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, benchmarks, random
from ..._xla_math import fma, row_sum_vectorized, sqrt
from ...algorithms import evaluate_population, vary_genome
from ...benchmarks import tools as btools
from ...ops import crossover, mutation, selection
from ...ops._dispatch import batched_op
from ...ops.emo import nondominated_ranks
from ...ops.indicator import hypervolume_contributions_2d

NDIM = 30
BOUND_LOW, BOUND_UP = 0.0, 1.0
MU, NGEN, CXPB = 100, 250, 0.9
WEIGHTS = (-1.0, -1.0)


def zdt1_scanned(individual):
    """``benchmarks.zdt1`` with the genes past the first summed as
    :func:`~deap_tpu_torch._xla_math.row_sum_vectorized`, over a leading
    row axis."""
    n = individual.shape[-1]
    f1 = individual[..., 0]
    g = fma(row_sum_vectorized(individual[..., 1:]),
            float(np.float32(9.0) * (np.float32(1.0) / np.float32(n - 1))),
            1.0)
    return f1, g * (1.0 - sqrt(f1 / g))


batched_op(zdt1_scanned, zdt1_scanned)


def toolbox(evaluate=benchmarks.zdt1):
    tb = base.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("mate", crossover.cx_simulated_binary_bounded,
                low=BOUND_LOW, up=BOUND_UP, eta=20.0)
    tb.register("mutate", mutation.mut_polynomial_bounded,
                low=BOUND_LOW, up=BOUND_UP, eta=20.0, indpb=1.0 / NDIM)
    return tb


def hv_select(key, pool_fitness, k):
    """Whole fronts while they fit, then the split front's ``k - kept``
    largest contributors (ties to the lower index), in index order
    (reference mo_rhv.py:143-161)."""
    w = pool_fitness.masked_wvalues()
    obj = -w
    ranks, _ = nondominated_ranks(w)
    L = torch.sort(ranks).values[k - 1]
    base_keep = ranks < L
    cand = ranks == L
    ref = torch.where(cand[:, None], obj, float("-inf")).max(0).values + 1.0
    contrib = hypervolume_contributions_2d(obj, cand, ref)
    need = k - base_keep.sum()
    n = cand.shape[0]
    cand_order = torch.sort(torch.where(cand, -contrib, float("inf")),
                            stable=True).indices
    cand_keep = torch.zeros_like(cand)
    cand_keep[cand_order] = torch.arange(n, device=cand.device) < need
    keep = base_keep | (cand_keep & cand)
    return torch.sort((~keep).to(torch.int8), stable=True).indices[:k]


def generation(tb, key, pop):
    key, k_par, k_var, k_sel = random.split(key, 4)
    idx = selection.sel_random(k_par, pop.fitness, MU)
    genome, _ = vary_genome(k_var, pop.genome[idx.long()], tb, CXPB, 1.0)
    off = base.Population(genome, base.Fitness.empty(
        MU, WEIGHTS, device=genome.device))
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(hv_select(k_sel, pool.fitness, MU))


def run(seed=1, ngen=NGEN, device=None):
    """The final population."""
    tb = toolbox()
    tb_gen = toolbox(zdt1_scanned)
    key = random.PRNGKey(seed, device=device)
    key, k_init = random.split(key)
    genome = random.uniform(k_init, (MU, NDIM), minval=BOUND_LOW,
                            maxval=BOUND_UP)
    pop = base.Population(genome, base.Fitness.empty(
        MU, WEIGHTS, device=genome.device))
    pop, _ = evaluate_population(tb, pop)
    for _ in range(ngen):
        key, pop = generation(tb_gen, key, pop)
    return pop


def main(seed=1, ngen=NGEN, verbose=True, device=None):
    """Returns ``(final population, hypervolume at (11, 11))``."""
    pop = run(seed, ngen, device)
    hv = float(btools.hypervolume(pop.fitness, ref=[11.0, 11.0]))
    if verbose:
        print(f"Final population hypervolume is {hv:f}")
    return pop, hv


if __name__ == "__main__":
    main()
