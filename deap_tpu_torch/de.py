"""Differential evolution — the port's counterpart of ``deap_tpu/de.py``.

One generation is a few whole-population tensor steps: each agent's
donors are drawn without replacement and never the agent itself, the
trial vector is a binomial crossover with one forced component, and the
greedy replacement is a row ``where``.

``de_step`` covers the classic strategies via ``variant``:
``"rand/1/bin"`` (the reference example), ``"best/1/bin"`` (the base is
the population's best), ``"rand/2/bin"`` and ``"best/2/bin"`` (two
difference pairs).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import random
from ._xla_math import fma
from .algorithms import _hof_setup, _logbook, _record, evaluate_rows
from .base import Fitness, Population

__all__ = ["de_step", "de"]

#: rows of the (rows, n - 1) donor shuffle drawn at once (int64 words):
#: 2048 rows of a population of 8192 hold ~134 MB a tensor
DONOR_CHUNK_ELEMS = 1 << 24


def _distinct_indices(key, n: int, k: int) -> torch.Tensor:
    """``(n, k)`` int64 donor indices: row ``i`` is the first ``k`` of a
    random permutation of ``n - 1`` (``jax.random.permutation`` under the
    row's key of ``split(key, n)``), shifted past ``i``, so the donors of
    a row are distinct and never the row itself.  Rows are drawn in
    chunks of :data:`DONOR_CHUNK_ELEMS` elements."""
    keys = random.split(key, n)
    rows = max(1, DONOR_CHUNK_ELEMS // max(n - 1, 1))
    if random.impl_of(key) == "rbg":
        rows = n            # one batch: rbg draws every row from its first key
    out = []
    for s in range(0, n, rows):
        perm = random.permutation(keys[s:s + rows], n - 1)[:, :k].long()
        i = torch.arange(s, s + perm.shape[0], device=key.device)[:, None]
        out.append(torch.where(perm >= i, perm + 1, perm))
    return torch.cat(out)


def de_step(key, population: Population, evaluate: Callable,
            cr: float = 0.25, f: float = 1.0,
            variant: str = "rand/1/bin", *, fused: bool = True
            ) -> Population:
    """One DE generation (reference examples/de/basic.py).

    For each agent ``x``: pick donors, build ``v = base + f * (b - c)``
    (one or two difference pairs), binomial-crossover into a trial ``y``
    with at least one mutated component, evaluate, keep the better of
    ``x`` and ``y``.  ``fused`` fuses ``f``'s product into the add, as
    XLA compiles the step under ``jit``; ``fused=False`` rounds it first,
    as the JAX step does when called op by op."""
    genome = population.genome
    if not isinstance(genome, torch.Tensor) or genome.ndim != 2:
        raise TypeError("de_step requires a flat (pop, dim) genome tensor")
    n, dim = genome.shape
    base_kind, ndiff, _ = variant.split("/")
    ndiff = int(ndiff)
    if n < 2 + 2 * ndiff:
        raise ValueError(
            f"variant {variant!r} needs a population of at least "
            f"{2 + 2 * ndiff} (got {n}) to draw distinct donors")

    ks = random.split(key, 3)
    k_idx, k_cr, k_force = ks[0], ks[1], ks[2]
    donors = _distinct_indices(k_idx, n, 1 + 2 * ndiff)

    w = population.fitness.masked_wvalues()[:, 0]
    if base_kind == "best":
        base = genome[torch.argmax(w)][None, :]
    else:
        base = genome[donors[:, 0]]
    diff = None
    for d in range(ndiff):
        pair = genome[donors[:, 1 + 2 * d]] - genome[donors[:, 2 + 2 * d]]
        diff = pair if diff is None else diff + pair
    if float(np.float32(f)) == 1.0:
        v = base + diff
    elif fused:
        v = fma(diff, f, base)
    else:
        v = base + diff * float(np.float32(f))

    cross = random.uniform(k_cr, (n, dim)) < float(np.float32(cr))
    forced = random.randint(k_force, (n,), 0, dim)
    cross = cross | (torch.arange(dim, device=genome.device)[None, :]
                     == forced[:, None])
    y = torch.where(cross, v, genome)

    weights = population.fitness.weights
    y_vals = evaluate_rows(evaluate, y)
    y_w = y_vals[:, 0] * weights[0]

    keep_trial = y_w > w
    new_genome = torch.where(keep_trial[:, None], y, genome)
    new_vals = torch.where(keep_trial[:, None], y_vals,
                           population.fitness.values)
    fit = Fitness(values=new_vals,
                  valid=population.fitness.valid | keep_trial,
                  weights=weights)
    return Population(genome=new_genome, fitness=fit)


def de(key, population: Population, evaluate: Callable, ngen: int,
       cr: float = 0.25, f: float = 1.0, variant: str = "rand/1/bin",
       stats=None, halloffame=None, verbose=False, *,
       evaluate_initial: Callable | None = None):
    """The DE loop (the reference example's main): the initial population
    is evaluated, then each generation takes ``key, k = split(key)`` and
    one :func:`de_step`.  Returns ``(population, logbook)``; the logbook
    holds generations 1..ngen.

    ``evaluate_initial`` (default ``evaluate``) evaluates the initial
    population: the JAX package does that op by op, outside its scanned
    generation, where XLA may round a function differently."""
    population = population.evaluated(evaluate_rows(
        evaluate if evaluate_initial is None else evaluate_initial,
        population.genome))
    _hof_setup(halloffame, population)
    records = []
    for _ in range(ngen):
        key, k = random.split(key)
        population = de_step(k, population, evaluate, cr=cr, f=f,
                             variant=variant)
        if halloffame is not None:
            halloffame.update(population)
        records.append(_record(stats, population, population.size))
    return population, _logbook(stats, None, records, ngen, verbose)
