"""HARM-GP — bloat control by shaping the size distribution of the
offspring (Gardner, Gagné & Parizeau 2015; reference ``gp.harm``): the
PyTorch counterpart of ``deap_tpu/gp/harm.py``.

Each generation (1) breeds a large "natural" offspring population with
:func:`~deap_tpu_torch.algorithms.var_or` to model the size
distribution, (2) smooths its size histogram with a five-point kernel,
(3) picks a cutoff size from the best-fitness tail, (4) builds a target
histogram that decays exponentially above the cutoff and (5) accepts
each natural child with probability target / natural for its size,
taking the first ``n`` accepted (recycled when fewer pass).  Sizes are
bounded by the capacity ``cap``, so every histogram has ``cap + 3``
bins.

The histogram is the JAX package's five float32 scatter-adds, which
XLA's CPU backend runs one update after another in index order.  A
scatter-add on the card takes its updates in no fixed order, so the
last bits of a bin's sum would change from run to run; the port moves
the sizes to the host (one read a generation) and adds them there with
``numpy.add.at``, which also adds in index order, so every bin equals
the JAX package's on every device.  The target histogram is XLA's form:
the half-life ``bins * alpha + beta`` as one fused multiply-add, XLA's
float32 ``exp``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import random
from .._xla_math import exp, fma
from ..algorithms import (_hof_setup, _logbook, _record, evaluate_population,
                          var_or)
from ..base import Population, _leaves, lex_sort_indices

__all__ = ["harm", "size_histogram", "acceptance"]

#: the smoothing kernel: (size offset, weight)
_KDE = ((-2, 0.1), (-1, 0.2), (0, 0.4), (1, 0.2), (2, 0.1))


def size_histogram(sizes, nbins: int) -> torch.Tensor:
    """The kernel-smoothed float32 histogram ``(nbins,)`` of ``sizes``
    ``(m,)``: each pass adds its weight at ``size + offset`` (0 where that
    falls outside the bins), one update after another in index order,
    as XLA's CPU scatter does; computed on the host, returned on the
    sizes' device."""
    s = sizes.detach().cpu().numpy().astype(np.int64)
    hist = np.zeros(nbins, np.float32)
    for off, w in _KDE:
        b = s + off
        ok = (b >= 0) & (b < nbins)
        np.add.at(hist, np.where(ok, b, nbins - 1),
                  np.where(ok, np.float32(w), np.float32(0.0)))
    return torch.from_numpy(hist).to(sizes.device)


def acceptance(key, sizes, wvalues, n: int, alpha: float, beta: float,
               gamma: float, rho: float, mincutoff: int, nbins: int):
    """One generation's HARM acceptance over the ``m`` natural children:
    ``(chosen (n,), cutoff, natural_hist, prob_hist)``.  ``wvalues`` are
    their masked weighted values (the cutoff's fitness order)."""
    m = sizes.shape[0]
    dev = sizes.device
    sizes = sizes.to(torch.int64)
    natural_hist = size_histogram(sizes, nbins) * float(np.float32(n / m))
    order = lex_sort_indices(wvalues, descending=False)
    cand = sizes[order[int(n * rho) - 1:]]
    cutoff = torch.clamp(cand.min(), min=mincutoff)
    bins = torch.arange(nbins, dtype=torch.float32, device=dev)
    ln2 = math.log(2.0)
    hl = fma(bins, alpha, beta)
    scale = torch.div(torch.full_like(bins, float(np.float32(
        gamma * n * ln2))), hl)
    decay = exp(torch.div((bins - cutoff.to(torch.float32))
                          * float(np.float32(-ln2)), hl))
    target_hist = torch.where(bins <= cutoff.to(torch.float32), natural_hist,
                              scale * decay)
    floor = float(np.float32(1e-30))
    prob_hist = torch.where(natural_hist > 0, torch.div(
        target_hist, torch.clamp(natural_hist, min=floor)), target_hist)
    u = random.uniform(key, (m,))
    accept = u <= prob_hist[sizes.clamp(0, nbins - 1)]
    ar = torch.arange(m, device=dev)
    by_accept = torch.argsort(torch.where(accept, ar, m + ar))
    n_acc = accept.sum()
    slots = torch.arange(n, device=dev) % torch.clamp(n_acc, min=1)
    chosen = torch.where(n_acc > 0, by_accept[slots],
                         torch.arange(n, device=dev))
    return chosen, cutoff, natural_hist, prob_hist


def harm(key, population: Population, toolbox, cxpb: float, mutpb: float,
         ngen: int, alpha: float = 0.05, beta: float = 10.0,
         gamma: float = 0.25, rho: float = 0.9, nbrindsmodel: int = -1,
         mincutoff: int = 20, stats=None, halloffame=None, verbose=False):
    """Evolve ``population`` for ``ngen`` generations under HARM-GP size
    control, with :func:`~deap_tpu_torch.algorithms.ea_simple`'s toolbox
    (``evaluate``/``evaluate_population``, ``mate``, ``mutate``,
    ``select``) and the paper's parameters by default.  The genome is
    the GP triple ``(codes, consts, lengths)``; a tree's size is its
    length.  ``nbrindsmodel`` natural children a generation (``max(2000,
    n)`` for -1) come from one ``select`` of that many parents and one
    :func:`var_or`.  Returns ``(population, logbook)``."""
    n = population.size
    m = max(2000, n) if nbrindsmodel == -1 else nbrindsmodel
    nbins = _leaves(population.genome)[0].shape[-1] + 3

    population, nevals0 = evaluate_population(toolbox, population)
    _hof_setup(halloffame, population)
    if halloffame is not None:
        halloffame.update(population)
    rec0 = _record(stats, population, nevals0)
    records = []
    for _ in range(ngen):
        key, k_sel, k_nat, k_acc = random.split(key, 4)
        parents = population.take(toolbox.select(k_sel, population.fitness,
                                                 m))
        natural = var_or(k_nat, parents, toolbox, m, cxpb, mutpb)
        chosen = acceptance(k_acc, natural.genome[2],
                            natural.fitness.masked_wvalues(), n, alpha, beta,
                            gamma, rho, mincutoff, nbins)[0]
        population, nevals = evaluate_population(toolbox,
                                                 natural.take(chosen))
        if halloffame is not None:
            halloffame.update(population)
        records.append(_record(stats, population, nevals))
    return population, _logbook(stats, rec0, records, ngen, verbose)
