"""Selection operators — the PyTorch counterparts of
``deap_tpu/ops/selection.py``.  Each ``sel_*(key, fitness, k, ...)``
returns a ``(k,)`` index tensor into the population; ``fitness`` is a
:class:`~deap_tpu_torch.base.Fitness` or a ``(pop, nobj)`` weighted-values
tensor, and invalid rows compare as ``-inf``."""

from __future__ import annotations

import numpy as np
import torch

from .. import random
from .._xla_math import cumsum, expm1, fma, log1p, row_sum
from ..base import Fitness, lex_argmax, lex_sort_indices, lexsort

__all__ = [
    "sel_random", "sel_best", "sel_worst", "sel_tournament",
    "tournament_positions", "sel_roulette",
    "sel_double_tournament", "sel_stochastic_universal_sampling",
    "sel_lexicase", "sel_epsilon_lexicase", "sel_automatic_epsilon_lexicase",
]


def _wv(fitness) -> torch.Tensor:
    if isinstance(fitness, Fitness):
        return fitness.masked_wvalues()
    return fitness


def sel_random(key, fitness, k):
    """``k`` uniform draws with replacement."""
    return random.randint(key, (k,), 0, _wv(fitness).shape[0])


def sel_best(key, fitness, k):
    """Top-``k`` by lexicographic fitness; ``key`` is unused."""
    del key
    return lex_sort_indices(_wv(fitness), descending=True)[:k]


def sel_worst(key, fitness, k):
    """Bottom-``k`` by lexicographic fitness (the stable ascending
    order); ``key`` is unused."""
    del key
    return lex_sort_indices(_wv(fitness), descending=False)[:k]


def _first_values(fitness) -> torch.Tensor:
    """The first objective's raw values, invalid rows read 0."""
    if isinstance(fitness, Fitness):
        return torch.where(fitness.valid, fitness.values[:, 0], 0.0)
    return fitness[:, 0]


def sel_roulette(key, fitness, k):
    """Fitness-proportionate selection on the first objective's raw
    value (like the reference, unsuitable for minimization or negative
    fitness): ``k`` uniforms placed in the cumulative shares by a
    left-sided search.  The sum and the cumulative sum are XLA's float32
    orders (:func:`~deap_tpu_torch._xla_math.row_sum`,
    :func:`~deap_tpu_torch._xla_math.cumsum`)."""
    vals = _first_values(fitness)
    n = vals.shape[0]
    total = row_sum(vals)
    p = torch.where(total > 0, vals / torch.where(total > 0, total, 1.0),
                    float(np.float32(1.0) / np.float32(n)))
    u = random.uniform(key, (k,))
    idx = torch.searchsorted(cumsum(p), u)
    return torch.clamp(idx, max=n - 1).to(torch.int32)


def sel_stochastic_universal_sampling(key, fitness, k):
    """SUS: ``k`` evenly spaced pointers, the first uniform in ``[0,
    total / k)``, over the cumulative first-objective values in
    descending fitness order, placed by a right-sided search.  The
    pointers are ``start + distance * i`` with the product fused into
    the add, as XLA compiles them."""
    vals = _first_values(fitness)
    n = vals.shape[0]
    order = lex_sort_indices(_wv(fitness), descending=True)
    total = row_sum(vals)
    # a divisor tensor: the card divides a tensor by a Python number as
    # a multiply by its reciprocal
    distance = total / torch.full_like(total, float(k))
    start = torch.clamp(random.uniform(key, ()) * distance, min=0.0)
    points = fma(distance, torch.arange(k, dtype=torch.float32,
                                        device=vals.device), start)
    picks = torch.searchsorted(cumsum(vals[order]), points, right=True)
    return order[torch.clamp(picks, max=n - 1)]


def tournament_positions(key, n, k, tournsize):
    """The rank positions of ``k`` tournament winners — the best rank
    among ``tournsize`` iid uniform ranks, by inverse CDF
    ``floor(n * -expm1(log1p(-u) / tournsize))``.

    The transcendentals are XLA's own float32 forms
    (:mod:`deap_tpu_torch._xla_math`) and the division is the multiply
    by the float32 reciprocal that XLA substitutes for a constant
    divisor, so the positions equal the JAX package's bit for bit
    (``torch.log1p``/``torch.expm1`` would move ~1.4% of them by one
    rank)."""
    u = random.uniform(key, (k,))
    inv = float(np.float32(1.0 / tournsize))
    pos = torch.floor(-expm1(log1p(-u) * inv) * float(n)).to(torch.int32)
    return torch.clamp(pos, 0, n - 1)


def sel_tournament(key, fitness, k, tournsize, tie_break="random"):
    """``k`` tournaments of ``tournsize`` uniform aspirants each, keeping
    the lexicographic best, computed by inverse CDF over fitness ranks.
    ``tie_break="random"`` breaks ties with one keyed uniform jitter per
    individual as the least significant sort key; ``"rank"`` keeps the
    deterministic stable order (see the JAX package for the trade-off)."""
    w = _wv(fitness)
    n = w.shape[0]
    if tie_break == "random":
        key, k_tie = random.split(key)
        jitter = random.uniform(k_tie, (n,))
        keys = [jitter] + [w[:, j] for j in range(w.shape[1] - 1, -1, -1)]
        order = lexsort(keys).flip(0)
    elif tie_break == "rank":
        order = lex_sort_indices(w, descending=True)
    else:
        raise ValueError(f"tie_break {tie_break!r}: expected 'random' or "
                         "'rank'")
    pos = tournament_positions(key, n, k, tournsize)
    return order[pos.long()]


def sel_double_tournament(key, fitness, sizes, k, fitness_size,
                          parsimony_size, fitness_first=True):
    """Parsimony double tournament (reference selDoubleTournament, Luke &
    Panait 2002): a fitness tournament of ``fitness_size`` aspirants
    composed with a size tournament of two, whose smaller aspirant wins
    with probability ``parsimony_size / 2`` (ties keep the draw's
    order).  ``sizes`` ``(pop,)`` is each individual's size.  With
    ``fitness_first`` the size tournament picks between two fitness
    winners (keys ``fold_in(k_fit, 0 | 1)``); otherwise the fitness
    tournament runs over ``fitness_size`` size winners (``fold_in(k_size,
    i)``, ``fold_in(k_prob, i)``)."""
    w = _wv(fitness)
    n = w.shape[0]
    k_fit, k_size, k_prob = random.split(key, 3)
    sizes = torch.as_tensor(sizes, device=w.device)

    def fit_round(kk, select_from):
        cols = random.randint(kk, (k, fitness_size), 0, select_from.shape[1])
        asp = select_from.gather(1, cols.long())
        win = lex_argmax(w[asp], axis=1)
        return asp.gather(1, win[:, None])[:, 0]

    def size_round(kk, kp, select_from):
        cols = random.randint(kk, (k, 2), 0, select_from.shape[1])
        asp = select_from.gather(1, cols.long())
        s1, s2 = sizes[asp[:, 0]], sizes[asp[:, 1]]
        smaller_first = torch.where((s1 < s2)[:, None], asp, asp.flip(1))
        pick_small = random.bernoulli(kp, parsimony_size / 2.0, (k,))
        return torch.where(pick_small, smaller_first[:, 0],
                           smaller_first[:, 1])

    all_idx = torch.arange(n, device=w.device).expand(k, n)
    if fitness_first:
        cand = torch.stack([fit_round(random.fold_in(k_fit, 0), all_idx),
                            fit_round(random.fold_in(k_fit, 1), all_idx)], 1)
        return size_round(k_size, k_prob, cand)
    cand = torch.stack([size_round(random.fold_in(k_size, i),
                                   random.fold_in(k_prob, i), all_idx)
                        for i in range(fitness_size)], 1)
    win = lex_argmax(w[cand], axis=1)
    return cand.gather(1, win[:, None])[:, 0]


def _nanmedian(x):
    """jax's ``nanmedian`` along the last axis (``nanquantile`` at 0.5,
    method ``"linear"``): sort a row (NaNs last), ``q = 0.5 (count -
    1)`` over its non-NaN count, and ``low (1 - w) + high w`` with ``w =
    q - floor(q)`` in float32.  The weights are 0, 1/2 or 1, so both
    products are exact and the sum rounds once, fused or not;
    ``torch.nanmedian`` returns the lower middle value instead."""
    a = torch.sort(torch.where(x.isnan(), float("nan"), x), dim=-1).values
    count = (~a.isnan()).sum(dim=-1, keepdim=True).to(x.dtype)
    q = 0.5 * (count - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    last = count - 1.0
    low = torch.clamp(torch.minimum(low, last), min=0.0).long()
    high = torch.clamp(torch.minimum(high, last), min=0.0).long()
    out = a.gather(-1, low) * lw + a.gather(-1, high) * hw
    return out[..., 0]


def _mad_eps(col, mask):
    big = torch.where(mask, col, float("nan"))
    med = _nanmedian(big)
    return _nanmedian((big - med[:, None]).abs())


# how often the case loop reads on the host which rows are final
_LEXICASE_CHECK = 8


def _lexicase(key, cases, k, eps_fn):
    """``k`` lexicase selections at once: each row shuffles the case
    order with its own key (``split(key, k)``, then ``split`` of each into
    the shuffle's key and the final pick's), then narrows a candidate
    mask case by case to those within ``eps`` of the case's best,
    keeping the mask when nothing survives, and picks uniformly among
    the survivors (the first index of the largest draw).

    A row whose candidates all have the same case values (one candidate,
    or copies of one program, common in GP) can change no more: on
    every later case they are all the best, the epsilon of equal values
    is 0, and a NaN case empties the new mask, which then keeps the old
    one.  Every ``_LEXICASE_CHECK`` cases the rows that are so leave the
    loop (one read on the host), which goes on over the others alone,
    and ends when none is left."""
    cases = torch.as_tensor(cases)
    n, ncases = cases.shape
    keys = random.split(key, k)
    ks = random.split(keys)
    k_shuf, k_pick = ks[:, 0], ks[:, 1]
    order = random.permutation(k_shuf, ncases).long()           # (k, nc)
    by_case = cases.t().contiguous()                            # (nc, n)
    # equal case rows share a class (NaN rows stay apart: conservative)
    cls = torch.unique(cases, dim=0, return_inverse=True)[1]
    final = torch.ones((k, n), dtype=torch.bool, device=cases.device)
    rows = torch.arange(k, device=cases.device)
    mask = final
    for step in range(ncases):
        if step and step % _LEXICASE_CHECK == 0:
            lo = torch.where(mask, cls, n).amin(dim=1)
            hi = torch.where(mask, cls, -1).amax(dim=1)
            going = (lo != hi).nonzero()[:, 0]
            if going.numel() < rows.numel():
                final[rows] = mask
                rows, mask, order = rows[going], mask[going], order[going]
                if not rows.numel():
                    break
        col = by_case[order[:, step]]                           # (r, n)
        best = torch.where(mask, col, float("-inf")).amax(dim=1)
        eps = eps_fn(col, mask)
        new = mask & (col >= (best - eps)[:, None])
        mask = torch.where(new.any(dim=1, keepdim=True), new, mask)
    final[rows] = mask
    u = random.uniform(k_pick, (n,))
    return torch.argmax(torch.where(final, u, -1.0), dim=1)


def sel_lexicase(key, cases, k):
    """Lexicase selection (reference selLexicase, Spector 2012):
    ``cases`` ``(pop, ncases)`` per-case fitness, signed for
    maximization."""
    return _lexicase(key, cases, k, lambda col, mask: torch.zeros(
        col.shape[0], dtype=col.dtype, device=col.device))


def sel_epsilon_lexicase(key, cases, k, epsilon):
    """Epsilon-lexicase with a fixed ``epsilon`` (reference
    selEpsilonLexicase)."""
    eps = float(np.float32(epsilon))
    return _lexicase(key, cases, k, lambda col, mask: torch.full(
        (col.shape[0],), eps, dtype=col.dtype, device=col.device))


def sel_automatic_epsilon_lexicase(key, cases, k):
    """Epsilon-lexicase with ``epsilon`` the median absolute deviation of
    the candidates' errors on the case (reference
    selAutomaticEpsilonLexicase, La Cava 2016), jax's ``nanmedian``
    twice."""
    return _lexicase(key, cases, k, _mad_eps)
