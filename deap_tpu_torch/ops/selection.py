"""Selection operators — the PyTorch counterparts of
``deap_tpu/ops/selection.py``.  Each ``sel_*(key, fitness, k, ...)``
returns a ``(k,)`` index tensor into the population; ``fitness`` is a
:class:`~deap_tpu_torch.base.Fitness` or a ``(pop, nobj)`` weighted-values
tensor, and invalid rows compare as ``-inf``."""

from __future__ import annotations

import numpy as np
import torch

from .. import random
from .._xla_math import expm1, log1p
from ..base import Fitness, lex_sort_indices, lexsort

__all__ = ["sel_random", "sel_best", "sel_tournament",
           "tournament_positions"]


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
