"""Crossover operators — the PyTorch counterparts of
``deap_tpu/ops/crossover.py``: per-pair ``cx(key, ind1, ind2)`` plus a
population-level ``.batched`` form that takes one key."""

from __future__ import annotations

import torch

from .. import random
from ._dispatch import batched_op

__all__ = ["cx_two_point"]


def _two_cut_points(key, size, low=1, shape=()):
    """Two distinct cut points with the reference's law: ``c1`` in
    ``[low, size]``, ``c2`` in ``[low, size-1]`` bumped past ``c1``, then
    ordered.  ``shape`` draws a batch of independent pairs."""
    k1, k2 = random.split(key)
    c1 = random.randint(k1, shape, low, size + 1)
    c2 = random.randint(k2, shape, low, size)
    c2 = torch.where(c2 >= c1, c2 + 1, c2)
    return torch.minimum(c1, c2), torch.maximum(c1, c2)


def _swap_where(mask, ind1, ind2):
    return torch.where(mask, ind2, ind1), torch.where(mask, ind1, ind2)


def cx_two_point(key, ind1, ind2):
    """Swap the slice between two random points."""
    size = ind1.shape[-1]
    lo, hi = _two_cut_points(key, size)
    idx = torch.arange(size, device=ind1.device)
    return _swap_where((idx >= lo) & (idx < hi), ind1, ind2)


def _cx_two_point_batched(key, A, B):
    n, size = A.shape[0], A.shape[-1]
    lo, hi = _two_cut_points(key, size, shape=(n, 1))
    idx = torch.arange(size, device=A.device)[None, :]
    return _swap_where((idx >= lo) & (idx < hi), A, B)


batched_op(cx_two_point, _cx_two_point_batched)
