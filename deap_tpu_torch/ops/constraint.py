"""Constraint handling — the PyTorch counterpart of
``deap_tpu/ops/constraint.py``.

The penalty decorators wrap a per-individual evaluation function of a
genome tensor.  Both branches are computed and merged with
``torch.where``, so a wrapped function runs unchanged inside
``evaluate_population``'s ``torch.func.vmap`` (no data-dependent Python
branch).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .._xla_math import row_sum, sqrt

__all__ = ["DeltaPenalty", "ClosestValidPenalty", "DeltaPenality",
           "ClosestValidPenality"]


def _signs(weights) -> tuple:
    return tuple(1.0 if w >= 0 else -1.0 for w in weights)


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """``jnp.atleast_1d(jnp.asarray(x))`` beside ``like``: an evaluation's
    tuple of scalars or its tensor as a 1-D float tensor."""
    if isinstance(x, (tuple, list)):
        return torch.stack([torch.as_tensor(v, device=like.device)
                            .reshape(()) for v in x])
    t = torch.as_tensor(x, device=like.device)
    if not t.is_floating_point():
        t = t.to(torch.float32)
    return t.reshape(-1) if t.ndim == 0 else t


class DeltaPenalty:
    """Constant-offset penalty: an infeasible individual scores ``delta_i
    - sign(w_i) * distance(genome)`` on every objective, so the penalty
    always worsens its weighted fitness.

    :param feasibility: ``f(genome) -> bool`` tensor.
    :param delta: scalar or per-objective sequence.
    :param weights: the fitness weights (a genome carries none).
    :param distance: optional ``f(genome) -> scalar or (nobj,)``.
    """

    def __init__(self, feasibility: Callable, delta, weights: Sequence[float],
                 distance: Callable | None = None):
        self.fbty_fct = feasibility
        self.delta = np.atleast_1d(np.asarray(delta, np.float32))
        self.signs = _signs(weights)
        self.dist_fct = distance

    def __call__(self, func: Callable) -> Callable:
        def wrapper(genome, *args, **kwargs):
            vals = _vec(func(genome, *args, **kwargs), genome)
            feasible = torch.as_tensor(self.fbty_fct(genome),
                                       device=genome.device)
            delta = torch.from_numpy(self.delta).to(vals.device)
            signs = torch.tensor(self.signs, dtype=delta.dtype,
                                 device=vals.device)
            dist = (torch.as_tensor(self.dist_fct(genome), device=vals.device)
                    if self.dist_fct is not None else 0.0)
            penalty = delta - signs * dist
            return torch.where(feasible, vals,
                               torch.broadcast_to(penalty, vals.shape))
        return wrapper


class ClosestValidPenalty:
    """Projection penalty: an infeasible individual scores at its
    projection onto the feasible region (``feasible_fct``), minus
    ``sign(w_i) * alpha * distance(valid, original)``; the default
    distance is the Euclidean norm of the difference, summed in XLA's
    order (:func:`~deap_tpu_torch._xla_math.row_sum`)."""

    def __init__(self, feasibility: Callable, feasible_fct: Callable,
                 alpha: float, weights: Sequence[float],
                 distance: Callable | None = None):
        self.fbty_fct = feasibility
        self.fbl_fct = feasible_fct
        self.alpha = alpha
        self.signs = _signs(weights)
        self.dist_fct = distance

    def __call__(self, func: Callable) -> Callable:
        def wrapper(genome, *args, **kwargs):
            vals = _vec(func(genome, *args, **kwargs), genome)
            feasible = torch.as_tensor(self.fbty_fct(genome),
                                       device=genome.device)
            f_ind = self.fbl_fct(genome)
            f_vals = _vec(func(f_ind, *args, **kwargs), genome)
            if self.dist_fct is not None:
                dist = torch.as_tensor(self.dist_fct(f_ind, genome),
                                       device=vals.device)
            else:
                diff = f_ind.reshape(-1) - genome.reshape(-1)
                dist = sqrt(row_sum(diff * diff))
            signs = torch.tensor(self.signs, dtype=f_vals.dtype,
                                 device=vals.device)
            penal = f_vals - signs * self.alpha * dist
            return torch.where(feasible, vals, penal)
        return wrapper


# the reference keeps the misspelled names for backward compatibility
DeltaPenality = DeltaPenalty
ClosestValidPenality = ClosestValidPenalty
