"""Quality indicators — the PyTorch counterparts of
``deap_tpu/ops/indicator.py``.

:func:`hypervolume`, :func:`additive_epsilon` and
:func:`multiplicative_epsilon` return the index of the
*least-contributing* individual of a nondominated front, for
indicator-based selection (MO-CMA-ES).  Fronts are :class:`~deap_tpu_torch.base.Fitness` objects,
weighted-values tensors or arrays ``(n, nobj)``; as in the reference the
objective space inside is ``-wvalues`` (implicit minimisation).  The
host functions run in numpy on a host copy; :func:`hypervolume_contributions_2d`
is tensor code on the points' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import Fitness, lexsort
from .hv import hypervolume as _hv

__all__ = ["hypervolume", "additive_epsilon", "multiplicative_epsilon",
           "hypervolume_contributions", "hypervolume_contributions_2d"]


def _wobj(front) -> np.ndarray:
    if isinstance(front, Fitness):
        front = front.wvalues
    if isinstance(front, torch.Tensor):
        front = front.detach().cpu().numpy()
    return -np.asarray(front)


def _contributions_2d_host(wobj: np.ndarray, ref) -> np.ndarray | None:
    """Exclusive hypervolume of each point of a *mutually nondominated*
    2-objective minimisation set, in closed form: sorted by f1, each
    point owns the box to its neighbours (capped at ``ref``); exact
    duplicates get 0 from both sides.

    Returns ``None`` when the set is not mutually nondominated (the
    neighbour-box formula is then wrong), so callers fall back to the
    exact leave-one-out path."""
    order = np.lexsort((wobj[:, 1], wobj[:, 0]))
    f1 = wobj[order, 0]
    f2 = wobj[order, 1]
    dup = (np.diff(f1) == 0) & (np.diff(f2) == 0)
    # sorted by (f1 asc, f2 asc): mutual nondominance <=> f2 strictly
    # decreases between distinct consecutive points
    if np.any(~dup & (np.diff(f2) >= 0)):
        return None
    next_f1 = np.minimum(np.append(f1[1:], ref[0]), ref[0])
    prev_f2 = np.minimum(np.concatenate(([ref[1]], f2[:-1])), ref[1])
    contrib = np.maximum(next_f1 - f1, 0.0) * np.maximum(prev_f2 - f2, 0.0)
    out = np.empty(len(wobj))
    out[order] = contrib
    return out


def hypervolume(front, **kargs) -> int:
    """Index of the individual with the least hypervolume contribution:
    the point whose removal leaves the largest remaining hypervolume.
    ``ref`` defaults to the worst objective plus one."""
    wobj = _wobj(front)
    ref = kargs.get("ref", None)
    if ref is None:
        ref = np.max(wobj, axis=0) + 1
    if wobj.shape[1] == 2:
        contrib_2d = _contributions_2d_host(wobj, np.asarray(ref))
        if contrib_2d is not None:
            return int(np.argmin(contrib_2d))
    contrib = [_hv(np.concatenate((wobj[:i], wobj[i + 1:])), ref)
               for i in range(len(wobj))]
    return int(np.argmax(contrib))


def hypervolume_contributions(front, ref=None) -> np.ndarray:
    """Exclusive hypervolume of every point, HV(P) - HV(P \\ {i}), on the
    host, any number of objectives."""
    wobj = _wobj(front)
    if ref is None:
        ref = np.max(wobj, axis=0) + 1
    total = _hv(wobj, ref)
    return np.array([total - _hv(np.concatenate((wobj[:i], wobj[i + 1:])),
                                 ref)
                     for i in range(len(wobj))])


def hypervolume_contributions_2d(obj: torch.Tensor, mask: torch.Tensor,
                                 ref: torch.Tensor) -> torch.Tensor:
    """Exclusive hypervolume of the masked rows of a 2-objective
    minimisation set ``obj`` ``(n, 2)``, as tensor code on its device:
    sorted by f1 (stable), each point's box reaches its neighbours, both
    ends capped at ``ref``; unmasked rows get 0 and duplicated points
    annihilate each other's boxes.

    PRECONDITION (unchecked): the masked rows are mutually nondominated,
    e.g. one rank of ``nondominated_ranks``; a dominated point grants its
    neighbour's box and every contribution after it is wrong."""
    n = obj.shape[0]
    inf = float("inf")
    f1 = torch.where(mask, obj[:, 0], inf)
    order = lexsort([f1])
    f1s = f1[order]
    f2s = torch.where(mask, obj[:, 1], inf)[order]
    nc = mask.sum()
    i = torch.arange(n, device=obj.device)
    next_f1 = torch.minimum(
        torch.where(i + 1 < nc, torch.roll(f1s, -1), ref[0]), ref[0])
    prev_f2 = torch.minimum(
        torch.where(i > 0, torch.roll(f2s, 1), ref[1]), ref[1])
    width = torch.clamp(next_f1 - f1s, min=0.0)
    height = torch.clamp(prev_f2 - f2s, min=0.0)
    contrib = torch.where(i < nc, width * height, 0.0)
    out = torch.zeros(n, dtype=obj.dtype, device=obj.device)
    out[order] = contrib
    return out


def additive_epsilon(front, **kargs) -> int:
    """Least additive-epsilon contributor: the point whose smallest
    worst-case objective gap to another point is smallest (host numpy)."""
    wobj = _wobj(front)
    worst = np.max(wobj[:, None, :] - wobj[None, :, :], axis=2)
    np.fill_diagonal(worst, np.inf)
    return int(np.argmin(np.min(worst, axis=1)))


def multiplicative_epsilon(front, **kargs) -> int:
    """Least multiplicative-epsilon contributor, by objective ratios
    (host numpy)."""
    wobj = _wobj(front)
    worst = np.max(wobj[:, None, :] / wobj[None, :, :], axis=2)
    np.fill_diagonal(worst, np.inf)
    return int(np.argmin(np.min(worst, axis=1)))
