"""Multi-objective quality metrics — the counterparts of
``deap_tpu/benchmarks/tools.py``'s ``diversity``, ``convergence``,
``hypervolume`` and ``igd``.  All are host-side numpy: a front is a
:class:`~deap_tpu_torch.base.Fitness`, a population, a tensor or an
array, and is copied to the host once."""

from __future__ import annotations

import numpy as np
import torch

from ..base import Fitness
from ..ops import hv as _hv_mod

__all__ = ["diversity", "convergence", "hypervolume", "igd"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _front_values(front) -> np.ndarray:
    """Accept a Fitness, a (n, nobj) raw-objective array, or a
    Population."""
    if isinstance(front, Fitness):
        return _host(front.values)
    if hasattr(front, "fitness"):
        return _host(front.fitness.values)
    return _host(front)


def diversity(first_front, first, last) -> float:
    """Deb's NSGA-II diversity (spread) metric on a biobjective front;
    lower is better.  ``first_front`` must be ordered along the front."""
    vals = _front_values(first_front)
    df = np.hypot(vals[0, 0] - first[0], vals[0, 1] - first[1])
    dl = np.hypot(vals[-1, 0] - last[0], vals[-1, 1] - last[1])
    dt = np.hypot(np.diff(vals[:, 0]), np.diff(vals[:, 1]))
    if len(dt) == 0:
        return float(df + dl)
    dm = np.mean(dt)
    return float((df + dl + np.sum(np.abs(dt - dm)))
                 / (df + dl + len(dt) * dm))


def convergence(first_front, optimal_front) -> float:
    """Mean distance from front members to the nearest optimal point;
    lower is better."""
    vals = _front_values(first_front)
    opt = _host(optimal_front)
    d = np.sqrt(((vals[:, None, :] - opt[None, :, :]) ** 2).sum(-1))
    return float(np.mean(np.min(d, axis=1)))


def hypervolume(front, ref=None) -> float:
    """Absolute hypervolume of a front on ``-wvalues`` (implicit
    minimization), by the host tier
    (:func:`deap_tpu_torch.ops.hv.hypervolume`); the default reference
    point is the worst value + 1 per objective."""
    if isinstance(front, Fitness):
        wobj = -_host(front.wvalues)
    elif hasattr(front, "fitness"):
        wobj = -_host(front.fitness.wvalues)
    else:
        wobj = _host(front)
    if ref is None:
        ref = np.max(wobj, axis=0) + 1
    return float(_hv_mod.hypervolume(wobj, _host(ref)))


def igd(A, Z) -> float:
    """Inverse generational distance."""
    A, Z = _host(A), _host(Z)
    d = np.sqrt(((A[:, None, :] - Z[None, :, :]) ** 2).sum(-1))
    return float(np.mean(np.min(d, axis=0)))
