"""Benchmark utilities — the counterparts of
``deap_tpu/benchmarks/tools.py``: the evaluation-transform decorators
(``translate``, ``rotate``, ``noise``, ``scale``, ``bound``) and the
multi-objective quality metrics (``diversity``, ``convergence``,
``hypervolume``, ``igd``).

The decorators wrap evaluation functions of one individual ``(dim,)``
or of a batch ``(..., dim)`` alike; each decorated function carries a
re-configuration method of the same name, as in the reference.  Their
tensors (vector, inverse matrix, factor, bounds) are float32 and follow
the individual's device.  The metrics are host-side numpy: a front is a
:class:`~deap_tpu_torch.base.Fitness`, a population, a tensor or an
array, and is copied to the host once."""

from __future__ import annotations

from functools import wraps

import numpy as np
import torch

from .. import random
from ..base import Fitness
from ..ops import hv as _hv_mod

__all__ = ["translate", "rotate", "noise", "scale", "bound",
           "diversity", "convergence", "hypervolume", "igd"]


def _f32(v) -> torch.Tensor:
    """A float32 tensor of ``v`` (kept where it is when a tensor)."""
    if torch.is_tensor(v):
        return v.to(torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t if t.device == x.device else t.to(x.device)


class translate:
    """Evaluate at ``individual - vector`` (the inverse translation)."""

    def __init__(self, vector):
        self.vector = _f32(vector)

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, **kargs):
            return func(individual - _like(self.vector, individual), *args,
                        **kargs)
        wrapper.translate = self.translate
        return wrapper

    def translate(self, vector):
        self.vector = _f32(vector)


class rotate:
    """Evaluate at ``inv(matrix) @ individual`` (the inverse rotation).
    The inverse is ``torch.linalg.inv`` in float32 (LAPACK on the CPU,
    cuSOLVER on the card; JAX's LAPACK call rounds differently) and the
    product ``torch.matmul``."""

    def __init__(self, matrix):
        self.matrix = torch.linalg.inv(_f32(matrix))

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, **kargs):
            m = _like(self.matrix, individual)
            return func(individual @ m.T, *args, **kargs)
        wrapper.rotate = self.rotate
        return wrapper

    def rotate(self, matrix):
        self.matrix = torch.linalg.inv(_f32(matrix))


class noise:
    """Add noise to each objective.  A noise function takes a key (``f(key)
    -> scalar or tensor``), the explicit-key analogue of the reference's
    ``random.gauss`` partials; ``None`` adds nothing.  The decorated
    evaluate gains a ``key`` keyword: without it no noise is added; with
    it, objective ``i`` draws from ``split(key, nobj)[i]``."""

    def __init__(self, noise):
        if callable(noise) or noise is None:
            self.rand_funcs = (noise,)
            self._broadcast = True
        else:
            self.rand_funcs = tuple(noise)
            self._broadcast = False

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, key=None, **kargs):
            result = func(individual, *args, **kargs)
            if key is None:
                return result
            funcs = (self.rand_funcs * len(result) if self._broadcast
                     else self.rand_funcs)
            keys = random.split(key, len(result))
            return tuple(r if f is None else r + f(keys[i])
                         for i, (r, f) in enumerate(zip(result, funcs)))
        wrapper.noise = self.noise
        return wrapper

    def noise(self, noise):
        self.__init__(noise)


class scale:
    """Evaluate at ``individual * (1 / factor)``, the float32 reciprocal
    computed once."""

    def __init__(self, factor):
        self.factor = 1.0 / _f32(factor)

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, **kargs):
            return func(individual * _like(self.factor, individual), *args,
                        **kargs)
        wrapper.scale = self.scale
        return wrapper

    def scale(self, factor):
        self.factor = 1.0 / _f32(factor)


def _mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` of floats: the exact ``fmod``, moved by ``y`` when its
    sign differs from ``y``'s."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


class bound:
    """Bring an operator's outputs back into ``[low, up]`` by clipping,
    wrapping or mirroring (the reference documents these and leaves the
    body a stub; the JAX package's semantics)."""

    def __init__(self, bounds, type="clip"):
        self.low = _f32(bounds[0])
        self.up = _f32(bounds[1])
        if type == "mirror":
            self.bound = self._mirror
        elif type == "wrap":
            self.bound = self._wrap
        elif type == "clip":
            self.bound = self._clip
        else:
            raise ValueError(f"unknown bound type {type!r}")

    def _bounds(self, x):
        return _like(self.low, x), _like(self.up, x)

    def _clip(self, individual):
        low, up = self._bounds(individual)
        return torch.minimum(torch.maximum(individual, low), up)

    def _wrap(self, individual):
        low, up = self._bounds(individual)
        return low + _mod(individual - low, up - low)

    def _mirror(self, individual):
        low, up = self._bounds(individual)
        span = up - low
        t = _mod(individual - low, 2 * span)
        return low + torch.where(t > span, 2 * span - t, t)

    def __call__(self, func):
        @wraps(func)
        def wrapper(*args, **kargs):
            out = func(*args, **kargs)
            if isinstance(out, tuple):
                return tuple(self.bound(o) for o in out)
            return self.bound(out)
        wrapper.bound = self.bound
        return wrapper


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
