"""Core containers: :class:`Toolbox`, :class:`Fitness`, :class:`Population`.

The PyTorch counterpart of ``deap_tpu/base.py``.  A population's fitness
is one ``(pop, nobj)`` tensor of raw values plus a ``(pop,)`` validity
mask; comparisons maximize the weighted values, so invalid rows read as
``-inf`` and lose every comparison.  Tensors carry their own device.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Sequence

import torch

from ._device import resolve_device

__all__ = ["Toolbox", "Fitness", "Population", "wvalues_of", "dominates",
           "dominance_matrix", "lex_cmp_matrix", "lex_argmax",
           "lex_sort_indices"]


class Toolbox:
    """Named operator registry (reference ``base.Toolbox``).

    ``register`` freezes arguments into a ``functools.partial`` that keeps
    the function's ``__dict__`` (so batched forms stay reachable); the
    ``clone`` and ``map`` slots default to identity and builtin ``map``.

    One slot goes beyond the reference, as in the JAX package:
    ``hypervolume(pointset, ref, block=128, device=None)`` defaults to
    the per-dimension router of
    :func:`deap_tpu_torch.ops.hypervolume.hypervolume` — two objectives
    on the host staircase, three through the blocked sweep in float64
    on ``device`` (the CUDA kernel on the card, which is the default and
    raises without one; the plain sweep for ``device="cpu"``), four or
    more on the host WFG."""

    def __init__(self):
        self.register("clone", lambda x: x)
        self.register("map", map)
        from .ops.hypervolume import hypervolume
        self.register("hypervolume", hypervolume)

    def register(self, alias: str, function: Callable, *args, **kargs) -> None:
        pfunc = partial(function, *args, **kargs)
        pfunc.__name__ = alias
        pfunc.__doc__ = function.__doc__
        if hasattr(function, "__dict__") and not isinstance(function, type):
            pfunc.__dict__.update(function.__dict__.copy())
        setattr(self, alias, pfunc)

    def unregister(self, alias: str) -> None:
        delattr(self, alias)

    def decorate(self, alias: str, *decorators: Callable) -> None:
        pfunc = getattr(self, alias)
        function, args, kargs = pfunc.func, pfunc.args, pfunc.keywords
        for decorator in decorators:
            function = decorator(function)
        self.register(alias, function, *args, **kargs)


def _as_weights(weights: Sequence[float]) -> tuple:
    ws = tuple(float(w) for w in weights)
    if not ws:
        raise TypeError("weights must be a non-empty sequence of numbers")
    return ws


@dataclasses.dataclass(frozen=True)
class Fitness:
    """Population-level multi-objective fitness: raw ``values``
    ``(pop, nobj)``, ``valid`` ``(pop,)`` bool, and the static
    ``weights`` tuple whose signs pick minimize/maximize."""

    values: torch.Tensor
    valid: torch.Tensor
    weights: tuple

    @staticmethod
    def empty(pop_size: int, weights: Sequence[float],
              dtype=torch.float32, device=None) -> "Fitness":
        """All-invalid fitness for ``pop_size`` rows on ``device`` (default
        ``"cuda"``; raises without a card unless ``device="cpu"``)."""
        weights = _as_weights(weights)
        device = resolve_device(device)
        return Fitness(
            values=torch.zeros((pop_size, len(weights)), dtype=dtype,
                               device=device),
            valid=torch.zeros((pop_size,), dtype=torch.bool, device=device),
            weights=weights)

    @property
    def nobj(self) -> int:
        return len(self.weights)

    @property
    def wvalues(self) -> torch.Tensor:
        # one column per objective with a Python scalar weight: no
        # host-to-device copy of the weights on every generation
        return torch.stack([self.values[:, j] * w
                            for j, w in enumerate(self.weights)], dim=1)

    def masked_wvalues(self, fill: float = float("-inf")) -> torch.Tensor:
        """wvalues with invalid rows replaced by ``fill``."""
        return torch.where(self.valid[:, None], self.wvalues, fill)

    def with_values(self, values: torch.Tensor,
                    where: torch.Tensor | None = None) -> "Fitness":
        """Assign objective values, only on ``where`` rows if given."""
        if values.ndim == 1:
            values = values[:, None]
        if where is None:
            return dataclasses.replace(self, values=values,
                                       valid=torch.ones_like(self.valid))
        return dataclasses.replace(
            self, values=torch.where(where[:, None], values, self.values),
            valid=self.valid | where)

    def invalidate(self, where: torch.Tensor | None = None) -> "Fitness":
        if where is None:
            return dataclasses.replace(self,
                                       valid=torch.zeros_like(self.valid))
        return dataclasses.replace(self, valid=self.valid & ~where)

    def take(self, idx: torch.Tensor) -> "Fitness":
        return dataclasses.replace(self, values=self.values[idx],
                                   valid=self.valid[idx])


def wvalues_of(values: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """``values * weights`` (weights as a tensor of the values' dtype)."""
    return values * torch.tensor(tuple(weights), dtype=values.dtype,
                                 device=values.device)


def dominates(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Pareto dominance on weighted values: every objective ``>=`` and at
    least one ``>``.  Broadcasts over leading axes."""
    return (wa >= wb).all(-1) & (wa > wb).any(-1)


def dominance_matrix(w: torch.Tensor) -> torch.Tensor:
    """``(n, n)`` bool, ``[i, j]`` = row i dominates row j."""
    return dominates(w[:, None, :], w[None, :, :])


def lex_cmp_matrix(w: torch.Tensor) -> torch.Tensor:
    """``(n, n)`` int8 lexicographic comparison of the rows of wvalues:
    +1 where row i > row j at their first differing objective, -1 where
    it is smaller, 0 where the rows are equal (a NaN differs from
    everything and compares as neither, as in the JAX package)."""
    neq = w[:, None, :] != w[None, :, :]
    first = torch.argmax(neq.to(torch.int8), dim=-1, keepdim=True)
    wi = torch.gather(w[:, None, :].expand(neq.shape), -1, first)[..., 0]
    wj = torch.gather(w[None, :, :].expand(neq.shape), -1, first)[..., 0]
    sign = torch.sign(wi - wj).to(torch.int8)
    return torch.where(neq.any(-1), sign, torch.zeros_like(sign))


def lex_argmax(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Index of the lexicographically largest row along ``axis`` of a
    ``(..., k, nobj)`` tensor (the first such index on ties): narrow a
    still-tied mask one objective at a time."""
    w = torch.movedim(w, axis, -2)
    alive = torch.ones(w.shape[:-1], dtype=torch.bool, device=w.device)
    for j in range(w.shape[-1]):
        col = torch.where(alive, w[..., j], float("-inf"))
        best = torch.amax(col, dim=-1, keepdim=True)
        alive = alive & (col >= best)
    return torch.argmax(alive.to(torch.int8), dim=-1)


def _sort_key(k: torch.Tensor) -> torch.Tensor:
    """XLA's float sort order: ``-0.0`` equals ``0.0`` and every NaN sorts
    last.  The card's radix sort orders raw bits, so canonicalize."""
    if not k.is_floating_point():
        return k
    return torch.where(k.isnan(), float("nan"), k) + 0.0


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: stable ascending order, LAST key primary."""
    idx = torch.sort(_sort_key(keys[0]), stable=True).indices
    for k in keys[1:]:
        idx = idx[torch.sort(_sort_key(k)[idx], stable=True).indices]
    return idx


def lex_sort_indices(w: torch.Tensor, descending: bool = True) -> torch.Tensor:
    """Stable lexicographic order of ``(n, nobj)`` wvalues, first objective
    primary.  ``descending`` is the stable ascending order reversed — tied
    rows come out highest index first, as in the JAX package — which is
    not what ``torch.sort(descending=True, stable=True)`` gives."""
    idx = lexsort([w[:, j] for j in range(w.shape[1] - 1, -1, -1)])
    return idx.flip(0) if descending else idx


@dataclasses.dataclass(frozen=True)
class Population:
    """A genome (a tensor, or a tuple/dict of tensors sharing the leading
    ``pop`` axis) plus its :class:`Fitness`."""

    genome: Any
    fitness: Fitness

    @property
    def size(self) -> int:
        return _leaves(self.genome)[0].shape[0]

    def take(self, idx: torch.Tensor) -> "Population":
        return Population(_map(lambda g: g[idx], self.genome),
                          self.fitness.take(idx))

    def concat(self, other: "Population") -> "Population":
        """Rows of ``self`` then rows of ``other`` (the (mu + lambda)
        pool); weights are ``self``'s."""
        a, b = self.fitness, other.fitness
        return Population(
            _map(lambda x, y: torch.cat([x, y], 0), self.genome, other.genome),
            Fitness(values=torch.cat([a.values, b.values], 0),
                    valid=torch.cat([a.valid, b.valid], 0),
                    weights=a.weights))

    def with_genome(self, genome: Any,
                    invalidate_where: torch.Tensor | None = None
                    ) -> "Population":
        return Population(genome, self.fitness.invalidate(invalidate_where))

    def evaluated(self, values: torch.Tensor,
                  where: torch.Tensor | None = None) -> "Population":
        return Population(self.genome, self.fitness.with_values(values, where))


def _leaves(g) -> list:
    """The genome's tensors in ``jax.tree_util`` order: a dict's entries by
    sorted key, a tuple's or list's in place."""
    if isinstance(g, torch.Tensor):
        return [g]
    if isinstance(g, dict):
        return [x for k in sorted(g) for x in _leaves(g[k])]
    return [x for v in g for x in _leaves(v)]


def _map(fn, g, *rest):
    """Apply ``fn`` leafwise over a genome of tensors (tensor, tuple,
    list or dict), zipping ``rest`` genomes of the same structure.  A
    dict's leaves are visited by sorted key, the order of :func:`_leaves`
    and ``jax.tree_util``, and come back under the same keys."""
    if isinstance(g, torch.Tensor):
        return fn(g, *rest)
    if isinstance(g, dict):
        return {k: _map(fn, g[k], *(r[k] for r in rest)) for k in sorted(g)}
    return type(g)(_map(fn, v, *(r[i] for r in rest))
                   for i, v in enumerate(g))
