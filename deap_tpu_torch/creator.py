"""Runtime spec factory — the port's counterpart of ``deap_tpu/creator.py``.

An "individual type" is a population schema, not a class: the fitness
weights plus the genome's structure (its leaves and the extra
per-individual leaves such as PSO's ``speed``).  ``create(name, ...)``
installs the spec in this module's namespace under ``name`` and warns
with a ``RuntimeWarning`` when it overwrites one.  Callable keyword
arguments become per-individual leaves, the others static metadata.
"""

from __future__ import annotations

import sys
import warnings
from typing import Any, Callable, Sequence

import torch

from . import random
from .base import Fitness, Population, _leaves, _map

__all__ = ["create", "FitnessSpec", "IndividualSpec"]


class FitnessSpec:
    """Schema for a fitness: the weights tuple (the sign picks minimize
    or maximize).  ``empty`` allocates the ``(pop, nobj)`` fitness."""

    def __init__(self, weights: Sequence[float]):
        self.weights = tuple(float(w) for w in weights)

    @property
    def nobj(self) -> int:
        return len(self.weights)

    def empty(self, pop_size: int, dtype=torch.float32,
              device=None) -> Fitness:
        """All-invalid fitness on ``device`` (default ``"cuda"``)."""
        return Fitness.empty(pop_size, self.weights, dtype, device)

    def __repr__(self):
        return f"FitnessSpec(weights={self.weights})"


class IndividualSpec:
    """Schema for individuals: a fitness spec plus named per-individual
    leaves.

    ``leaves`` maps attribute names to initializers ``f(key, n) -> (n,
    ...) tensor`` (or to ``None`` for a leaf the user supplies);
    ``static`` holds schema-level constants."""

    def __init__(self, fitness: FitnessSpec, leaves: dict | None = None,
                 static: dict | None = None):
        self.fitness = fitness
        self.leaves = dict(leaves or {})
        self.static = dict(static or {})

    @property
    def weights(self):
        return self.fitness.weights

    def population(self, genome: Any, **extra_leaves) -> Population:
        """Wrap a genome (a tensor, or a tuple/dict of tensors with a
        leading pop axis) into a :class:`Population` with empty fitness on
        the genome's device.  Extra leaves (``speed=...``) make the genome
        the dict ``{"genome": genome, **extra_leaves}``."""
        if extra_leaves:
            genome = dict(genome=genome, **extra_leaves)
        first = _leaves(genome)[0]
        return Population(genome=genome, fitness=self.fitness.empty(
            first.shape[0], device=first.device))

    def init_population(self, key: torch.Tensor, n: int, attr: Callable,
                        storage_dtype: str | None = None,
                        storage_bound: float = 0.0,
                        **extra_leaves) -> Population:
        """``n`` individuals from the initializer ``attr``: the JAX
        package's ``vmap(attr)(split(key, n))``, here ``attr`` called once
        on the ``(n, w)`` key batch, one key a row (the samplers of
        :mod:`deap_tpu_torch.random` and the factories of
        :mod:`deap_tpu_torch.ops.init` take such a batch and draw what
        the vmap draws: each key's own stream under threefry, the first
        key's under rbg).

        ``storage_dtype`` (``"bfloat16"`` / ``"int8"``) narrows the
        floating leaves once after the draw, into
        :class:`~deap_tpu_torch.ops.generation.GenomeStorage`;
        ``storage_bound`` is int8's symmetric range.  The key is then
        retired with ``fold_in(key, n)`` before the extra leaves are
        drawn, so no extra leaf reuses an individual's stream."""
        genome = attr(random.split(key, n))
        if storage_dtype is not None and storage_dtype != "float32":
            from .ops.generation import GenomeStorage
            storage = GenomeStorage(storage_dtype, storage_bound)
            genome = _map(lambda x: storage.to_storage(x)
                          if x.is_floating_point() else x, genome)
        key = random.fold_in(key, n)
        extras = {}
        for name, fn in self.leaves.items():
            if name in extra_leaves or fn is None:
                continue
            key, sub = random.split(key)
            extras[name] = fn(sub, n)
        extras.update(extra_leaves)
        return self.population(genome, **extras)

    def __repr__(self):
        return (f"IndividualSpec(weights={self.fitness.weights}, "
                f"leaves={list(self.leaves)}, static={self.static})")


def create(name: str, base: Any = None, **kargs) -> Any:
    """Create a named spec and install it as
    ``deap_tpu_torch.creator.<name>``.

    * ``create("FitnessMax", weights=(1.0,))`` → :class:`FitnessSpec`;
    * ``create("Individual", fitness=creator.FitnessMax, speed=init_fn)``
      → :class:`IndividualSpec` (callable keywords become leaves, the
      others static metadata).

    Redefining a name warns, as the reference does."""
    module = sys.modules[__name__]
    if hasattr(module, name):
        warnings.warn(
            f"A class named '{name}' has already been created and it will be "
            "overwritten. Consider deleting previous creation of that class "
            "or rename it.", RuntimeWarning)

    if "weights" in kargs and "fitness" not in kargs:
        spec = FitnessSpec(kargs.pop("weights"))
        spec.static = kargs
    else:
        fitness = kargs.pop("fitness", None)
        if fitness is None:
            raise TypeError(
                "create() needs either weights=... (fitness spec) or "
                "fitness=<FitnessSpec> (individual spec)")
        if isinstance(fitness, Sequence):
            fitness = FitnessSpec(fitness)
        leaves = {k: v for k, v in kargs.items() if callable(v) or v is None}
        static = {k: v for k, v in kargs.items() if k not in leaves}
        spec = IndividualSpec(fitness, leaves=leaves, static=static)

    setattr(module, name, spec)
    return spec
