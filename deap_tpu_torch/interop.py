"""Carry state between the JAX package and the port, as numpy arrays.

Neither package imports the other; the tests hand numpy arrays across:
a raw ``uint32[2]`` key, a genome in any storage dtype (bfloat16 as its
``uint16`` bit pattern, or as an ``ml_dtypes.bfloat16`` array, which is
what ``np.asarray`` of a JAX bfloat16 array gives), fitness
``values``/``valid``/``weights``, and a genome storage declaration given
by its ``dtype`` and ``bound`` fields.

Like every entry point that creates tensors, the ``*_to_torch``
functions default to ``device="cuda"`` and raise
:class:`~deap_tpu_torch.NoCudaDevice` without a card; pass
``device="cpu"`` to build the state on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .base import Fitness, Population
from .ops.generation import GenomeStorage

__all__ = ["key_to_torch", "key_to_numpy", "genome_to_torch",
           "genome_to_numpy", "population_to_torch", "population_to_numpy",
           "storage_to_torch"]


def key_to_torch(key, device=None) -> torch.Tensor:
    """A raw ``uint32[2]`` key (``jax.random.key_data``) → the port's key."""
    words = np.asarray(key, dtype=np.uint32).reshape(-1)
    return torch.tensor(words.astype(np.int64), device=resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    return key.detach().cpu().numpy().astype(np.uint32)


def genome_to_torch(genome, device=None) -> torch.Tensor:
    device = resolve_device(device)
    g = np.asarray(genome)
    if g.dtype.name == "bfloat16":
        g = g.view(np.uint16)
    if g.dtype == np.uint16:            # bfloat16 bit pattern
        return torch.from_numpy(g.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(g, copy=True)).to(device)


def genome_to_numpy(genome: torch.Tensor) -> np.ndarray:
    """The port's genome → numpy; bfloat16 comes back as its ``uint16``
    bit pattern (numpy has no bfloat16)."""
    g = genome.detach().cpu()
    if g.dtype == torch.bfloat16:
        return g.view(torch.int16).numpy().view(np.uint16)
    return g.numpy()


def population_to_torch(genome, values, valid, weights,
                        device=None) -> Population:
    device = resolve_device(device)
    fit = Fitness(values=torch.tensor(np.asarray(values, np.float32),
                                      device=device),
                  valid=torch.tensor(np.asarray(valid, bool), device=device),
                  weights=tuple(float(w) for w in weights))
    return Population(genome_to_torch(genome, device), fit)


def population_to_numpy(population: Population):
    """``(genome, values, valid, weights)`` as numpy arrays and a tuple."""
    fit = population.fitness
    return (genome_to_numpy(population.genome),
            fit.values.detach().cpu().numpy(),
            fit.valid.detach().cpu().numpy(), fit.weights)


def storage_to_torch(storage) -> GenomeStorage:
    """Any object with ``dtype`` and ``bound`` (the JAX package's
    ``GenomeStorage``) → the port's :class:`GenomeStorage`."""
    return GenomeStorage(str(storage.dtype), float(storage.bound))
