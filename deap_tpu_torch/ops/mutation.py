"""Mutation operators — the PyTorch counterparts of
``deap_tpu/ops/mutation.py``.  ``mut_gaussian`` is shape-polymorphic:
called on a ``(pop, size)`` batch with one key it is its own batched
form."""

from __future__ import annotations

import torch

from .. import random
from .._xla_math import fma
from ._dispatch import batched_op

__all__ = ["mut_gaussian"]


def mut_gaussian(key, ind, mu, sigma, indpb):
    """Add N(mu, sigma) noise to each gene with probability ``indpb``
    (``mu + sigma * z`` is one FMA, as XLA computes it).  The noise is
    drawn in the genome's dtype, as in the JAX package; only float32
    normals are ported, so a narrow genome raises ``TypeError``."""
    k_mask, k_noise = random.split(key)
    mask = random.bernoulli(k_mask, indpb, ind.shape)
    noise = fma(random.normal(k_noise, ind.shape, ind.dtype), sigma, mu)
    return torch.where(mask, ind + noise, ind)


batched_op(mut_gaussian, mut_gaussian)
