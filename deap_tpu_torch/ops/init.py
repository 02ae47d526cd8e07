"""Initializers — the port's counterpart of ``deap_tpu/ops/init.py``.

The JAX package fans an attribute function out over split keys with
``jax.vmap``.  Here the attribute takes the batch of split keys in one
call: the factories below (and every sampler of
:mod:`deap_tpu_torch.random`) draw from an ``(n, w)`` key batch what the
vmap draws, one key a row.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .. import random
from ..base import _map

__all__ = ["init_repeat", "init_iterate", "init_cycle",
           "uniform", "bernoulli", "randint", "permutation"]


def init_repeat(key: torch.Tensor, func: Callable, n: int) -> Any:
    """``func`` on ``split(key, n)``: ``n`` results on a new leading axis
    (reference ``initRepeat``).  ``func`` takes the key batch."""
    return func(random.split(key, n))


def init_iterate(key: torch.Tensor, container: Callable,
                 generator: Callable) -> Any:
    """``container(generator(key))`` (reference ``initIterate``)."""
    return container(generator(key))


def init_cycle(key: torch.Tensor, seq_of_funcs: Sequence[Callable],
               n: int = 1) -> Any:
    """Cycle through attribute generators ``n`` times, a fresh subkey a
    call (reference ``initCycle``): a tuple of the attributes, stacked
    on a leading axis when ``n > 1``."""
    outs = []
    for _ in range(n):
        row = []
        for func in seq_of_funcs:
            key, sub = random.split(key)
            row.append(func(sub))
        outs.append(tuple(row))
    if n == 1:
        return outs[0]
    return _map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


def uniform(low=0.0, high=1.0, shape=()):
    """Attribute: float32 uniforms in ``[low, high)``."""
    def attr(key):
        return random.uniform(key, shape, minval=low, maxval=high)
    return attr


def bernoulli(p=0.5, shape=(), dtype=torch.int32):
    """Attribute: bits, 1 with probability ``p``, as ``dtype``."""
    def attr(key):
        return random.bernoulli(key, p, shape).to(dtype)
    return attr


def randint(low, high, shape=(), dtype=torch.int32):
    """Attribute: integers in ``[low, high]`` — inclusive, as the
    reference examples' ``random.randint`` (drawn with ``high + 1``)."""
    def attr(key):
        return random.randint(key, shape, low, high + 1, dtype=dtype)
    return attr


def permutation(n):
    """Attribute: a random int32 permutation of ``range(n)``."""
    def attr(key):
        return random.permutation(key, n)
    return attr
