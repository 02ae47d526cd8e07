"""Benchmark objective functions — the PyTorch counterparts of
``deap_tpu/benchmarks/__init__.py``.  Each maps ONE individual (a 1-D
tensor) to a tuple of objective scalars; the loops vmap them over the
population with ``torch.func.vmap``."""

from __future__ import annotations

import math

import torch

__all__ = ["sphere", "rastrigin"]


def sphere(individual):
    """Sphere: sum x_i^2."""
    return torch.sum(individual * individual),


def rastrigin(individual):
    """Rastrigin — the flagship GA benchmark config."""
    n = individual.shape[-1]
    return 10.0 * n + torch.sum(individual ** 2 - 10.0 * torch.cos(
        2.0 * math.pi * individual)),
