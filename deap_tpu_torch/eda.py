"""Estimation-of-distribution algorithms — the port's counterpart of
``deap_tpu/eda.py``: EMNA and PBIL as ask/tell strategies with
``generate(state, key) -> genome`` and ``update(state, population) ->
state``, driven by :func:`deap_tpu_torch.algorithms.ea_generate_update`
like the CMA-ES strategies.

* EMNA samples ``centroid + sigma * N(0, I)`` and re-estimates the
  centroid from the ``mu`` best and sigma from their pooled variance.
* PBIL keeps a probability a bit, samples bit strings, pulls the vector
  toward the generation's best and mutates it.  ``update`` needs draws
  and the ask/tell protocol passes it no key, so the state carries its
  own key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import random
from ._device import resolve_device
from ._xla_math import fma, row_dot, row_sum, sqrt
from .base import Population

__all__ = ["EMNA", "EMNAState", "PBIL", "PBILState"]


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class EMNAState:
    centroid: torch.Tensor        # (dim,)
    sigma: torch.Tensor           # ()


class EMNA:
    """EMNA (Teytaud & Teytaud 2009, as in the reference's
    examples/eda/emna.py).  The state lives on ``device`` (default
    ``"cuda"``)."""

    def __init__(self, centroid, sigma: float, mu: int, lambda_: int,
                 device=None):
        dev = resolve_device(device)
        self.centroid0 = torch.tensor(np.asarray(centroid, np.float32),
                                      device=dev)
        self.sigma0 = torch.tensor(_f32(sigma), device=dev)
        self.dim = self.centroid0.shape[0]
        self.mu = int(mu)
        self.lambda_ = int(lambda_)

    def init(self) -> EMNAState:
        return EMNAState(centroid=self.centroid0, sigma=self.sigma0)

    def generate(self, state: EMNAState, key) -> torch.Tensor:
        """``centroid + sigma * z``, ``z`` standard normals of ``(lambda_,
        dim)``; the product fused into the add, and the normal's scale
        folded into ``sigma`` (``sigma * sqrt(2)`` times ``erf_inv(u)``),
        as XLA compiles it."""
        z = random.normal_erf_inv(key, (self.lambda_, self.dim))
        return fma(z, state.sigma * random.SQRT2, state.centroid)

    def update(self, state: EMNAState, population: Population) -> EMNAState:
        """Re-estimate from the ``mu`` best (a stable order, the first
        index winning a tie): the centroid moves by their mean deviation,
        sigma is their RMS deviation around that mean.  XLA's forms: the
        means multiply by the float32 reciprocal of the count, the
        centroid's move is fused into its add, and the squared deviations
        are one fused sum over all ``mu * dim`` of them (sigma within an
        ulp of XLA's, whose vectorized order is not reproduced)."""
        w = population.fitness.masked_wvalues()[:, 0]
        order = torch.argsort(-w, stable=True)[:self.mu]
        z = population.genome[order] - state.centroid
        col = row_sum(z.T)
        r = _f32(1.0 / self.mu)
        dev = (z - col * r).reshape(-1)
        total = row_dot(dev, dev, fused=True)
        sigma = sqrt(total * _f32(1.0 / (self.mu * self.dim)))
        return EMNAState(centroid=fma(col, r, state.centroid), sigma=sigma)


@dataclasses.dataclass(frozen=True)
class PBILState:
    prob_vector: torch.Tensor     # (dim,) in [0, 1]
    key: torch.Tensor             # the key update() draws from


class PBIL:
    """PBIL (Baluja 1994, as in the reference's examples/eda/pbil.py)."""

    def __init__(self, ndim: int, learning_rate: float, mut_prob: float,
                 mut_shift: float, lambda_: int, seed: int = 0,
                 device=None):
        self.ndim = int(ndim)
        self.learning_rate = float(learning_rate)
        self.mut_prob = float(mut_prob)
        self.mut_shift = float(mut_shift)
        self.lambda_ = int(lambda_)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def init(self, key=None) -> PBILState:
        if key is None:
            key = random.PRNGKey(self.seed, device=self.device)
        return PBILState(prob_vector=torch.full((self.ndim,), 0.5,
                                                device=key.device),
                         key=key)

    def generate(self, state: PBILState, key) -> torch.Tensor:
        u = random.uniform(key, (self.lambda_, self.ndim))
        return (u < state.prob_vector).to(torch.float32)

    def update(self, state: PBILState, population: Population) -> PBILState:
        """Pull toward the generation's best (the first maximum), then
        move each component with probability ``mut_prob`` toward a
        random bit by ``mut_shift`` (XLA's forms: the old vector's
        product fused into the pull, the bit's into the move)."""
        w = population.fitness.masked_wvalues()[:, 0]
        best = population.genome[torch.argmax(w)]
        lr = np.float32(self.learning_rate)
        pv = fma(state.prob_vector, float(np.float32(1) - lr), best * float(lr))
        ks = random.split(state.key, 3)
        key, k_coin, k_bit = ks[0], ks[1], ks[2]
        coin = random.uniform(k_coin, (self.ndim,)) < _f32(self.mut_prob)
        bit = random.randint(k_bit, (self.ndim,), 0, 2).to(pv.dtype)
        sh = np.float32(self.mut_shift)
        mutated = fma(bit, float(sh), pv * float(np.float32(1) - sh))
        return PBILState(prob_vector=torch.where(coin, mutated, pv), key=key)
