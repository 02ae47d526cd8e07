"""MO-CMA-ES on ZDT1 — the port's counterpart of
``examples/es/cma_mo.py``: per-parent step sizes and Cholesky factors
and hypervolume-indicator environmental selection (Voss, Hansen & Igel
2010).  The strategy's sampling draws on the device and its selection
of two objectives runs there too (:class:`~deap_tpu_torch.cma.
StrategyMultiObjective`); its state is host numpy, as in the JAX
package."""

from __future__ import annotations

import numpy as np
import torch

from ... import benchmarks, cma, random
from ..._device import resolve_device
from ...base import Fitness
from ...benchmarks import tools as btools

MU, LAMBDA, NDIM, NGEN = 10, 10, 10, 120


def evaluate(genomes: np.ndarray, device) -> np.ndarray:
    """ZDT1 of float32 rows, as ``(n, 2)`` host values."""
    g = torch.as_tensor(np.asarray(genomes, np.float32), device=device)
    return torch.stack(benchmarks.zdt1(g), 1).cpu().numpy()


def run(seed=11, ngen=NGEN, device=None):
    """The strategy after ``ngen`` generations."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    parents = rng.uniform(0.0, 1.0, (MU, NDIM))
    strategy = cma.StrategyMultiObjective(
        parents, fitness_weights=(-1.0, -1.0), sigma=0.05,
        values=evaluate(parents, device), mu=MU, lambda_=LAMBDA,
        device=device)
    key = random.PRNGKey(seed, device=device)
    for _ in range(ngen):
        key, k_gen = random.split(key)
        offspring = strategy.generate(k_gen)
        values = evaluate(np.clip(offspring, 0.0, 1.0), device)
        strategy.update(offspring, values)
    return strategy


def hypervolume_of(strategy) -> float:
    """The parents' hypervolume at (11, 11), their values as float32."""
    n = len(strategy.parents)
    fit = Fitness(values=torch.as_tensor(strategy.parent_values,
                                         dtype=torch.float32),
                  valid=torch.ones(n, dtype=torch.bool),
                  weights=(-1.0, -1.0))
    return btools.hypervolume(fit, ref=np.array([11.0, 11.0]))


def main(seed=11, ngen=NGEN, verbose=True, device=None):
    """Returns the final parents' hypervolume at (11, 11)."""
    hv = hypervolume_of(run(seed, ngen, device))
    if verbose:
        print(f"final parent hypervolume: {hv:.3f}")
    return hv


if __name__ == "__main__":
    main()
