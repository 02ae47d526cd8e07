"""DE on a dynamic landscape — the port's counterpart of
``examples/de/dynamic.py``: DE tracking the moving peaks (scenario 1),
the worst ``N_BROWNIAN`` agents re-randomized after each change.

The JAX example calls ``de_step`` op by op (not jitted), so the step's
float forms are the unfused ones (``fused=False``), and so is the peak
evaluation."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ...benchmarks.movingpeaks import SCENARIO_1, MovingPeaks
from ...de import de_step

POP, NDIM, NGEN, CHANGE_EVERY, N_BROWNIAN = 100, 5, 120, 60, 25
BOUNDS = (0.0, 100.0)


def run(seed=17, ngen=NGEN, device=None):
    """``(final population, tracking errors)``."""
    mp = MovingPeaks(dim=NDIM, key=random.PRNGKey(seed, device=device),
                     **SCENARIO_1)
    key = random.PRNGKey(seed + 1, device=device)
    k_init, key = random.split(key)
    dev = key.device
    genome = random.uniform(k_init, (POP, NDIM), minval=BOUNDS[0],
                            maxval=BOUNDS[1])
    pop = base.Population(genome, base.Fitness.empty(POP, (1.0,),
                                                     device=dev))
    errors = []
    for gen in range(ngen):
        ks = random.split(key, 3)
        key, k_step, k_rnd = ks[0], ks[1], ks[2]
        peaks = mp.state

        def evaluate(x, peaks=peaks):
            return mp.evaluate(x, peaks, fused=False)
        pop = de_step(k_step, pop, evaluate, cr=0.6, f=0.4, fused=False)
        best = float(pop.fitness.values.max())
        errors.append(float(mp.globalMaximum()[0]) - best)
        if (gen + 1) % CHANGE_EVERY == 0:
            mp.changePeaks()
            w = pop.fitness.masked_wvalues()[:, 0]
            order = torch.sort(w, stable=True).indices        # worst first
            fresh = random.uniform(k_rnd, (N_BROWNIAN, NDIM),
                                   minval=BOUNDS[0], maxval=BOUNDS[1])
            genome = pop.genome.clone()
            genome[order[:N_BROWNIAN]] = fresh
            pop = base.Population(genome, base.Fitness.empty(
                POP, (1.0,), device=dev))
    return pop, errors


def main(seed=17, verbose=True, ngen=NGEN, device=None):
    """Returns the tracking errors, one a generation."""
    _, errors = run(seed, ngen, device)
    if verbose:
        print(f"mean tracking error: {np.mean(errors):.3f} "
              f"(final {errors[-1]:.3f})")
    return errors


if __name__ == "__main__":
    main()
