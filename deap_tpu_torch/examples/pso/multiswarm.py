"""Multiswarm PSO on a dynamic landscape — the port's counterpart of
``examples/pso/multiswarm.py``: constriction swarms with exclusion and
anti-convergence (Blackwell & Branke) tracking the optimum of the moving
peaks (scenario 2) as it shifts every 20 generations.

The JAX example calls ``multiswarm_step`` op by op (not jitted), so the
step's velocity update and the peak evaluation take their unfused forms
(``fused=False``)."""

from __future__ import annotations

import numpy as np

from ... import random
from ...benchmarks.movingpeaks import SCENARIO_2, MovingPeaks
from ...pso import multiswarm_init, multiswarm_step

NSWARMS, NPARTICLES, NDIM, NGEN = 5, 10, 5, 60
BOUNDS = (0.0, 100.0)


def run(seed=14, ngen=NGEN, device=None):
    """``(final state, offline errors)``."""
    mp = MovingPeaks(dim=NDIM, key=random.PRNGKey(seed, device=device),
                     **SCENARIO_2)
    key = random.PRNGKey(seed + 1, device=device)
    k_init, key = random.split(key)
    state = multiswarm_init(k_init, NSWARMS, NPARTICLES, NDIM,
                            pmin=BOUNDS[0], pmax=BOUNDS[1])
    rexcl = (BOUNDS[1] - BOUNDS[0]) / (2 * NSWARMS ** (1.0 / NDIM))
    errors = []
    for gen in range(ngen):
        key, k_step = random.split(key)
        peaks = mp.state

        def evaluate(x, peaks=peaks):
            return mp.evaluate(x, peaks, fused=False)
        state, sbest = multiswarm_step(k_step, state, evaluate,
                                       weights=(1.0,), rexcl=rexcl,
                                       rcloud=rexcl / 2, fused=False)
        errors.append(float(mp.globalMaximum()[0] - float(sbest.max())))
        if (gen + 1) % 20 == 0:
            mp.changePeaks()
    return state, errors


def main(seed=14, verbose=True, ngen=NGEN, device=None):
    """Returns the offline errors, one a generation."""
    _, errors = run(seed, ngen, device)
    if verbose:
        print(f"mean offline error: {np.mean(errors):.3f} "
              f"(final {errors[-1]:.3f})")
    return errors


if __name__ == "__main__":
    main()
