"""Feature-selection GA, the JMLR-figure variant — the port's
counterpart of ``examples/ga/evoknn_jmlr.py``: the second objective is
the raw count of selected features, and the loop is the paper's
``varOr`` (mu + lambda) with lambda = mu = 100, cxpb 0.5, mutpb 0.1."""

from __future__ import annotations

import numpy as np

from .evoknn import run
from .knn import N_FEATURES

MU, NGEN = 100, 50
CXPB, MUTPB = 0.5, 0.1


def main(seed=13, ngen=NGEN, verbose=True, device=None):
    """Returns ``(population, the most accurate row's values)``."""
    pop, _ = run(seed, ngen, MU, MU, CXPB, MUTPB, False, (1.0, -1.0),
                 device)
    vals = pop.fitness.values.cpu().numpy()
    best = vals[np.argmax(vals[:, 0])]
    if verbose:
        print(f"pareto-best accuracy {best[0]:.3f} with "
              f"{best[1]:.0f}/{N_FEATURES} features")
    return pop, best


if __name__ == "__main__":
    main()
