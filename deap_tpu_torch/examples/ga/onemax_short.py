"""OneMax, minimal form — the port's counterpart of
``examples/ga/onemax_short.py``: :mod:`onemax`'s problem with no
statistics, the smallest complete GA."""

from __future__ import annotations

from ... import algorithms
from .onemax import initial, toolbox


def main(seed=0, verbose=True, ngen=40, device=None):
    """Returns the final population."""
    key, pop = initial(seed, 300, device)
    pop, _ = algorithms.ea_simple(key, pop, toolbox(), cxpb=0.5, mutpb=0.2,
                                  ngen=ngen)
    if verbose:
        print("best:", float(pop.fitness.values.max()))
    return pop


if __name__ == "__main__":
    main()
