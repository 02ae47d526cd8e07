"""A COCO/BBOB-style harness — the port's counterpart of
``examples/bbob.py``: CMA-ES (``ea_generate_update``) against the
built-in continuous functions at increasing dimensions, the best value
of each run in a table.  Plug in any ``f(x) -> (value,)``."""

from __future__ import annotations

import math

from .. import base, benchmarks, cma, random
from ..algorithms import ea_generate_update

SUITE = ["sphere", "cigar", "rosenbrock", "rastrigin", "ackley", "griewank",
         "schwefel", "bohachevsky"]
DIMS = (2, 5)
BUDGET_GENS = 60


def run_problem(fn, dim, seed, device=None, ngen=BUDGET_GENS):
    """One CMA-ES run (centroid 2, sigma 2, lambda ``4 + 2 int(3 ln
    dim)``): ``(population, best value)``."""
    strategy = cma.Strategy(centroid=[2.0] * dim, sigma=2.0,
                            lambda_=4 + int(3 * math.log(dim)) * 2,
                            device=device)
    tb = base.Toolbox()
    tb.register("evaluate", fn)
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    pop, _, _ = ea_generate_update(
        random.PRNGKey(seed, device=strategy.device), tb, strategy.init(),
        ngen=ngen, weights=(-1.0,))
    return pop, float(pop.fitness.values.min())


def main(seed=31, verbose=True, device=None, ngen=BUDGET_GENS):
    """The table ``{(name, dim): best}``."""
    results = {}
    for name in SUITE:
        fn = getattr(benchmarks, name)
        for dim in DIMS:
            results[(name, dim)] = run_problem(fn, dim, seed, device,
                                               ngen)[1]
    if verbose:
        print(f"{'function':14s} " + " ".join(f"d={d:<9d}" for d in DIMS))
        for name in SUITE:
            row = " ".join(f"{results[(name, d)]:<9.2e} " for d in DIMS)
            print(f"{name:14s} {row}")
    return results


if __name__ == "__main__":
    main()
