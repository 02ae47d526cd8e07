"""(1+lambda)-CMA-ES — the port's counterpart of
``examples/es/cma_one_plus_lambda.py``: one parent, success-rule step
size and a Cholesky covariance update (Igel 2007) on a 5-D
rastrigin."""

from __future__ import annotations

from ... import base, benchmarks, cma, random
from ...algorithms import ea_generate_update

N, NGEN = 5, 150


def toolbox(strategy):
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def strategy_of(seed=10, device=None):
    """The strategy around a parent uniform in ``[-5, 5)`` from
    ``PRNGKey(seed)``."""
    parent = random.uniform(random.PRNGKey(seed, device=device), (N,),
                            minval=-5.0, maxval=5.0)
    return cma.StrategyOnePlusLambda(parent, sigma=5.0, lambda_=10,
                                     device=parent.device)


def run(seed=10, ngen=NGEN, device=None):
    """``(last population, final state)``: the loop runs from
    ``PRNGKey(seed + 1)``."""
    strategy = strategy_of(seed, device)
    pop, state, _ = ea_generate_update(
        random.PRNGKey(seed + 1, device=strategy.device), toolbox(strategy),
        strategy.init(), ngen=ngen, weights=(-1.0,))
    return pop, state


def main(seed=10, verbose=True, ngen=NGEN, device=None):
    """Returns the best rastrigin value of the last generation."""
    pop, _ = run(seed, ngen, device)
    best = float(pop.fitness.values.min())
    if verbose:
        print(f"best rastrigin value: {best:.4f}")
    return best


if __name__ == "__main__":
    main()
