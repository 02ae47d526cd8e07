"""CMA-ES minimisation — the port's counterpart of
``examples/es/cma_minfct.py``: the full (mu/mu_w, lambda) strategy
through the ask-tell ``ea_generate_update`` loop on a 5-D sphere, the
configuration of the reference's convergence test (best < 1e-8 after
100 generations)."""

from __future__ import annotations

from ... import base, benchmarks, cma, random
from ...algorithms import ea_generate_update

N, NGEN = 5, 100


def toolbox(strategy):
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def strategy_of(device=None):
    return cma.Strategy(centroid=[5.0] * N, sigma=5.0, lambda_=20,
                        device=device)


def run(seed=9, ngen=NGEN, device=None):
    """``(last population, final state)`` of the example's loop."""
    strategy = strategy_of(device)
    pop, state, _ = ea_generate_update(
        random.PRNGKey(seed, device=strategy.device), toolbox(strategy),
        strategy.init(), ngen=ngen, weights=(-1.0,))
    return pop, state


def main(seed=9, verbose=True, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the best value of the last
    generation."""
    pop, _ = run(seed, ngen, device)
    best = float(pop.fitness.values.min())
    if verbose:
        print(f"best: {best:.3e} (test gate < 1e-8)")
    return best


if __name__ == "__main__":
    main()
