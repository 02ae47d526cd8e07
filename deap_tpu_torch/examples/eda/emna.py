"""EMNA — the port's counterpart of ``examples/eda/emna.py``: an ask/tell
loop re-estimating an isotropic Gaussian from the mu best of each
lambda-sample, on the sphere (its products fused into the sum, XLA's
form in the JAX example's loop)."""

from __future__ import annotations

from ... import base, random
from ...algorithms import ea_generate_update
from ...eda import EMNA
from ..de.basic import sphere

NDIM, NGEN = 5, 150


def toolbox(strategy):
    tb = base.Toolbox()
    tb.register("evaluate", sphere)
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def run(seed=18, ngen=NGEN, device=None):
    """``(last population, strategy state)``."""
    key = random.PRNGKey(seed, device=device)
    strategy = EMNA(centroid=[5.0] * NDIM, sigma=5.0, mu=25, lambda_=100,
                    device=key.device)
    pop, state, _ = ea_generate_update(key, toolbox(strategy),
                                       strategy.init(), ngen=ngen,
                                       weights=(-1.0,))
    return pop, state


def main(seed=18, verbose=True, ngen=NGEN, device=None):
    """Returns the best sphere value of the last generation."""
    best = float(run(seed, ngen, device)[0].fitness.values.min())
    if verbose:
        print(f"best sphere value: {best:.3e}")
    return best


if __name__ == "__main__":
    main()
