"""PBIL — the port's counterpart of ``examples/eda/pbil.py``: a
probability vector over bits, nudged toward each generation's best
sample and mutated, on OneMax."""

from __future__ import annotations

from ... import base, random
from ...algorithms import ea_generate_update
from ...eda import PBIL

N_BITS, NGEN = 50, 100


def onemax(g):
    return g.sum(-1),


def toolbox(strategy):
    tb = base.Toolbox()
    tb.register("evaluate", onemax)
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def run(seed=19, ngen=NGEN, device=None):
    """``(last population, strategy state)``."""
    key = random.PRNGKey(seed, device=device)
    strategy = PBIL(ndim=N_BITS, learning_rate=0.3, mut_prob=0.1,
                    mut_shift=0.05, lambda_=20, seed=seed,
                    device=key.device)
    pop, state, _ = ea_generate_update(key, toolbox(strategy),
                                       strategy.init(), ngen=ngen,
                                       weights=(1.0,))
    return pop, state


def main(seed=19, verbose=True, ngen=NGEN, device=None):
    """Returns the best OneMax count of the last generation."""
    best = float(run(seed, ngen, device)[0].fitness.values.max())
    if verbose:
        print(f"best onemax: {best:.0f}/{N_BITS}")
    return best


if __name__ == "__main__":
    main()
