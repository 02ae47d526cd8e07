"""Symbolic regression under HARM-GP bloat control — the port's
counterpart of ``examples/gp/symbreg_harm.py`` (reference
``examples/gp/symbreg_harm.py``): the problem of :mod:`.symbreg`, evolved
with :func:`deap_tpu_torch.gp.harm` shaping the size distribution."""

from __future__ import annotations

from ... import gp, random
from .symbreg import build_pset, initial, mse_evaluate, points, target_of, \
    toolbox

CAP, POP, NGEN = 64, 128, 20


def main(seed=24, ngen=NGEN, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the final population."""
    ps = build_pset()
    key = random.PRNGKey(seed, device=device)
    X = points(20, key.device)[None, :]
    tb = toolbox(ps, mse_evaluate(ps, X, target_of(X[0])))
    key, pop = initial(ps, key, POP, 1, 3, (-1.0,))
    pop, _ = gp.harm(key, pop, tb, cxpb=0.5, mutpb=0.1, ngen=ngen,
                     alpha=0.05, beta=10, gamma=0.25, rho=0.9,
                     nbrindsmodel=1024, mincutoff=10)
    if verbose:
        print(f"best mse: {float(pop.fitness.values.min()):.5f}, "
              f"mean size: {float(pop.genome[2].float().mean()):.1f}/{CAP}")
    return pop


if __name__ == "__main__":
    main()
