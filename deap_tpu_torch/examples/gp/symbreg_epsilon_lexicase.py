"""Symbolic regression with automatic ε-lexicase selection — the port's
counterpart of ``examples/gp/symbreg_epsilon_lexicase.py`` (reference
``examples/gp/symbreg_epsilon_lexicase.py``): selection filters the
candidates one random training case at a time, keeping those within the
median absolute deviation of the case's best.

The evaluation is the per-case error vector ``(n_cases,)`` of each tree
(1e6 where not finite), registered as ``evaluate_population`` over the
whole batch; ε-lexicase runs on the ``(pop, n_cases)`` weighted case
matrix.
"""

from __future__ import annotations

import torch

from ... import gp, random
from ...algorithms import ea_simple
from ...ops import selection
from .symbreg import CAP, build_pset, initial, points, target_of, toolbox

POP, NGEN, N_CASES = 200, 30, 20


def case_errors(ps, X, target):
    """``errors(genome) -> (n, n_cases)``: each tree's absolute error on
    every case."""
    ev = gp.make_evaluator(ps, CAP)

    def errors(genome):
        out = ev(genome[0], genome[1], genome[2], X)
        err = (out - target).abs()
        return torch.where(torch.isfinite(err), err, 1e6)

    return errors


def main(seed=23, ngen=NGEN, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the final population."""
    ps = build_pset()
    key = random.PRNGKey(seed, device=device)
    X = points(N_CASES, key.device)[None, :]
    tb = toolbox(ps)
    tb.register("evaluate_population", case_errors(ps, X, target_of(X[0])))
    tb.register("select", lambda k, fit, n:
                selection.sel_automatic_epsilon_lexicase(
                    k, fit.masked_wvalues(), n))
    key, pop = initial(ps, key, POP, 1, 3, (-1.0,) * N_CASES)
    pop, _ = ea_simple(key, pop, tb, cxpb=0.5, mutpb=0.2, ngen=ngen)
    if verbose:
        total = pop.fitness.values.sum(dim=1)
        print(f"best total |err|: {float(total.min()):.4f} over "
              f"{N_CASES} cases")
    return pop


if __name__ == "__main__":
    main()
