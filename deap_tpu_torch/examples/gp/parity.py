"""Even parity — the port's counterpart of ``examples/gp/parity.py``
(reference ``examples/gp/parity.py``): boolean GP over and/or/xor/not on
``FANIN`` inputs; the fitness counts the matching rows of the full truth
table."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ... import gp, random
from ...algorithms import ea_simple
from ...ops._dispatch import batched_op
from .symbreg import initial, toolbox

CAP, POP, NGEN = 64, 300, 40
FANIN = 4
SIZE = 2 ** FANIN


def run(seed=27, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card): ``(final population, best number of matching
    rows)``."""
    ps = gp.PrimitiveSet("PARITY", FANIN)
    for name in ("and_", "or_", "xor_", "not_"):
        fn, ar = gp.bool_ops[name]
        ps.add_primitive(fn, ar, name=name)
    ps.add_terminal(1.0, name="one")
    ps.add_terminal(0.0, name="zero")
    key = random.PRNGKey(seed, device=device)
    rows = np.array(list(itertools.product([0, 1], repeat=FANIN)), np.float32)
    X = torch.from_numpy(rows.T.copy()).to(key.device)
    target = torch.from_numpy(rows.sum(1) % 2 == 0).to(key.device)
    ev = gp.make_evaluator(ps, CAP)

    def evaluate(tree):
        out = ev(tree[0], tree[1], tree[2], X)
        correct = ((out != 0) == target).sum(dim=-1)
        return (correct.to(torch.float32),)

    tb = toolbox(ps, batched_op(evaluate, evaluate), mut_kind="grow")
    key, pop = initial(ps, key, POP, 3, 5, (1.0,))
    pop, _ = ea_simple(key, pop, tb, cxpb=0.8, mutpb=0.15, ngen=ngen)
    return pop, float(pop.fitness.values.max())


def main(seed=27, ngen=NGEN, verbose=True, device=None):
    """:func:`run`'s best number of matching rows."""
    best = run(seed, ngen, device)[1]
    if verbose:
        print(f"best: {best:.0f}/{SIZE} truth-table rows correct")
    return best


if __name__ == "__main__":
    main()
