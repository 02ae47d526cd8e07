"""6-multiplexer — the port's counterpart of ``examples/gp/multiplexer.py``
(reference ``examples/gp/multiplexer.py``): boolean GP, 2 address bits
select one of 4 data bits; the fitness is the number of correct outputs
over all 64 input combinations."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ... import gp, random
from ...algorithms import ea_simple
from ...ops._dispatch import batched_op
from .symbreg import initial, toolbox

CAP, POP, NGEN = 64, 300, 40
N_ADDR, N_DATA = 2, 4
N_IN = N_ADDR + N_DATA


def boolean_pset():
    ps = gp.PrimitiveSet("MUX", N_IN)
    for name in ("and_", "or_", "not_", "if_then_else"):
        fn, ar = gp.bool_ops[name]
        ps.add_primitive(fn, ar, name=name)
    ps.add_terminal(1.0, name="one")
    ps.add_terminal(0.0, name="zero")
    return ps


def run(seed=26, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card): ``(final population, best number of correct
    outputs)``."""
    ps = boolean_pset()
    key = random.PRNGKey(seed, device=device)
    rows = np.array(list(itertools.product([0, 1], repeat=N_IN)), np.float32)
    X = torch.from_numpy(rows.T.copy()).to(key.device)          # (6, 64)
    addr = (rows[:, :N_ADDR] @ np.array([2, 1])).astype(int)
    target = torch.from_numpy(rows[np.arange(64), N_ADDR + addr]).to(
        key.device)
    ev = gp.make_evaluator(ps, CAP)

    def evaluate(tree):
        out = ev(tree[0], tree[1], tree[2], X)
        correct = ((out != 0) == (target != 0)).sum(dim=-1)
        return (correct.to(torch.float32),)

    tb = toolbox(ps, batched_op(evaluate, evaluate), tournsize=7)
    key, pop = initial(ps, key, POP, 2, 4, (1.0,))
    pop, _ = ea_simple(key, pop, tb, cxpb=0.8, mutpb=0.1, ngen=ngen)
    return pop, float(pop.fitness.values.max())


def main(seed=26, ngen=NGEN, verbose=True, device=None):
    """:func:`run`'s best number of correct outputs."""
    best = run(seed, ngen, device)[1]
    if verbose:
        print(f"best: {best:.0f}/64 correct")
    return best


if __name__ == "__main__":
    main()
