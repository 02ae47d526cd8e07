"""Symbolic regression of x⁴ + x³ + x² + x — the port's counterpart of
``examples/gp/symbreg.py`` (reference ``examples/gp/symbreg.py``, the
canonical GP workload).

Trees are prefix arrays; the example registers a per-tree ``evaluate``
built on :func:`~deap_tpu_torch.gp.make_evaluator`, which also takes a
batch of trees, as its own batched form, so the loop calls it once on
the population: the plain interpreter on every device, as the JAX
example runs on XLA and never in the kernel.  The data, the target and
the mean squared error are XLA's float32 forms (:func:`points`,
:func:`target_of`, and the mean as
:func:`~deap_tpu_torch._xla_math.row_mean`, the order XLA sums in
within the example's loop), so the run equals the JAX
example's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import base, gp, random
from ..._xla_math import fma, row_mean
from ...algorithms import ea_simple
from ...ops import selection
from ...ops._dispatch import batched_op
from ...utils.support import HallOfFame, Statistics

CAP, POP, NGEN = 64, 300, 40


def points(n: int = 20, device=None) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` as XLA's CPU backend computes it for
    the examples' 20 points: ``step = i * (1 / (n - 1))``, then
    ``fma(i, 1 * (1 / (n - 1)), -1 * (1 - step))``, then the end point."""
    div = n - 1
    r = float(np.float32(1.0 / div))
    i = torch.arange(div, dtype=torch.float32, device=device)
    head = fma(i, r, -(1.0 - i * r))
    return torch.cat([head, torch.ones(1, device=device)])


def target_of(x: torch.Tensor) -> torch.Tensor:
    """``x**4 + x**3 + x**2 + x`` as the JAX example computes it, one
    operation at a time (``x**4 = (x x)(x x)``, ``x**3 = x (x x)``)."""
    x2 = x * x
    return ((x2 * x2 + x * x2) + x2) + x


def build_pset():
    ps = gp.PrimitiveSet("MAIN", 1)
    ps.add_primitive(torch.add, 2, name="add")
    ps.add_primitive(torch.subtract, 2, name="sub")
    ps.add_primitive(torch.multiply, 2, name="mul")
    ps.add_primitive(gp.protected_div, 2, name="div")
    ps.add_primitive(torch.negative, 1, name="neg")
    ps.add_primitive(gp.cos, 1, name="cos")
    ps.add_primitive(gp.sin, 1, name="sin")
    ps.add_ephemeral_constant(
        "rand101", lambda keys: random.randint(keys, (), -1, 2).float())
    ps.rename_arguments(ARG0="x")
    return ps


def mse_evaluate(ps, X, target, cap: int = CAP):
    """The example's ``evaluate(tree) -> (mse,)`` (1e6 where not finite),
    registered as its own batched form."""
    ev = gp.make_evaluator(ps, cap)

    def evaluate(tree):
        out = ev(tree[0], tree[1], tree[2], X)
        d = out - target
        mse = row_mean(d * d)
        return (torch.where(torch.isfinite(mse), mse, 1e6),)

    return batched_op(evaluate, evaluate)


def toolbox(ps, evaluate=None, tournsize: int = 3, cap: int = CAP,
            mut_kind: str = "full"):
    """The examples' variation: ``cx_one_point`` and ``mut_uniform`` with
    a generator of depth 0-2, and a tournament; ``evaluate`` if given."""
    gen_mut = gp.make_generator(ps, cap, mut_kind)
    tb = base.Toolbox()
    if evaluate is not None:
        tb.register("evaluate", evaluate)
    tb.register("mate", gp.cx_one_point, pset=ps)
    tb.register("mutate", gp.mut_uniform,
                expr=lambda kk: gen_mut(kk, 0, 2), pset=ps)
    tb.register("select", selection.sel_tournament, tournsize=tournsize)
    return tb


def initial(ps, key, n: int, lo: int, hi: int, weights, cap: int = CAP):
    """``(key, population)``: the examples' key split and ``n``
    half-and-half trees of depth ``lo``-``hi`` (unevaluated)."""
    key, k_init = random.split(key)
    gen = gp.make_generator(ps, cap, "half_and_half")
    genome = gen(random.split(k_init, n), lo, hi)
    return key, base.Population(genome, base.Fitness.empty(
        n, weights, device=key.device))


def main(seed=22, ngen=NGEN, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the final population."""
    ps = build_pset()
    key = random.PRNGKey(seed, device=device)
    X = points(20, key.device)[None, :]
    tb = toolbox(ps, mse_evaluate(ps, X, target_of(X[0])))
    key, pop = initial(ps, key, POP, 1, 3, (-1.0,))
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    stats.register("avg", row_mean)
    hof = HallOfFame(1)
    pop, logbook = ea_simple(key, pop, tb, cxpb=0.5, mutpb=0.1, ngen=ngen,
                             stats=stats, halloffame=hof, verbose=False)
    if verbose:
        best_i = int(torch.argmin(pop.fitness.values[:, 0]))
        tree = tuple(t[best_i] for t in pop.genome)
        print(f"best mse: {float(pop.fitness.values.min()):.5f}")
        print("best expr:", gp.to_string(tree, ps))
    return pop


if __name__ == "__main__":
    main()
