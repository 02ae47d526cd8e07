"""Symbolic regression with Automatically Defined Functions — the port's
counterpart of ``examples/gp/adf_symbreg.py`` (reference
``examples/gp/adf_symbreg.py``): an individual is a main tree and one
ADF tree, evaluated by the nested stack machine of
:mod:`deap_tpu_torch.gp.adf`."""

from __future__ import annotations

import torch

from ... import base, gp, random
from ..._xla_math import row_mean
from ...algorithms import ea_simple
from ...ops import selection
from ...ops._dispatch import batched_op, rowwise_op
from .symbreg import points, target_of

CAP, POP, NGEN = 48, 200, 30


def build_psets():
    adf0 = gp.PrimitiveSet("ADF0", 2)
    for name in ("add", "sub", "mul"):
        fn, ar = gp.safe_ops[name]
        adf0.add_primitive(fn, ar, name=name)
    main_ps = gp.PrimitiveSet("MAIN", 1)
    for name in ("add", "sub", "mul", "div"):
        fn, ar = gp.safe_ops[name]
        main_ps.add_primitive(fn, ar, name=name)
    main_ps.add_ephemeral_constant(
        "rand101", lambda keys: random.randint(keys, (), -1, 2).float())
    main_ps.add_adf(adf0)
    main_ps.rename_arguments(ARG0="x")
    return main_ps, adf0


def main(seed=25, ngen=NGEN, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card).  Returns the final population."""
    main_ps, adf0 = build_psets()
    psets = (main_ps, adf0)
    key = random.PRNGKey(seed, device=device)
    X = points(20, key.device)[None, :]
    target = target_of(X[0])
    ev = gp.make_adf_population_evaluator(psets, CAP)
    gen_main = gp.make_generator(main_ps, CAP, "half_and_half")
    gen_adf = gp.make_generator(adf0, CAP, "half_and_half")
    mut_main = gp.make_generator(main_ps, CAP, "full")
    mut_adf = gp.make_generator(adf0, CAP, "full")

    def evaluate(trees):
        d = ev(trees, X) - target
        mse = row_mean(d * d)
        return (torch.where(torch.isfinite(mse), mse, 1e6),)

    @rowwise_op
    def mate(keys, a, b):
        """Crossover of each tree of the pair (the reference cycles
        cxOnePoint over the individual's trees)."""
        ks = random.split(keys)
        m0a, m0b = gp.cx_one_point(ks[:, 0], a[0], b[0], main_ps)
        a0a, a0b = gp.cx_one_point(ks[:, 1], a[1], b[1], adf0)
        return (m0a, a0a), (m0b, a0b)

    @rowwise_op
    def mutate(keys, trees):
        ks = random.split(keys)
        m = gp.mut_uniform(ks[:, 0], trees[0], lambda kk: mut_main(kk, 0, 2),
                           main_ps)
        a = gp.mut_uniform(ks[:, 1], trees[1], lambda kk: mut_adf(kk, 0, 2),
                           adf0)
        return (m, a)

    tb = base.Toolbox()
    tb.register("evaluate", batched_op(evaluate, evaluate))
    tb.register("mate", mate)
    tb.register("mutate", mutate)
    tb.register("select", selection.sel_tournament, tournsize=3)

    key, k_init = random.split(key)
    keys = random.split(k_init, POP)
    main_trees = gen_main(keys, 1, 2)
    adf_trees = gen_adf(random.fold_in(keys, 1), 1, 2)
    pop = base.Population((main_trees, adf_trees), base.Fitness.empty(
        POP, (-1.0,), device=key.device))
    pop, _ = ea_simple(key, pop, tb, cxpb=0.5, mutpb=0.2, ngen=ngen)
    if verbose:
        print(f"best mse: {float(pop.fitness.values.min()):.5f}")
    return pop


if __name__ == "__main__":
    main()
