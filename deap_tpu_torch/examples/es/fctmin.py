"""An evolution strategy on the sphere — the port's counterpart of
``examples/es/fctmin.py``: a (mu, lambda)-ES whose individuals carry
their own mutation strengths, varied by the ES blend crossover and the
log-normal strategy mutation (floored at ``MIN_STRATEGY``).

The genome is the dict ``{"strategy", "x"}`` of ``(pop, NDIM)`` leaves.
The variation wrappers are rowwise (one key a row through the
operators' key-batch form, as the JAX package's vmap over ``split``
keys), and the sphere is ``x``'s fused sum of squares, XLA's form of
``benchmarks.sphere`` at 30 genes, over the whole population."""

from __future__ import annotations

import torch

from ... import base, random
from ...algorithms import ea_mu_comma_lambda
from ..._xla_math import row_dot
from ...ops import crossover, mutation, selection
from ...ops._dispatch import batched_op, rowwise_op

MU, LAMBDA, NDIM, NGEN = 10, 100, 30, 120
MIN_STRATEGY = 0.001


@rowwise_op
def mate(keys, a, b):
    """The ES blend of two rows, unpacked as the JAX example unpacks it:
    ``(xa, xb), (sa, sb)`` of ``((x1, s1), (x2, s2))``, so the first
    child is ``{"x": x1, "strategy": x2}`` and the second ``{"x": s1,
    "strategy": s2}``."""
    (xa, xb), (sa, sb) = crossover.cx_es_blend(
        keys, (a["x"], a["strategy"]), (b["x"], b["strategy"]), alpha=0.1)
    return {"x": xa, "strategy": sa}, {"x": xb, "strategy": sb}


@rowwise_op
def mutate(keys, ind):
    x, s = mutation.mut_es_log_normal(keys, (ind["x"], ind["strategy"]),
                                      c=1.0, indpb=0.3)
    return {"x": x, "strategy": torch.clamp(s, min=MIN_STRATEGY)}


def evaluate(g):
    return row_dot(g["x"], g["x"]),


batched_op(evaluate, evaluate)


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", evaluate)
    tb.register("mate", mate)
    tb.register("mutate", mutate)
    tb.register("select", selection.sel_best)
    return tb


def initial(key):
    """``(key, population)``: ``x`` uniform in [-3, 3), strategies in
    [0.5, 3)."""
    k_x, k_s, key = random.split(key, 3)
    genome = {"x": random.uniform(k_x, (MU, NDIM), minval=-3.0, maxval=3.0),
              "strategy": random.uniform(k_s, (MU, NDIM), minval=0.5,
                                         maxval=3.0)}
    return key, base.Population(genome, base.Fitness.empty(
        MU, (-1.0,), device=key.device))


def main(seed=7, verbose=True, ngen=NGEN, device=None):
    """Returns ``(population, best sphere value)``."""
    key, pop = initial(random.PRNGKey(seed, device=device))
    pop, _ = ea_mu_comma_lambda(key, pop, toolbox(), mu=MU, lambda_=LAMBDA,
                                cxpb=0.6, mutpb=0.3, ngen=ngen)
    best = float(pop.fitness.values.min())
    if verbose:
        print(f"best sphere value: {best:.6f}")
    return pop, best


if __name__ == "__main__":
    main()
