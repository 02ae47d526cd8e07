"""Feature selection for kNN by a multi-objective GA — the port's
counterpart of ``examples/ga/evoknn.py``: maximize the classification
rate, minimize the share of features used; ``ea_mu_plus_lambda`` with
``sel_nsga2``, uniform crossover and bit-flip mutation over 0/1 masks.
The evaluation is one :func:`~.knn.knn_accuracy` call on the whole
population (its batched form)."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ...algorithms import ea_mu_plus_lambda, evaluate_population
from ..._xla_math import row_sum
from ...ops import crossover, emo, mutation
from ...ops._dispatch import batched_op
from .knn import N_FEATURES, N_TRAIN, knn_accuracy, make_dataset

MU, LAMBDA, NGEN = 100, 200, 40
CXPB, MUTPB = 0.7, 0.3


def make_evaluate(data, share: bool = True, in_loop: bool = True):
    """``(accuracy, selected features)`` of each mask: the share of the
    features (``share``) or their count.  XLA compiles the share two
    ways in the JAX example's jitted loop: a division by 13 in the
    initial evaluation, a multiply by the float32 reciprocal inside the
    scanned generation (``in_loop``)."""
    train_x, train_y, test_x, test_y = data
    inv = float(np.float32(1.0 / N_FEATURES))

    def evaluate(mask):
        acc = knn_accuracy(mask, train_x, train_y, test_x, test_y)
        used = row_sum(mask)
        if not share:
            return acc, used
        if in_loop:
            return acc, used * inv
        # a divisor tensor: the card divides by a Python number as a
        # multiply by its reciprocal
        return acc, used / torch.full_like(used, float(N_FEATURES))
    return batched_op(evaluate, evaluate)


def split_data(device=None):
    X, y = make_dataset(device=device)
    return X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]


def run(seed, ngen, mu, lambda_, cxpb, mutpb, share, weights, device=None):
    """The evoknn loop from ``PRNGKey(seed)``: ``(population,
    logbook)``."""
    key = random.PRNGKey(seed, device=device)
    data = split_data(key.device)
    tb = base.Toolbox()
    tb.register("evaluate", make_evaluate(data, share))
    tb.register("mate", crossover.cx_uniform, indpb=0.1)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", emo.sel_nsga2)
    key, k_init = random.split(key)
    genome = random.bernoulli(k_init, 0.5, (mu, N_FEATURES)).float()
    pop = base.Population(genome, base.Fitness.empty(mu, weights,
                                                     device=key.device))
    first = base.Toolbox()
    first.register("evaluate", make_evaluate(data, share, in_loop=False))
    pop, _ = evaluate_population(first, pop)
    return ea_mu_plus_lambda(key, pop, tb, mu=mu, lambda_=lambda_,
                             cxpb=cxpb, mutpb=mutpb, ngen=ngen)


def main(seed=64, ngen=NGEN, verbose=True, device=None):
    """Returns ``(population, the most accurate row's values)``."""
    pop, _ = run(seed, ngen, MU, LAMBDA, CXPB, MUTPB, True, (1.0, -1.0),
                 device)
    vals = pop.fitness.values.cpu().numpy()
    best = vals[np.argmax(vals[:, 0])]
    if verbose:
        print(f"best accuracy {best[0]:.3f} using "
              f"{best[1] * N_FEATURES:.0f}/{N_FEATURES} features")
    return pop, best


if __name__ == "__main__":
    main()
