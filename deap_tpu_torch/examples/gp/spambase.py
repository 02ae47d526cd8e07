"""Spam classification by GP — the port's counterpart of
``examples/gp/spambase.py`` (reference ``examples/gp/spambase.py``):
evolve a real-valued expression over the features; an email is spam
where the expression is positive, and the fitness is the accuracy.

It reads the UCI spambase CSV when a path is given; otherwise it makes
the JAX example's synthetic data from ``numpy.random.RandomState(seed)``,
so nothing is downloaded.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ... import gp, random
from ..._xla_math import row_mean
from ...algorithms import ea_simple
from ...ops._dispatch import batched_op
from .symbreg import initial, toolbox

CAP, POP, NGEN, N_FEAT, N_SAMPLES = 96, 200, 30, 10, 400


def load_data(path=None, seed=0):
    """``(X (n_samples, n_feat), y (n_samples,))`` float32 numpy arrays."""
    if path and os.path.exists(path):
        data = np.loadtxt(path, delimiter=",")
        X, y = data[:, :-1], data[:, -1]
        return X.astype(np.float32), y.astype(np.float32)
    rng = np.random.RandomState(seed)
    w = rng.randn(N_FEAT)
    X = rng.randn(N_SAMPLES, N_FEAT).astype(np.float32)
    logits = X @ w + 0.3 * rng.randn(N_SAMPLES)
    return X, (logits > 0).astype(np.float32)


def run(seed=28, ngen=NGEN, path=None, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card): ``(final population, best accuracy)``."""
    Xh, yh = load_data(path, seed)
    n_feat = Xh.shape[1]
    key = random.PRNGKey(seed, device=device)
    X = torch.from_numpy(Xh.T.copy()).to(key.device)   # (n_feat, n_samples)
    y = torch.from_numpy(yh).to(key.device)
    ps = gp.PrimitiveSet("SPAM", n_feat)
    for name in ("add", "sub", "mul", "div"):
        fn, ar = gp.safe_ops[name]
        ps.add_primitive(fn, ar, name=name)
    ps.add_ephemeral_constant(
        "rand", lambda keys: random.uniform(keys, (), minval=-1.0,
                                            maxval=1.0))
    ev = gp.make_evaluator(ps, CAP)

    def evaluate(tree):
        out = ev(tree[0], tree[1], tree[2], X)
        acc = row_mean(((out > 0) == (y > 0.5)).to(torch.float32))
        return (torch.where(torch.isfinite(acc), acc, 0.0),)

    tb = toolbox(ps, batched_op(evaluate, evaluate), cap=CAP)
    key, pop = initial(ps, key, POP, 1, 3, (1.0,), cap=CAP)
    pop, _ = ea_simple(key, pop, tb, cxpb=0.6, mutpb=0.2, ngen=ngen)
    return pop, float(pop.fitness.values.max())


def main(seed=28, ngen=NGEN, path=None, verbose=True, device=None):
    """:func:`run`'s best accuracy."""
    best = run(seed, ngen, path, device)[1]
    if verbose:
        print(f"best classification accuracy: {best:.3f}")
    return best


if __name__ == "__main__":
    main()
