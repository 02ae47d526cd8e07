"""Differential evolution, rand/1/bin — the port's counterpart of
``examples/de/basic.py``: each agent's donor from three distinct
partners, binomial crossover, the better of agent and trial kept.

The sphere is evaluated in the forms XLA compiles for the JAX example:
the initial population op by op (products rounded, then summed in
order), the trials inside the scanned generation with each product
fused into the running sum (:func:`sphere`)."""

from __future__ import annotations

from ... import base, random
from ..._xla_math import row_dot
from ...de import de
from ...ops._dispatch import batched_op

POP, NDIM, NGEN = 300, 10, 200


def sphere(x):
    """``sum x²`` with each product fused into the sum (up to 32 genes;
    windows of 32 past that, unfused), over a leading row axis."""
    return row_dot(x, x, fused=x.shape[-1] <= 32),


batched_op(sphere, sphere)


def sphere_op_by_op(x):
    """``sum x²`` with the products rounded, then summed in XLA's order."""
    return row_dot(x, x, fused=False),


batched_op(sphere_op_by_op, sphere_op_by_op)


def initial(seed, ndim=NDIM, device=None):
    """``(key, population)``: genes uniform in [-3, 3)."""
    key = random.PRNGKey(seed, device=device)
    k_init, key = random.split(key)
    genome = random.uniform(k_init, (POP, ndim), minval=-3.0, maxval=3.0)
    return key, base.Population(genome, base.Fitness.empty(
        POP, (-1.0,), device=key.device))


def run(seed=15, ngen=NGEN, device=None):
    """The final population."""
    key, pop = initial(seed, device=device)
    return de(key, pop, sphere, ngen=ngen, cr=0.25, f=1.0,
              evaluate_initial=sphere_op_by_op)[0]


def main(seed=15, verbose=True, ngen=NGEN, device=None):
    """Returns the best sphere value."""
    best = float(run(seed, ngen, device).fitness.values.min())
    if verbose:
        print(f"best sphere value: {best:.3e}")
    return best


if __name__ == "__main__":
    main()
