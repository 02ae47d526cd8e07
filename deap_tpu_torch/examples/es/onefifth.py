"""(1+1)-ES with the 1/5th success rule — the port's counterpart of
``examples/es/onefifth.py``: one parent, one Gaussian child a step, the
step size multiplied up on success and down on failure.

The JAX example runs the steps as one jitted scan and evaluates the
first parent outside it; XLA compiles the sphere two ways there (the
squares summed in order outside the scan, fused into the running sum
as multiply-adds inside it), the child's ``x + sigma z`` into one
multiply-add with the normal's scale ``sqrt 2`` folded into ``sigma``, and the division by the constant ``C`` into a multiply
by its float32 reciprocal.  The port takes each form
where the JAX example does, so the two runs are equal bit for bit and
the card's run equals the CPU's."""

from __future__ import annotations

import numpy as np
import torch

from ... import random
from ..._xla_math import fma, row_dot, row_sum

NDIM, NGEN = 10, 600
C = 0.817          # Rechenberg/Schwefel constant, reference onefifth.py
_UP = float(np.float32(1.0) / np.float32(C))        # XLA's x / C
_DOWN = float(np.float32(C ** 0.25))


def step(carry, key):
    """One step: ``(x, sigma, f(x))`` in and out."""
    x, sigma, fx = carry
    k_z = random.split(key, 1)[0]
    child = fma(sigma * random.SQRT2, random.normal_erf_inv(k_z, x.shape), x)
    fc = row_dot(child, child, fused=True)
    success = fc < fx
    x = torch.where(success, child, x)
    fx = torch.where(success, fc, fx)
    sigma = torch.where(success, sigma * _UP, sigma * _DOWN)
    return x, sigma, fx


def run(seed=8, ngen=NGEN, device=None):
    """The final ``(x, sigma, f(x))``."""
    key = random.PRNGKey(seed, device=device)
    k_init, key = random.split(key)
    x0 = random.uniform(k_init, (NDIM,), minval=-5.0, maxval=5.0)
    carry = (x0, torch.tensor(5.0, device=x0.device), row_sum(x0 * x0))
    for k in random.split(key, ngen):
        carry = step(carry, k)
    return carry


def main(seed=8, verbose=True, ngen=NGEN, device=None):
    """Returns the best fitness."""
    _, sigma, fx = run(seed, ngen, device)
    if verbose:
        print(f"best fitness {float(fx):.3e}, final sigma {float(sigma):.3e}")
    return float(fx)


if __name__ == "__main__":
    main()
