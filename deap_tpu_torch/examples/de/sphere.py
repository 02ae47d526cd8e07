"""DE variants on the sphere — the port's counterpart of
``examples/de/sphere.py``: rand/1/bin, best/1/bin and rand/2/bin on a
20-D sphere, each from the same seed."""

from __future__ import annotations

from ...de import de
from .basic import initial, sphere, sphere_op_by_op

POP, NDIM, NGEN = 300, 20, 150
VARIANTS = ("rand/1/bin", "best/1/bin", "rand/2/bin")


def run(seed=16, variant="rand/1/bin", ngen=NGEN, device=None):
    """One variant's final population."""
    key, pop = initial(seed, NDIM, device)
    pop, _ = de(key, pop, sphere, ngen=ngen, cr=0.25, f=0.6,
                variant=variant, evaluate_initial=sphere_op_by_op)
    return pop


def main(seed=16, verbose=True, ngen=NGEN, device=None):
    """Returns ``{variant: best sphere value}``."""
    results = {v: float(run(seed, v, ngen, device).fitness.values.min())
               for v in VARIANTS}
    if verbose:
        for v, b in results.items():
            print(f"{v:12s} best: {b:.3e}")
    return results


if __name__ == "__main__":
    main()
