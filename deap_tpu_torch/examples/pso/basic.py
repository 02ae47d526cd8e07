"""Basic gbest PSO — the port's counterpart of ``examples/pso/basic.py``:
particles with speed limits tracking personal and global bests,
minimizing Himmelblau's function (``benchmarks.himmelblau``, XLA's
form)."""

from __future__ import annotations

from ... import benchmarks, random
from ...pso import pso, pso_init

POP, NDIM, NGEN = 50, 2, 100
STEP = dict(phi1=2.0, phi2=2.0, smin=-3.0, smax=3.0)


def run(seed=13, ngen=NGEN, device=None):
    """The final swarm state."""
    key = random.PRNGKey(seed, device=device)
    k_init, key = random.split(key)
    state = pso_init(k_init, POP, NDIM, pmin=-6.0, pmax=6.0, smin=-3.0,
                     smax=3.0)
    state, _ = pso(key, state, benchmarks.himmelblau, ngen=ngen,
                   weights=(-1.0,), **STEP)
    return state


def main(seed=13, verbose=True, ngen=NGEN, device=None):
    """Returns the global best raw value (optimum 0)."""
    best = -float(run(seed, ngen, device).gbest_w)
    if verbose:
        print(f"global best after {ngen} gens: {best:.6f} (optimum 0)")
    return best


if __name__ == "__main__":
    main()
