"""Species-based PSO — the port's counterpart of
``examples/pso/speciation.py`` (reference
``examples/pso/speciation.py``, Li 2004): each generation the particles
are sorted by fitness and grouped greedily into species around the best
unclaimed particle (the seed) within a radius; each species flies
toward its seed, and the redundant members of crowded species are
re-randomised.  The greedy assignment is a loop over the sorted swarm
(sequential by definition); the rest is tensor code over the swarm."""

from __future__ import annotations

import numpy as np
import torch

from ... import benchmarks, random
from ..._xla_math import fma, sqrt

POP, NDIM, NGEN = 60, 2, 80
RS = 1.5                     # species radius
PMIN, PMAX = -6.0, 6.0
MINIMA = np.array([[3.0, 2.0], [-2.805118, 3.131312],
                   [-3.779310, -3.283186], [3.584428, -1.848126]])


def assign_species(positions, order):
    """``seed[i]``: the index of particle ``i``'s species seed, greedy
    over the fitness-sorted ``order``."""
    n = positions.shape[0]
    seeds = torch.full((n,), -1, dtype=torch.int32,
                       device=positions.device)
    diff = positions[None, :, :] - positions[:, None, :]
    # row i: |x_j - x_i| for every j, the square root of a fused sum
    dist = sqrt(fma(diff[..., 0], diff[..., 0], diff[..., 1] * diff[..., 1]))
    near = dist <= RS
    for i in order.tolist():
        seeds = torch.where(near[i] & (seeds < 0) & (seeds[i] < 0), i, seeds)
    return seeds


def evaluate(pos):
    """``-himmelblau`` of every particle (maximised)."""
    return -benchmarks.himmelblau(pos)[0]


def step(key, pos, spd):
    """One generation: ``(positions, speeds, fitness, seeds)``."""
    fit = evaluate(pos)
    order = torch.sort(-fit, stable=True).indices
    seeds = assign_species(pos, order)
    seed_pos = pos[seeds.long()]
    ks = random.split(key, 4)
    u1 = random.uniform(ks[0], (POP, NDIM))
    u2 = random.uniform(ks[1], (POP, NDIM))
    pull = seed_pos - pos
    spd = 0.729 * fma(2.05 * u2, pull, fma(2.05 * u1, pull, spd))
    spd = torch.clamp(spd, -2.0, 2.0)
    pos = torch.clamp(pos + spd, PMIN, PMAX)
    sizes = (seeds[:, None] == seeds[None, :]).sum(1)
    crowd = (sizes > 8) & (torch.arange(POP, device=pos.device) != seeds)
    fresh = random.uniform(ks[2], (POP, NDIM), minval=PMIN, maxval=PMAX)
    pick = crowd[:, None] & (random.uniform(ks[3], (POP, 1)) < 0.2)
    return torch.where(pick, fresh, pos), spd, fit, seeds


def run(seed=30, ngen=NGEN, device=None):
    """``(positions, speeds, species counts a generation)`` after
    ``ngen`` generations."""
    key = random.PRNGKey(seed, device=device)
    k_p, k_s, key = random.split(key, 3)
    pos = random.uniform(k_p, (POP, NDIM), minval=PMIN, maxval=PMAX)
    spd = random.uniform(k_s, (POP, NDIM), minval=-2.0, maxval=2.0)
    counts = []
    for _ in range(ngen):
        key, k = random.split(key)
        pos, spd, _, seeds = step(k, pos, spd)
        counts.append(int(torch.unique(seeds).shape[0]))
    return pos, spd, counts


def minima_found(pos) -> int:
    """How many of Himmelblau's four minima a particle lies within 0.5
    of."""
    final = pos.cpu().numpy()
    return sum(bool(np.any(np.linalg.norm(final - m, axis=1) < 0.5))
               for m in MINIMA)


def main(seed=30, verbose=True, ngen=NGEN, device=None):
    """Returns how many of Himmelblau's four minima a particle is within
    0.5 of at the end."""
    pos, _, counts = run(seed, ngen, device)
    found = minima_found(pos)
    if verbose:
        print(f"species at end: {counts[-1]}, "
              f"distinct Himmelblau minima located: {found}/4")
    return found


if __name__ == "__main__":
    main()
