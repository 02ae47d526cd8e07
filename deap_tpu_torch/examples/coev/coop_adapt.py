"""Cooperative co-evolution, the adaptation test — the port's
counterpart of ``examples/coev/coop_adapt.py`` (reference
``examples/coev/coop_adapt.py``, Potter & De Jong 2001 §4.2.3): start
with one species and add one every ``adapt_length`` species-steps, the
architecture growing to cover the three schemata."""

from __future__ import annotations

import torch

from ... import random
from . import coop_base as cb

TARGET_SIZE = 30
NGEN = 300
ADAPT_LENGTH = 100    # species-steps between species additions


def run(seed=4, ngen=NGEN, adapt_length=ADAPT_LENGTH, device=None):
    """``(species, representatives, targets)``: phases of a fixed
    species count, a fresh random species (and its first member as
    representative) added between them."""
    tb = cb.make_toolbox()
    key = random.PRNGKey(seed, device=device)
    key, k_t, k_s = random.split(key, 3)
    targets = cb.target_set(k_t, cb.SCHEMATAS, TARGET_SIZE)
    species = cb.init_species(k_s, 1)
    reps = species[:, 0]
    steps = 0
    while steps < ngen:
        n = species.shape[0]
        rounds = max(min(adapt_length, ngen - steps) // n, 1)
        key, k_p = random.split(key)
        for k in random.split(k_p, rounds):
            species, reps, _ = cb.evolve_round(k, species, reps, targets, tb)
        steps += rounds * n
        if steps < ngen:
            key, k_new = random.split(key)
            new = cb.init_species(k_new, 1)
            species = torch.cat([species, new])
            reps = torch.cat([reps, new[:, 0]])
    return species, reps, targets


def main(seed=4, ngen=NGEN, adapt_length=ADAPT_LENGTH, verbose=True,
         device=None):
    """Returns ``(representatives, their match-set strength)``."""
    species, reps, targets = run(seed, ngen, adapt_length, device)
    strength = float(cb.match_set_strength(reps, targets)[0])
    if verbose:
        for r in reps.cpu().numpy():
            print("".join(str(int(x)) for x, c in zip(r, cb.NOISE)
                          if c == "*"))
        print(f"{species.shape[0]} species; final set strength "
              f"{strength:.2f}/{cb.IND_SIZE}")
    return reps, strength


if __name__ == "__main__":
    main()
