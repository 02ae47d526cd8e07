"""Cooperative co-evolution, the generalisation test — the port's
counterpart of ``examples/coev/coop_gen.py`` (reference
``examples/coev/coop_gen.py``, Potter & De Jong 2001 §4.2.2):
``NUM_SPECIES`` species cooperate to cover three noisy schemata; an
individual is scored joined with the other species' representatives
of the previous round."""

from __future__ import annotations

from ... import random
from . import coop_base as cb

NUM_SPECIES = 4
TARGET_SIZE = 30
NGEN = 150            # species-steps, like the reference's g counter


def run(seed=2, num_species=NUM_SPECIES, ngen=NGEN, device=None):
    """``(species, representatives, targets)`` after ``ngen //
    num_species`` rounds."""
    tb = cb.make_toolbox()
    key = random.PRNGKey(seed, device=device)
    key, k_t, k_s, _ = random.split(key, 4)
    targets = cb.target_set(k_t, cb.SCHEMATAS, TARGET_SIZE)
    species = cb.init_species(k_s, num_species)
    reps = species[:, 0]
    for k in random.split(key, ngen // num_species):
        species, reps, _ = cb.evolve_round(k, species, reps, targets, tb)
    return species, reps, targets


def main(seed=2, num_species=NUM_SPECIES, ngen=NGEN, verbose=True,
         device=None):
    """Returns ``(representatives, their match-set strength)``."""
    _, reps, targets = run(seed, num_species, ngen, device)
    strength = float(cb.match_set_strength(reps, targets)[0])
    if verbose:
        for r in reps.cpu().numpy():
            print("".join(str(int(x)) for x, c in zip(r, cb.NOISE)
                          if c == "*"))
        print(f"final representative set strength: "
              f"{strength:.2f}/{cb.IND_SIZE}")
    return reps, strength


if __name__ == "__main__":
    main()
