"""Cooperative co-evolution, the niching test — the port's counterpart
of ``examples/coev/coop_niche.py`` (reference
``examples/coev/coop_niche.py``, Potter & De Jong 2001 §4.2.1):
``TARGET_TYPE`` species must specialise, each covering its own
all-ones segment of the 64-bit string."""

from __future__ import annotations

import torch

from ... import random
from . import coop_base as cb

TARGET_TYPE = 2
TARGET_SIZE = 200
NGEN = 200            # species-steps


def niche_schematas(type_: int, size: int):
    """'1'-segment schemata (reference nicheSchematas)."""
    rept = size // type_
    return ["#" * (i * rept) + "1" * rept + "#" * ((type_ - i - 1) * rept)
            for i in range(type_)]


def run(seed=3, target_type=TARGET_TYPE, ngen=NGEN, device=None):
    """``(species, representatives)`` after ``ngen // target_type``
    rounds."""
    tb = cb.make_toolbox()
    key = random.PRNGKey(seed, device=device)
    key, k_t, k_s = random.split(key, 3)
    targets = cb.target_set(k_t, niche_schematas(target_type, cb.IND_SIZE),
                            TARGET_SIZE)
    species = cb.init_species(k_s, target_type)
    reps = species[:, 0]
    for k in random.split(key, ngen // target_type):
        species, reps, _ = cb.evolve_round(k, species, reps, targets, tb)
    return species, reps


def coverage(reps, target_type=TARGET_TYPE):
    """Each schema's best coverage of its fixed segment by a
    representative."""
    out = []
    for schema in niche_schematas(target_type, cb.IND_SIZE):
        fixed, vals = cb.schema_arrays(schema, reps.device)
        match = ((reps == vals) & (fixed > 0)).sum(1)
        out.append(float(match.max() / fixed.sum()))
    return out


def main(seed=3, target_type=TARGET_TYPE, ngen=NGEN, verbose=True,
         device=None):
    """Returns ``(representatives, per-schema coverage)``."""
    _, reps = run(seed, target_type, ngen, device)
    cov = coverage(reps, target_type)
    if verbose:
        for r in reps.cpu().numpy():
            print("".join(str(int(x)) for x in r))
        print("per-schema best coverage:",
              " ".join(f"{c:.2f}" for c in cov))
    return reps, cov


if __name__ == "__main__":
    main()
