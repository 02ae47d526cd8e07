"""Cooperative co-evolution — the port's counterpart of
``examples/coev/coop_evol.py``: four species each evolve one segment of
a concatenated OneMax; an individual is scored by joining it with the
other species' representatives."""

from __future__ import annotations

import torch

from ... import base, random
from ...coev import ea_cooperative
from ...ops import crossover, mutation, selection
from ...ops._dispatch import batched_op

N_SPECIES, POP, SEG_BITS, NGEN = 4, 50, 25, 60


def collaboration_ones(collab):
    """The collaboration's count of ones, over a leading row axis."""
    return collab.reshape(collab.shape[0], -1).sum(-1),


def collaboration_ones_one(collab):
    """One collaboration set ``(N_SPECIES, SEG_BITS)``."""
    return collab.sum(),


batched_op(collaboration_ones_one, collaboration_ones)


def toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", collaboration_ones_one)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def initial(seed, device=None):
    """``(key, species)``: bits at ``(N_SPECIES, POP, SEG_BITS)``."""
    key = random.PRNGKey(seed, device=device)
    k_init, key = random.split(key)
    genome = random.bernoulli(k_init, 0.5, (N_SPECIES, POP, SEG_BITS)).to(
        torch.float32)
    dev = key.device
    return key, base.Population(genome, base.Fitness(
        torch.zeros((N_SPECIES, POP, 1), device=dev),
        torch.zeros((N_SPECIES, POP), dtype=torch.bool, device=dev),
        (1.0,)))


def run(seed=20, ngen=NGEN, device=None):
    """``(species, representatives)``."""
    key, species = initial(seed, device)
    species, reps, _ = ea_cooperative(key, species, toolbox(), cxpb=0.6,
                                      mutpb=0.3, ngen=ngen)
    return species, reps


def main(seed=20, verbose=True, ngen=NGEN, device=None):
    """Returns the representatives' collaboration fitness."""
    total = float(run(seed, ngen, device)[1].sum())
    if verbose:
        print(f"representative collaboration fitness: "
              f"{total:.0f}/{N_SPECIES * SEG_BITS}")
    return total


if __name__ == "__main__":
    main()
