"""Shared machinery of the cooperative co-evolution progression — the
port's counterpart of ``examples/coev/coop_base.py`` (reference
``examples/coev/coop_base.py``, Potter & De Jong 2001 §4.2): species of
64-bit strings jointly form a match set, whose fitness against a target
set is the mean over the targets of its best member's matching bits.

A species is a ``(pop, 64)`` 0/1 matrix; an individual's score joined
with the other species' representatives is one broadcast equality count
(the representatives' best match per target, then the mean of the
maximum).  A round varies, scores, selects and elects every species in
a loop over the species under ``split(key, n_species)``, the keys the
JAX package's ``vmap`` over species takes, so the draws are the same."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ..._xla_math import row_mean
from ...algorithms import vary_genome
from ...ops import crossover, mutation, selection

IND_SIZE = 64
SPECIES_SIZE = 50

NOISE = "*##*###*###*****##*##****#*##*###*#****##******##*#**#*#**######"
SCHEMATAS = (
    "1##1###1###11111##1##1111#1##1###1#1111##111111##1#11#1#11######",
    "1##1###1###11111##1##1000#0##0###0#0000##000000##0#00#0#00######",
    "0##0###0###00000##0##0000#0##0###0#0000##001111##1#11#1#11######",
)


def schema_arrays(schema: str, device=None):
    """``(fixed_mask, fixed_vals)`` float32 tensors of a '#01' schema."""
    fixed = np.array([c in "01" for c in schema], np.float32)
    vals = np.array([1.0 if c == "1" else 0.0 for c in schema], np.float32)
    return (torch.tensor(fixed, device=device),
            torch.tensor(vals, device=device))


def init_target_set(key, schema: str, size: int):
    """Noisy strings honouring a schema's fixed positions (reference
    initTargetSet)."""
    fixed, vals = schema_arrays(schema, key.device)
    noise = random.bernoulli(key, 0.5, (size, IND_SIZE)).to(torch.float32)
    return torch.where(fixed > 0, vals, noise)


def target_set(key, schematas, size: int):
    """``size`` targets split evenly over ``schematas``, each block from
    ``fold_in(key, i)``."""
    per = size // len(schematas)
    return torch.cat([init_target_set(random.fold_in(key, i), s, per)
                      for i, s in enumerate(schematas)])


def match_strength(x, y):
    """Matching bits (reference matchStrength); broadcasts over leading
    axes."""
    return (x == y).to(torch.float32).sum(-1)


def match_set_strength(match_set, targets):
    """Mean over the targets of the best set member (reference
    matchSetStrength)."""
    m = match_strength(match_set[:, None, :], targets[None, :, :])
    return (row_mean(m.max(0).values),)


def match_set_strength_no_noise(match_set, targets, noise_str: str = NOISE):
    """Match strength counting only the non-noise positions (reference
    matchSetStrengthNoNoise)."""
    keep = torch.tensor([c == "*" for c in noise_str],
                        device=match_set.device)
    eq = (match_set[:, None, :] == targets[None, :, :]) & keep
    m = eq.to(torch.float32).sum(-1)
    return (row_mean(m.max(0).values),)


def species_fitness(species_genome, rep_rest, targets):
    """Every member of one species joined with the other species'
    representatives ``rep_rest`` ``(nrep, 64)`` (maybe none): ``(pop,)``
    scores."""
    ind_m = match_strength(species_genome[:, None, :], targets[None, :, :])
    if rep_rest.shape[0]:
        rep_m = match_strength(rep_rest[:, None, :], targets[None, :, :])
        ind_m = torch.maximum(ind_m, rep_m.max(0).values)
    return row_mean(ind_m)


def make_toolbox():
    """The progression's operators (reference coop_base.py:103-107)."""
    tb = base.Toolbox()
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=1.0 / IND_SIZE)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def init_species(key, n_species: int):
    """``(n_species, SPECIES_SIZE, IND_SIZE)`` random bit species."""
    return random.bernoulli(key, 0.5, (n_species, SPECIES_SIZE,
                                       IND_SIZE)).to(torch.float32)


def evolve_round(key, species, reps, targets, tb):
    """One round-robin pass: every species varies (cxpb 0.6, mutpb 1),
    is scored against the previous round's representatives of the
    others, tournament-selects and elects its best as its next
    representative.  ``species`` ``(S, pop, 64)``, ``reps`` ``(S, 64)``.
    Returns ``(species, reps, each species' best score)``."""
    n_species = species.shape[0]
    keys = random.split(key, n_species)
    out_s, out_r, out_f = [], [], []
    for i in range(n_species):
        k_var, k_sel = random.split(keys[i])
        s = species[i]
        varied, _ = vary_genome(k_var, s, tb, 0.6, 1.0)
        others = torch.cat([reps[:i], reps[i + 1:]])
        fit = species_fitness(varied, others, targets)
        idx = tb.select(k_sel, fit[:, None], s.shape[0])
        out_s.append(varied[idx.long()])
        out_r.append(varied[torch.argmax(fit)])
        out_f.append(fit.max())
    return torch.stack(out_s), torch.stack(out_r), torch.stack(out_f)
