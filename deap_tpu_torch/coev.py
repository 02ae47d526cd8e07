"""Co-evolution — the port's counterpart of ``deap_tpu/coev.py``:
cooperative (Potter & De Jong) and competitive (Hillis).

* :func:`ea_cooperative` — species stacked on a leading axis; each
  generation varies, evaluates and selects every species, scoring an
  individual on the collaboration set formed by substituting it for its
  species' representative.  JAX vmaps the species step over
  ``split(k, nspecies)``; here a loop over the species takes the same
  keys and draws the same numbers (``nspecies`` is small).
* :func:`ea_host_parasite` — two populations with opposite objectives
  scored pairwise through one encounter function.

Both loops print the logbook's stream themselves when ``verbose``.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import random
from .algorithms import _logbook, _record, evaluate_rows, var_and
from .base import Fitness, Population, _leaves, _map

__all__ = ["ea_cooperative", "ea_host_parasite"]


def ea_cooperative(key, species: Population, toolbox, cxpb: float,
                   mutpb: float, ngen: int, stats=None, verbose=False):
    """Cooperative co-evolution (reference coop_evol.py main loop).

    ``species`` is a stacked :class:`Population`: genome leaves
    ``(nspecies, pop, ...)``, fitness ``(nspecies, pop, nobj)``.
    ``toolbox.evaluate(collab)`` scores a collaboration set of shape
    ``(nspecies, ...)``, one member a species (called on ``(pop,
    nspecies, ...)`` sets at once when it has a batched form).  Each
    generation, per species: :func:`var_and`, evaluation against the
    other species' representatives, ``toolbox.select``; the
    representatives then become each species' best (the first maximum)
    for the next generation.  The first representatives are row 0 of
    each species.  Returns ``(species, representatives, logbook)``."""
    nspecies = _leaves(species.genome)[0].shape[0]
    weights = species.fitness.weights

    def species_step(key, pop_i: Population, idx: int, reps):
        k_var, k_sel = random.split(key)
        pop_i = var_and(k_var, pop_i, toolbox, cxpb, mutpb)
        n = pop_i.size

        def collab(r, g):
            c = r[None].expand((n,) + r.shape).clone()
            c[:, idx] = g
            return c
        vals = evaluate_rows(toolbox.evaluate,
                             _map(collab, reps, pop_i.genome))
        pop_i = pop_i.evaluated(vals)
        pop_i = pop_i.take(toolbox.select(k_sel, pop_i.fitness, n))
        best = torch.argmax(pop_i.fitness.masked_wvalues()[:, 0])
        return pop_i, _map(lambda g: g[best], pop_i.genome)

    reps = _map(lambda g: g[:, 0], species.genome)
    records = []
    for _ in range(ngen):
        key, k = random.split(key)
        keys = random.split(k, nspecies)
        outs = [species_step(keys[i], Population(
            _map(lambda g: g[i], species.genome),
            Fitness(species.fitness.values[i], species.fitness.valid[i],
                    weights)), i, reps) for i in range(nspecies)]
        species = Population(
            _map(lambda *gs: torch.stack(gs), *(o[0].genome for o in outs)),
            Fitness(torch.stack([o[0].fitness.values for o in outs]),
                    torch.stack([o[0].fitness.valid for o in outs]),
                    weights))
        reps = _map(lambda *rs: torch.stack(rs), *(o[1] for o in outs))
        if stats is None:
            records.append({})
            continue
        flat = Population(
            _map(lambda g: g.reshape((-1,) + g.shape[2:]), species.genome),
            Fitness(species.fitness.values.reshape(
                        -1, species.fitness.values.shape[-1]),
                    species.fitness.valid.reshape(-1), weights))
        records.append(dict(stats.compile(flat)))
    return species, reps, _logbook(stats, None, records, ngen, verbose,
                                   nevals=False)


def ea_host_parasite(key, hosts: Population, parasites: Population,
                     htoolbox, ptoolbox, encounter: Callable,
                     cxpb: float, mutpb: float, ngen: int,
                     stats=None, verbose=False):
    """Competitive host–parasite co-evolution (reference
    examples/coev/hillis.py): both populations vary each generation, then
    host ``i`` meets parasite ``i`` through ``encounter(host, parasite)
    -> scalar`` (its batched form on the two populations when it has
    one, else vmapped); the raw value goes to both sides, whose weights
    give it opposite signs.  The populations must be the same size.
    Returns ``(hosts, parasites, logbook)``."""
    if hosts.size != parasites.size:
        raise ValueError("host and parasite populations must be equal size")
    records = []
    for _ in range(ngen):
        ks = random.split(key, 5)
        key, kh, kp, ksh, ksp = ks[0], ks[1], ks[2], ks[3], ks[4]
        h = var_and(kh, hosts, htoolbox, cxpb, mutpb)
        p = var_and(kp, parasites, ptoolbox, cxpb, mutpb)
        vals = evaluate_rows(encounter, h.genome, p.genome)
        h, p = h.evaluated(vals), p.evaluated(vals)
        hosts = h.take(htoolbox.select(ksh, h.fitness, h.size))
        parasites = p.take(ptoolbox.select(ksp, p.fitness, p.size))
        records.append(_record(stats, hosts, hosts.size))
    return hosts, parasites, _logbook(stats, None, records, ngen, verbose)
