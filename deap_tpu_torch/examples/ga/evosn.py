"""Evolving sorting networks — the port's counterpart of
``examples/ga/evosn.py`` (reference ``examples/ga/evosn.py``): a
3-objective NSGA-II GA over variable-length comparator lists,
minimising (sorting misses, network length, network depth) on 6 wires.

A network is :mod:`sortingnetwork`'s ``{"wires": (CAP, 2), "length"}``
genome.  Crossover swaps a two-point window inside the shared prefix;
mutation is the reference's three wire mutations (resample, insert,
delete) with their own firing probabilities, one key a row.  The
population is assessed on all 64 binary inputs at once.  With three
objectives and a pool of 600 rows, ``sel_nsga2`` ranks by the count
peel, whose dominance counts run in the ``rows_dominate_counts``
kernel on the card."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, random
from ...algorithms import evaluate_population, var_and
from ...ops import emo
from ...ops._dispatch import batched_op, rowwise_op
from . import sortingnetwork as sn

INPUTS = 6
CAP = 24
MIN_SIZE, MAX_SIZE = 9, 12
CXPB, MUTPB, INDPB, ADDPB, DELPB = 0.5, 0.2, 0.05, 0.01, 0.01


def rand_wires(key, shape):
    return random.randint(key, tuple(shape) + (2,), 0, INPUTS)


def make_evaluate(cases):
    """``evaluate(genome) -> (misses, length, depth)`` over a leading
    row axis, as float32."""
    def evaluate(g):
        levels, depth = sn.assign_levels(g["wires"], g["length"], CAP,
                                         INPUTS)
        misses = sn.assess(g["wires"], g["length"], cases, levels)
        return (misses.to(torch.float32), g["length"].to(torch.float32),
                depth.to(torch.float32))
    return batched_op(evaluate, evaluate)


def _where(m, a, b):
    return torch.where(m.reshape(m.shape + (1,) * (a.ndim - m.ndim)), a, b)


@rowwise_op
def mate(keys, a, b):
    """Two-point window swap within the shared prefix, a key a row
    (lengths are kept)."""
    size = torch.minimum(a["length"], b["length"])
    ks = random.split(keys)
    top = torch.clamp(size, min=1)
    c1 = random.randint(ks[:, 0], (), 0, top)
    c2 = random.randint(ks[:, 1], (), 0, top)
    lo = torch.minimum(c1, c2)[:, None]
    hi = torch.maximum(c1, c2)[:, None] + 1
    slot = torch.arange(CAP, device=keys.device)
    m = (slot >= lo) & (slot < hi)
    return (dict(wires=_where(m, b["wires"], a["wires"]),
                 length=a["length"]),
            dict(wires=_where(m, a["wires"], b["wires"]),
                 length=b["length"]))


@rowwise_op
def mutate(keys, g):
    """The reference's mutWire (w.p. ``MUTPB``, each active slot w.p.
    ``INDPB``), mutAddWire (``ADDPB``) and mutDelWire (``DELPB``, keeping
    one connector), a key a row."""
    ks = random.split(keys, 8)
    k_w, k_wp, k_wv, k_add, k_addp, k_addw, k_del, k_delp = (
        ks[:, i] for i in range(8))
    wires, length = g["wires"], g["length"]
    slot = torch.arange(CAP, device=keys.device)

    m = (random.bernoulli(k_wp, MUTPB)[:, None]
         & random.bernoulli(k_w, INDPB, (CAP,)) & (slot < length[:, None]))
    wires = _where(m, rand_wires(k_wv, (CAP,)), wires)

    do_add = random.bernoulli(k_addp, ADDPB) & (length < CAP)
    pos = random.randint(k_add, (), 0, length + 1)[:, None]
    src = torch.clamp(slot - 1, 0, CAP - 1)
    shifted = _where(slot > pos, wires[:, src], wires)
    shifted = _where(slot == pos, rand_wires(k_addw, ())[:, None, :],
                     shifted)
    wires = _where(do_add, shifted, wires)
    length = torch.where(do_add, length + 1, length)

    do_del = random.bernoulli(k_delp, DELPB) & (length > 1)
    dpos = random.randint(k_del, (), 0, torch.clamp(length, min=1))[:, None]
    dsrc = torch.clamp(slot + 1, 0, CAP - 1)
    deleted = _where(slot >= dpos, wires[:, dsrc], wires)
    wires = _where(do_del, deleted, wires)
    length = torch.where(do_del, length - 1, length)
    return dict(wires=wires, length=length)


def toolbox(device=None):
    tb = base.Toolbox()
    tb.register("evaluate", make_evaluate(sn.all_binary_cases(INPUTS,
                                                              device)))
    tb.register("mate", mate)
    tb.register("mutate", mutate)
    return tb


def generation(tb, key, pop):
    """One generation: ``(key, population)`` in and out."""
    key, k_var, k_sel = random.split(key, 3)
    off = var_and(k_var, pop, tb, cxpb=CXPB, mutpb=1.0)
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    return key, pool.take(emo.sel_nsga2(k_sel, pool.fitness, pop.size))


def run(seed=64, pop_size=300, ngen=40, device=None):
    """The final population."""
    key = random.PRNGKey(seed, device=device)
    tb = toolbox(key.device)
    key, k_w, k_l = random.split(key, 3)
    genome = dict(length=random.randint(k_l, (pop_size,), MIN_SIZE,
                                        MAX_SIZE + 1),
                  wires=rand_wires(k_w, (pop_size, CAP)))
    pop = base.Population(genome, base.Fitness.empty(
        pop_size, (-1.0, -1.0, -1.0), device=key.device))
    pop, _ = evaluate_population(tb, pop)
    for _ in range(ngen):
        key, pop = generation(tb, key, pop)
    return pop


def main(seed=64, pop_size=300, ngen=40, verbose=True, device=None):
    """The JAX example's run.  Returns ``(population, (misses, length,
    depth) of the best sorter)``: fewest misses, then shortest."""
    pop = run(seed, pop_size, ngen, device)
    vals = pop.fitness.values.cpu().numpy()
    b = np.lexsort((vals[:, 1], vals[:, 0]))[0]
    if verbose:
        wires = pop.genome["wires"][b].cpu().numpy()
        print(sn.draw(wires, int(vals[b, 1]), INPUTS))
        print(f"{int(vals[b, 0])} errors, length {int(vals[b, 1])}, "
              f"depth {int(vals[b, 2])}")
    return pop, vals[b]


if __name__ == "__main__":
    main()
