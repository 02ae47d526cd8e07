"""Canonical evolutionary loops — the PyTorch counterparts of
``deap_tpu/algorithms.py`` for the GA flagship: ``evaluate_population``,
``vary_genome``/``var_and``, the ``ea_ask``/``ea_tell``/``ea_step``
generation and ``ea_simple``.

The JAX package runs the whole loop as one ``lax.scan``; here it is a
Python loop over eager tensor code (and, under ``generation_engine =
"megakernel"``, one hand-written CUDA kernel per generation).  The
per-generation records stay on the device and are stacked once at the
end, so no generation waits on a host copy.

Toolbox protocol (as in the JAX package): ``evaluate(genome) -> tuple``
per individual (vmapped with ``torch.func.vmap``), ``mate(key, g1, g2)``,
``mutate(key, g)`` and ``select(key, fitness, k) -> indices``; operators
that advertise a ``.batched`` form get one key for the whole batch.

The ``live`` contract of the serving layer is kept: a bool ``(pop,)``
prefix mask whose pad rows never win selection (indices remap
``% live_n``), are never varied or evaluated, and are not counted.

Not ported yet: ``var_or`` and the mu±lambda loops, the hall of fame,
telemetry and streaming callbacks, quarantine, and the sharded and
streamed engines (they raise :class:`~deap_tpu_torch.engines.
EngineNotPorted`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from . import random
from .base import Fitness, Population, _leaves, _map
from .engines import require_ported, resolve_engine
from .utils.support import Logbook

__all__ = ["var_and", "vary_genome", "evaluate_population", "ea_ask",
           "ea_tell", "ea_step", "ea_simple", "varAnd", "eaSimple"]


def _where_rows(mask, new, old):
    def w(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return _map(w, new, old)


def _genome_storage(toolbox):
    from .ops.generation import storage_of
    return storage_of(toolbox)


def _widen_genome(storage, g):
    """Leaves in the declared narrow storage dtype become float32."""
    if storage is None or not storage.is_narrow:
        return g
    narrow = storage.torch_dtype
    return _map(lambda x: storage.to_compute(x) if x.dtype == narrow else x,
                g)


def _narrow_genome(storage, new, ref):
    """Leaves that were narrow in ``ref`` are narrowed again."""
    if storage is None or not storage.is_narrow:
        return new
    narrow = storage.torch_dtype
    return _map(lambda x, r: storage.to_storage(x) if r.dtype == narrow
                else x, new, ref)


def _batched_form(tool):
    """The operator's population-level form (one key, leading pop axis),
    or ``None`` when it has none, froze positional args, or is a
    decorated wrapper rather than the op the form belongs to."""
    fn = getattr(tool, "batched", None)
    if fn is None or getattr(tool, "args", ()):
        return None
    if getattr(fn, "base_op", None) is not getattr(tool, "func", tool):
        return None
    return partial(fn, **getattr(tool, "keywords", {}))


def _stack_rows(outs):
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack_rows([o[i] for o in outs])
                     for i in range(len(first)))
    return _map(lambda *xs: torch.stack(xs), first, *outs[1:])


def _apply_op(tool, key, n: int, *operands):
    """Apply a variation operator to an ``n``-row batch: its batched form
    with one key, else one call per row under ``split(key, n)`` (the JAX
    package's vmap over per-row keys, as a loop)."""
    batched = _batched_form(tool)
    if batched is not None:
        return batched(key, *operands)
    keys = random.split(key, n)
    return _stack_rows([tool(keys[i], *(_map(lambda x: x[i], o)
                                        for o in operands))
                        for i in range(n)])


def _norm_eval(evaluate):
    """Per-individual evaluate → flat ``(nobj,)`` float32 tensor."""
    def one(g):
        out = evaluate(g)
        if isinstance(out, (tuple, list)):
            return torch.stack([torch.as_tensor(o).to(torch.float32)
                                .reshape(()) for o in out])
        out = torch.as_tensor(out).to(torch.float32)
        return out.reshape(-1) if out.ndim else out.reshape(1)
    return one


def _no_quarantine(toolbox):
    if getattr(toolbox, "quarantine", None) is not None:
        raise NotImplementedError("toolbox.quarantine is not ported to "
                                  "deap_tpu_torch yet")


def evaluate_population(toolbox, population: Population):
    """Evaluate every row with ``toolbox.evaluate`` (vmapped) and assign
    the values where the fitness was invalid.  Returns ``(population,
    nevals)``."""
    _no_quarantine(toolbox)
    invalid = ~population.fitness.valid
    genome = _widen_genome(_genome_storage(toolbox), population.genome)
    values = torch.func.vmap(_norm_eval(toolbox.evaluate))(genome)
    nevals = invalid.sum()
    return population.evaluated(values, where=invalid), nevals


def var_and(key, population: Population, toolbox, cxpb: float,
            mutpb: float) -> Population:
    """varAnd: pairs mate with probability ``cxpb``, every row mutates
    with probability ``mutpb``; touched rows lose their fitness."""
    g, touched = vary_genome(key, population.genome, toolbox, cxpb, mutpb)
    return population.with_genome(g, invalidate_where=touched)


def vary_genome(key, g, toolbox, cxpb: float, mutpb: float):
    """Genome-level core of :func:`var_and`: ``(new_genome, touched)``.
    Rows ``(0,1), (2,3), ...`` mate."""
    n = _leaves(g)[0].shape[0]
    n2 = n // 2
    storage = _genome_storage(toolbox)
    g_ref = g
    g = _widen_genome(storage, g)
    k_cx, k_cxkeys, k_mut, k_mutkeys = random.split(key, 4)

    ga = _map(lambda x: x[0:2 * n2:2], g)
    gb = _map(lambda x: x[1:2 * n2:2], g)
    do_cx = random.bernoulli(k_cx, cxpb, (n2,))
    ca, cb = _apply_op(toolbox.mate, k_cxkeys, n2, ga, gb)
    ga = _where_rows(do_cx, ca, ga)
    gb = _where_rows(do_cx, cb, gb)
    paired = _map(lambda a, b: torch.stack([a, b], 1).reshape(
        (2 * n2,) + a.shape[1:]), ga, gb)
    touched = torch.repeat_interleave(do_cx, 2)
    if n % 2:
        g = _map(lambda p, orig: torch.cat([p, orig[2 * n2:]], 0), paired, g)
        touched = torch.cat([touched, torch.zeros(n - 2 * n2, dtype=torch.bool,
                                                  device=touched.device)])
    else:
        g = paired

    do_mut = random.bernoulli(k_mut, mutpb, (n,))
    mutated = _apply_op(toolbox.mutate, k_mutkeys, n, g)
    g = _where_rows(do_mut, mutated, g)
    return _narrow_genome(storage, g, g_ref), touched | do_mut


def ea_ask(key, population: Population, toolbox, cxpb: float, mutpb: float,
           *, live=None):
    """Selection + variation half of one :func:`ea_simple` generation:
    ``(key, offspring)`` with touched rows invalid and nothing evaluated.
    ``generation_engine = "megakernel"`` routes the whole half through
    the fused generation (:func:`deap_tpu_torch.ops.generation.
    fused_ea_step`) — the one routing point for every loop."""
    engine = require_ported(resolve_engine(toolbox))
    if engine == "megakernel":
        from .ops.generation import fused_ea_step
        return fused_ea_step(key, population, toolbox, cxpb, mutpb,
                             live=live)
    key, k_sel, k_var = random.split(key, 3)
    idx = toolbox.select(k_sel, population.fitness, population.size)
    if live is None:
        off = population.take(idx)
        return key, var_and(k_var, off, toolbox, cxpb, mutpb)
    live = live.to(torch.bool)
    live_n = torch.clamp(live.to(idx.dtype).sum(), min=1)
    idx = torch.where(idx < live_n, idx, idx % live_n)
    off = population.take(idx)
    g, touched = vary_genome(k_var, off.genome, toolbox, cxpb, mutpb)
    touched = touched & live
    g = _where_rows(live, g, population.genome)
    fit = off.fitness
    values = torch.where(live[:, None], fit.values, population.fitness.values)
    valid = live & fit.valid & ~touched
    return key, Population(g, dataclasses.replace(fit, values=values,
                                                  valid=valid))


def ea_tell(toolbox, population: Population, values=None, *, live=None):
    """Evaluation half: evaluate the invalid rows (``values=None``) or
    assign external ``values`` to them.  Returns ``(population, nevals)``;
    with ``live``, pad rows are skipped and come back invalid."""
    if live is None:
        if values is None:
            return evaluate_population(toolbox, population)
        _no_quarantine(toolbox)
        invalid = ~population.fitness.valid
        return population.evaluated(values, where=invalid), invalid.sum()
    live = live.to(torch.bool)
    fit = population.fitness
    guarded = Population(population.genome,
                         dataclasses.replace(fit, valid=fit.valid | ~live))
    out, nevals = ea_tell(toolbox, guarded, values)
    return Population(out.genome, dataclasses.replace(
        out.fitness, valid=out.fitness.valid & live)), nevals


def ea_step(key, population: Population, toolbox, cxpb: float, mutpb: float,
            *, live=None):
    """One full :func:`ea_simple` generation: ``(key, population,
    nevals)``."""
    key, off = ea_ask(key, population, toolbox, cxpb, mutpb, live=live)
    off, nevals = ea_tell(toolbox, off, live=live)
    return key, off, nevals


def _record(stats, population, nevals) -> dict:
    rec = dict(stats.compile(population)) if stats is not None else {}
    rec["nevals"] = nevals
    return rec


def _stack_records(records):
    return {k: torch.stack([torch.as_tensor(r[k]) for r in records])
            for k in records[0]}


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) and v.ndim == 0 else v


def ea_simple(key, population: Population, toolbox, cxpb: float, mutpb: float,
              ngen: int, stats=None, halloffame=None, verbose=False):
    """The simplest GA (reference eaSimple): per generation select, vary
    (:func:`var_and`) and evaluate — ``ngen`` calls of :func:`ea_step`.
    Returns ``(population, logbook)``.  Records stay on the device until
    the run ends."""
    require_ported(resolve_engine(toolbox))
    if halloffame is not None:
        raise NotImplementedError("HallOfFame is not ported to "
                                  "deap_tpu_torch yet")
    key, _ = random.split(key)
    population, nevals0 = evaluate_population(toolbox, population)
    rec0 = _record(stats, population, nevals0)
    records = []
    for _ in range(ngen):
        key, population, nevals = ea_step(key, population, toolbox, cxpb,
                                          mutpb)
        records.append(_record(stats, population, nevals))
    logbook = Logbook()
    logbook.header = ["gen", "nevals"] + (stats.fields if stats else [])
    logbook.record(gen=0, **{k: _scalar(v) for k, v in rec0.items()})
    if ngen > 0:
        logbook.record_stacked(gen=torch.arange(1, ngen + 1),
                               **_stack_records(records))
    if verbose:
        print(logbook.stream)
    return population, logbook


varAnd = var_and
eaSimple = ea_simple
