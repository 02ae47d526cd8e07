"""Canonical evolutionary loops — the PyTorch counterparts of
``deap_tpu/algorithms.py``: ``evaluate_population``,
``vary_genome``/``var_and``, ``var_or``, the ``ea_ask``/``ea_tell``/
``ea_step`` generation, ``ea_simple``, the (mu + lambda) / (mu,
lambda) loops and the ask-tell loop ``ea_generate_update``; every loop
takes a ``halloffame`` (a :class:`~deap_tpu_torch.utils.support.
HallOfFame` or ``ParetoFront``) and updates it where the JAX package
does.

The JAX package runs the whole loop as one ``lax.scan``; here it is a
Python loop over eager tensor code (and, under ``generation_engine =
"megakernel"``, hand-written CUDA kernels: K2 for the GA, K3 for
``var_or``, K1 for the NSGA-II head of ``ea_ask``).  The
per-generation records stay on the device and are stacked once at the
end, so no generation waits on a host copy.

Toolbox protocol (as in the JAX package): ``evaluate(genome) -> tuple``
per individual (vmapped with ``torch.func.vmap``) or a population-level
``evaluate_population(genome, skip=...)``, ``mate(key, g1, g2)``,
``mutate(key, g)`` and ``select(key, fitness, k) -> indices``; operators
that advertise a ``.batched`` form get one key for the whole batch, and
``rowwise_op`` operators (the GP ones) one key per row in one call.

The ``live`` contract of the serving layer is kept: a bool ``(pop,)``
prefix mask whose pad rows never win selection (indices remap
``% live_n``), are never varied or evaluated, and are not counted.

``stream_every=k`` prints one line a ``k`` generations while a loop
runs (``gen=K`` and the sorted, flattened record, as the JAX package
prints it); each line is one host read of that generation's record.

A population sharded over a mesh (:class:`~deap_tpu_torch.parallel.
ShardedPopulation`, this rank's block of rows) runs the same loops
SPMD: every rank calls them together.  Each rank evaluates and varies
only its own rows, drawing its rows of every population-wide draw
(:func:`deap_tpu_torch.random.row_range`); selection runs on every rank
on one gathered fitness table, and the parents arrive through one
genome all-gather a generation.  Records and the hall of fame see the
gathered population, so they are equal on every rank, and the whole
trajectory equals the single-card one whatever the rank count.  The
``megakernel_sharded`` engine (or ``megakernel`` plus
``toolbox.generation_mesh``) routes to
:mod:`deap_tpu_torch.ops.generation_sharded`.

``generation_engine = "streamed"`` routes :func:`ea_ask` and
:func:`ea_step` to :mod:`deap_tpu_torch.bigpop`'s streamed generation
(the genome in host RAM, a slice at a time on the card) and
:func:`ea_simple` to its host loop, :func:`~deap_tpu_torch.bigpop.
streamed_ea_simple`; the trajectory is the resident one, bit for bit.

A ``toolbox.quarantine`` (:class:`deap_tpu_torch.resilience.Quarantine`,
or anything with an ``apply(population, newly=mask)`` method) is applied
to the freshly assigned rows of every evaluation, as in the JAX package.

Not ported yet: the loops' ``telemetry`` argument (with the tooling).
"""

from __future__ import annotations

import dataclasses
import inspect
from functools import partial

import numpy as np
import torch

from . import random
from .base import Fitness, Population, _leaves, _map
from .engines import require_ported, resolve_engine
from .utils.support import Logbook

__all__ = ["var_and", "vary_genome", "var_or", "evaluate_population",
           "ea_ask", "ea_tell", "ea_step", "ea_simple", "ea_mu_plus_lambda",
           "ea_mu_comma_lambda", "ea_generate_update", "varAnd", "varOr",
           "eaSimple", "eaMuPlusLambda", "eaMuCommaLambda",
           "eaGenerateUpdate"]


def _where_rows(mask, new, old):
    def w(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return _map(w, new, old)


def _is_nsga2_select(toolbox) -> bool:
    """Does the toolbox select with the NSGA-II law (``sel_nsga2`` or
    ``sel_nsga2_sharded``)?  Picks the NSGA-II head of the megakernel
    engines in :func:`ea_ask`."""
    sel = getattr(toolbox, "select", None)
    base = getattr(sel, "func", sel)
    from .ops.emo import sel_nsga2
    from .parallel.emo_sharded import sel_nsga2_sharded
    return base is sel_nsga2 or base is sel_nsga2_sharded


def _sharded(population) -> bool:
    from .parallel.mapper import ShardedPopulation
    return isinstance(population, ShardedPopulation)


def _as_sharded(population, toolbox):
    """A toolbox that declares ``generation_mesh`` takes a sharded
    population; a plain one (the same global population on every rank)
    is sharded here with the megakernel's row quantum."""
    mesh = getattr(toolbox, "generation_mesh", None)
    if mesh is None or _sharded(population):
        return population
    from .parallel.mapper import shard_population
    return shard_population(population, mesh, quantum=32)


def _row_windows(sh):
    """This rank's windows of the population-wide draws of
    :func:`vary_genome` (rows and mating pairs), for
    :func:`deap_tpu_torch.random.row_range`."""
    if sh.start % 2:
        raise ValueError("a sharded xla loop needs an even row layout "
                         "(shard_population(..., quantum=2))")
    if sh.rows // 2 < random.MIN_WINDOW:
        raise ValueError(
            f"rank {sh.rank} holds {sh.rows} rows: the sharded xla loop "
            f"needs at least {2 * random.MIN_WINDOW} a rank")
    half = sh.start // 2
    return random.row_range((sh.n, sh.start, sh.stop),
                            (sh.n // 2, half, half + sh.rows // 2))


def _sharded_ask(key, spop, toolbox, cxpb, mutpb, full=None):
    """The xla engine's ask half on a sharded population: selection on
    the gathered population (``full``, gathered here when not given),
    this rank's offspring rows taken from it and varied at their global
    rows."""
    from .parallel.multihost import fetch_global
    if full is None:
        full = fetch_global(spop)
    sh = spop.sharding
    key, k_sel, k_var = random.split(key, 3)
    idx = toolbox.select(k_sel, full.fitness, full.size)
    off = full.take(idx[sh.start:sh.stop])
    with _row_windows(sh):
        off = var_and(k_var, off, toolbox, cxpb, mutpb)
    return key, spop.with_local(off)


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
    with one key; a ``rowwise_op`` once with ``split(key, n)``; else one
    call per row under ``split(key, n)`` (the JAX package's vmap over
    per-row keys, as a loop).

    Under rbg keys the loop cannot follow that vmap, which draws every
    row's bits from the first row's key (:mod:`deap_tpu_torch.random`),
    so an operator with neither form raises there.

    Inside a :func:`deap_tpu_torch.random.row_range` window (a rank of a
    sharded loop) the batched form runs in the window: its draws lead
    with the row axis.  The per-row keys are this rank's rows of the
    population-wide split, and the rowwise or per-row calls run outside
    the window, so a row's own draws (a ``(dim,)`` mask) are never taken
    for rows of the population.  A rowwise operator under rbg keys
    raises there: jax's vmap draws its bits from the first key of the
    whole population, which this rank does not hold."""
    batched = _batched_form(tool)
    if batched is not None:
        return batched(key, *operands)
    keys = random.split(key, n)
    name = getattr(tool, "__name__", tool)
    if random.impl_of(key) == "rbg":
        if not getattr(tool, "rowwise", False):
            raise NotImplementedError(
                f"{name!r} has no batched or rowwise form: under rbg keys "
                "jax's vmap over per-row keys draws every row from the "
                "first key, which a per-row loop cannot follow")
        if random.row_range_active():
            raise NotImplementedError(
                f"{name!r} is rowwise: under rbg keys on a sharded "
                "population it would draw from the first key of the whole "
                "population, which this rank does not hold")
    with random.outside_row_range():
        if getattr(tool, "rowwise", False):
            return tool(keys, *operands)
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


def _quarantined(toolbox, population: Population, newly) -> Population:
    """``toolbox.quarantine`` applied to the rows just assigned."""
    quarantine = getattr(toolbox, "quarantine", None)
    if quarantine is None:
        return population
    return quarantine.apply(population, newly=newly)


def _accepts_skip(fn) -> bool:
    try:
        return "skip" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def evaluate_rows(evaluate, *operands) -> torch.Tensor:
    """``(n, nobj)`` float32 values of a per-individual ``evaluate`` over
    the rows of its operands (a genome; a host and a parasite genome):
    its batched form in one call when it has one, else vmapped."""
    batched = _batched_form(evaluate)
    if batched is not None:
        out = batched(*operands)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return torch.stack([torch.as_tensor(o).to(torch.float32)
                            for o in out], dim=1)
    if len(operands) == 1:
        return torch.func.vmap(_norm_eval(evaluate))(operands[0])
    return torch.func.vmap(_norm_eval(lambda args: evaluate(*args)))(
        operands)


def evaluate_population(toolbox, population: Population):
    """Evaluate every row and assign the values where the fitness was
    invalid.  Returns ``(population, nevals)``.

    A registered ``toolbox.evaluate_population(genome)`` evaluates the
    whole population at once (a 1-D result becomes ``(n, 1)``); when its
    signature has ``skip`` it gets ``skip=fitness.valid`` and may skip
    those rows, whose values are discarded (the GP evaluator gives them
    length 0, so the stack machine runs no step for them).  Otherwise
    ``toolbox.evaluate`` runs on the whole genome when it advertises a
    ``.batched`` form (:func:`~deap_tpu_torch.ops._dispatch.batched_op`:
    the same function over a leading row axis, such as ``ackley``, whose
    XLA-form transcendentals view float bits, which ``vmap`` cannot batch
    on every torch release), else it is vmapped over the rows.

    A ``toolbox.quarantine`` is applied to the freshly assigned rows."""
    invalid = ~population.fitness.valid
    genome = _widen_genome(_genome_storage(toolbox), population.genome)
    if hasattr(toolbox, "evaluate_population"):
        tool = toolbox.evaluate_population
        if _accepts_skip(tool):
            values = tool(genome, skip=population.fitness.valid)
        else:
            values = tool(genome)
        if values.ndim == 1:
            values = values[:, None]
    else:
        values = evaluate_rows(toolbox.evaluate, genome)
    nevals = invalid.sum()
    population = _quarantined(toolbox,
                              population.evaluated(values, where=invalid),
                              invalid)
    return population, nevals


def var_and(key, population: Population, toolbox, cxpb: float,
            mutpb: float, pairing: str = "adjacent") -> Population:
    """varAnd: pairs mate with probability ``cxpb``, every row mutates
    with probability ``mutpb``; touched rows lose their fitness."""
    g, touched = vary_genome(key, population.genome, toolbox, cxpb, mutpb,
                             pairing=pairing)
    return population.with_genome(g, invalidate_where=touched)


def vary_genome(key, g, toolbox, cxpb: float, mutpb: float,
                pairing: str = "adjacent"):
    """Genome-level core of :func:`var_and`: ``(new_genome, touched)``.
    ``pairing="adjacent"`` mates rows ``(0,1), (2,3), ...``;
    ``"halves"`` mates row ``i`` with row ``n//2 + i`` and writes the
    children back in half-blocks."""
    if pairing not in ("adjacent", "halves"):
        raise ValueError(f"unknown pairing {pairing!r}")
    n = _leaves(g)[0].shape[0]
    n2 = n // 2
    storage = _genome_storage(toolbox)
    g_ref = g
    g = _widen_genome(storage, g)
    k_cx, k_cxkeys, k_mut, k_mutkeys = random.split(key, 4)

    if pairing == "adjacent":
        ga = _map(lambda x: x[0:2 * n2:2], g)
        gb = _map(lambda x: x[1:2 * n2:2], g)
    else:
        ga = _map(lambda x: x[:n2], g)
        gb = _map(lambda x: x[n2:2 * n2], g)
    do_cx = random.bernoulli(k_cx, cxpb, (n2,))
    ca, cb = _apply_op(toolbox.mate, k_cxkeys, n2, ga, gb)
    ga = _where_rows(do_cx, ca, ga)
    gb = _where_rows(do_cx, cb, gb)
    if pairing == "adjacent":
        paired = _map(lambda a, b: torch.stack([a, b], 1).reshape(
            (2 * n2,) + a.shape[1:]), ga, gb)
        touched = torch.repeat_interleave(do_cx, 2)
    else:
        paired = _map(lambda a, b: torch.cat([a, b], 0), ga, gb)
        touched = torch.cat([do_cx, do_cx])
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


def var_or(key, population: Population, toolbox, lambda_: int,
           cxpb: float, mutpb: float) -> Population:
    """varOr: each of ``lambda_`` children comes from crossover (p =
    ``cxpb``, the first child of two random distinct parents), mutation
    (p = ``mutpb``, of a random parent) or reproduction; all come back
    unevaluated.  ``generation_engine = "megakernel"`` routes to the
    fused OR-choice kernel (:func:`deap_tpu_torch.ops.generation.
    fused_var_or`), with the same choices and parent indices."""
    assert cxpb + mutpb <= 1.0, (
        "The sum of the crossover and mutation probabilities must be smaller "
        "or equal to 1.0.")
    from .ops.generation import _var_or_law, fused_var_or
    if resolve_engine(toolbox) in ("megakernel", "megakernel_sharded"):
        return fused_var_or(key, population, toolbox, lambda_, cxpb, mutpb)
    g = population.genome
    use_cx, use_mut, i1, i2, im, ir, k_cx, k_mut = _var_or_law(
        key, population.size, lambda_, cxpb, mutpb)

    def take(idx):
        return _map(lambda x: x[idx.long()], g)

    child_cx, _ = _apply_op(toolbox.mate, k_cx, lambda_, take(i1), take(i2))
    child_mut = _apply_op(toolbox.mutate, k_mut, lambda_, take(im))
    child = _where_rows(use_cx, child_cx,
                        _where_rows(use_mut, child_mut, take(ir)))
    old = population.fitness
    return Population(child, Fitness.empty(lambda_, old.weights,
                                           old.values.dtype,
                                           old.values.device))


def ea_ask(key, population: Population, toolbox, cxpb: float, mutpb: float,
           *, live=None):
    """Selection + variation half of one :func:`ea_simple` generation:
    ``(key, offspring)`` with touched rows invalid and nothing evaluated.
    ``generation_engine = "megakernel"`` routes the whole half through
    the fused generation (:func:`deap_tpu_torch.ops.generation.
    fused_ea_step`) — the one routing point for every loop — and a
    megakernel toolbox whose ``select`` is ``sel_nsga2`` to the NSGA-II
    head (:func:`~deap_tpu_torch.ops.generation.fused_nsga2_step`)."""
    engine = require_ported(resolve_engine(toolbox))
    if engine == "streamed":
        from .bigpop.engine import streamed_ea_ask
        return streamed_ea_ask(key, population, toolbox, cxpb, mutpb,
                               live=live)
    population = _as_sharded(population, toolbox)
    if engine == "megakernel_sharded":
        from .ops import generation_sharded as GS
        if _is_nsga2_select(toolbox):
            return GS.fused_nsga2_step_sharded(key, population, toolbox,
                                               cxpb, mutpb, live=live)
        return GS.fused_ea_step_sharded(key, population, toolbox, cxpb,
                                        mutpb, live=live)
    if _sharded(population):
        if live is not None:
            raise NotImplementedError("the sharded xla loop takes no live "
                                      "mask")
        return _sharded_ask(key, population, toolbox, cxpb, mutpb)
    if engine == "megakernel" and _is_nsga2_select(toolbox):
        from .ops.generation import fused_nsga2_step
        return fused_nsga2_step(key, population, toolbox, cxpb, mutpb,
                                live=live)
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
    assign external ``values`` to them — either way ``toolbox.quarantine``
    is applied to the freshly assigned rows.  Returns ``(population,
    nevals)``; with ``live``, pad rows are skipped (evaluation, assignment,
    quarantine, ``nevals``) and come back invalid.  On a
    sharded population each rank evaluates its own rows and ``nevals``
    is the count over every rank."""
    if _sharded(population):
        from .parallel import collectives
        local, nevals = ea_tell(toolbox, population.local(), values,
                                live=live)
        return (population.with_local(local),
                collectives.gather_sum(torch.as_tensor(nevals),
                                       population.mesh))
    if live is None:
        if values is None:
            return evaluate_population(toolbox, population)
        invalid = ~population.fitness.valid
        population = _quarantined(
            toolbox, population.evaluated(values, where=invalid), invalid)
        return population, invalid.sum()
    live = live.to(torch.bool)
    fit = population.fitness
    guarded = Population(population.genome,
                         dataclasses.replace(fit, valid=fit.valid | ~live))
    out, nevals = ea_tell(toolbox, guarded, values)
    return Population(out.genome, dataclasses.replace(
        out.fitness, valid=out.fitness.valid & live)), nevals


def ea_step(key, population: Population, toolbox, cxpb: float, mutpb: float,
            *, reevaluate_all: bool = False, live=None):
    """One full :func:`ea_simple` generation: ``(key, population,
    nevals)``.

    ``reevaluate_all=True`` evaluates every offspring row instead of
    carrying the fitness of untouched rows forward (the same trajectory
    for a deterministic evaluate, without the two fitness gathers);
    ``nevals`` still counts the rows variation touched.  It refuses a
    ``live`` mask, and the megakernel engine is reevaluate-all already
    (the flag changes nothing there).

    ``generation_engine = "streamed"`` runs the generation as the sliced
    pipeline of :mod:`deap_tpu_torch.bigpop`, evaluation fused into each
    slice, so the offspring are never on the device whole."""
    if resolve_engine(toolbox) == "streamed":
        from .bigpop.engine import streamed_ea_step
        return streamed_ea_step(key, population, toolbox, cxpb, mutpb,
                                live=live)
    if reevaluate_all and resolve_engine(toolbox) == "xla" and \
            not _sharded(population):
        if live is not None:
            raise ValueError("reevaluate_all is incompatible with a live "
                             "mask: it recomputes every row, including pads")
        key, k_sel, k_var = random.split(key, 3)
        idx = toolbox.select(k_sel, population.fitness, population.size)
        genome = _map(lambda x: x[idx.long()], population.genome)
        genome, touched = vary_genome(k_var, genome, toolbox, cxpb, mutpb)
        fit = population.fitness
        off = Population(genome, Fitness.empty(
            population.size, fit.weights, fit.values.dtype,
            fit.values.device))
        off, _ = evaluate_population(toolbox, off)
        return key, off, touched.sum()
    key, off = ea_ask(key, population, toolbox, cxpb, mutpb, live=live)
    off, nevals = ea_tell(toolbox, off, live=live)
    return key, off, nevals


def _record(stats, population, nevals) -> dict:
    rec = dict(stats.compile(population)) if stats is not None else {}
    rec["nevals"] = nevals
    return rec


def _stack_records(records):
    """Per-generation records stacked key by key; a
    :class:`~deap_tpu_torch.utils.support.MultiStatistics` chapter (a
    nested dict) is stacked the same way."""
    return {k: _stack_records([r[k] for r in records])
            if isinstance(v, dict)
            else torch.stack([torch.as_tensor(r[k]) for r in records])
            for k, v in records[0].items()}


def _scalar(v):
    if isinstance(v, dict):
        return {k: _scalar(x) for k, x in v.items()}
    return v.item() if isinstance(v, torch.Tensor) and v.ndim == 0 else v


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _emit_stream(gen: int, rec: dict) -> None:
    """One streamed line: ``gen=K`` then the record's entries in sorted
    key order (a chapter's as ``chapter.key``), tab-separated — the JAX
    package's line for the same record, byte for byte."""
    def flat(prefix, d, out):
        for k in sorted(d):
            v = d[k]
            if isinstance(v, dict):
                flat(f"{prefix}{k}.", v, out)
            else:
                a = _host_array(v)
                out.append(f"{prefix}{k}={a.item():g}" if a.ndim == 0
                           else f"{prefix}{k}={a}")
    parts = [f"gen={int(gen)}"]
    flat("", rec, parts)
    print("\t".join(parts), flush=True)


def _resolve_stream_mode(stream_every: int, stream_mode: str) -> str:
    """``off`` without ``stream_every``; else ``callback`` (a line at
    every generation that ``stream_every`` divides) or ``segmented``
    (the same lines, as after each chunk of ``stream_every``
    generations, and one after the last generation).  ``auto`` is
    ``callback``: the loops run on the host on every device."""
    if not stream_every:
        return "off"
    if stream_mode == "auto":
        return "callback"
    if stream_mode not in ("callback", "segmented"):
        raise ValueError(f"stream_mode {stream_mode!r}: expected "
                         "'auto', 'callback' or 'segmented'")
    return stream_mode


def _stream(mode: str, stream_every: int, gen: int, ngen: int,
            rec: dict) -> None:
    """Emit generation ``gen``'s record where ``mode`` puts a line."""
    if mode == "off":
        return
    if gen % stream_every == 0 or (mode == "segmented" and gen == ngen):
        _emit_stream(gen, rec)


def _logbook(stats, rec0, records, ngen: int, verbose: bool,
             nevals: bool = True) -> Logbook:
    """Generation 0's record (none when ``rec0`` is ``None``, as in
    :func:`ea_generate_update`), then generations 1..ngen; ``nevals``
    puts that column in the header (the PSO and cooperative loops have
    none)."""
    logbook = Logbook()
    logbook.header = (["gen"] + (["nevals"] if nevals else [])
                      + (stats.fields if stats else []))
    if rec0 is not None:
        logbook.record(gen=0, **{k: _scalar(v) for k, v in rec0.items()})
    if ngen > 0:
        logbook.record_stacked(gen=torch.arange(1, ngen + 1),
                               **_stack_records(records))
    if verbose:
        print(logbook.stream)
    return logbook


def _hof_state_compatible(state, population) -> bool:
    """A carried archive continues only onto individuals of the same
    genome structure, shapes and dtypes, the same objective count and
    weights, on the same device."""
    s_leaves, p_leaves = _leaves(state.genome), _leaves(population.genome)
    if type(state.genome) is not type(population.genome) or \
            len(s_leaves) != len(p_leaves):
        return False
    for s, p in zip(s_leaves, p_leaves):
        if (s.shape[1:] != p.shape[1:] or s.dtype != p.dtype
                or s.device != p.device):
            return False
    return (state.values.shape[1] == population.fitness.nobj
            and state.weights == population.fitness.weights)


def _hof_setup(halloffame, sample_population) -> None:
    """Ready the archive for a loop.  An archive that already carries
    state keeps it (the reference's hall of fame accumulates across
    successive ``eaSimple`` calls); call ``halloffame.clear()`` for a
    fresh one.  State shaped for another problem is discarded and
    initialised anew.  The loops then call ``halloffame.update`` where
    the JAX package updates its carried archive."""
    if halloffame is None:
        return
    state = halloffame.state
    if state is None or not _hof_state_compatible(state, sample_population):
        halloffame.init_state(sample_population)


def _start(key, population, toolbox, halloffame):
    """The loops' common start: a key split, the initial evaluation, and
    the archive readied and updated on the evaluated population."""
    require_ported(resolve_engine(toolbox))
    key, _ = random.split(key)
    population, nevals0 = evaluate_population(toolbox, population)
    _hof_setup(halloffame, population)
    if halloffame is not None:
        halloffame.update(population)
    return key, population, nevals0


def _ea_simple_sharded(key, spop, toolbox, cxpb, mutpb, ngen, stats,
                       halloffame, verbose, smode, stream_every):
    """:func:`ea_simple` on this rank's block of a sharded population
    (module docstring).  The gathered population feeds the next
    generation's selection (xla engine), the records and the archive:
    one genome all-gather a generation."""
    from .parallel.multihost import fetch_global
    engine = require_ported(resolve_engine(toolbox))
    key, _ = random.split(key)
    spop, nevals0 = ea_tell(toolbox, spop)
    gathered = engine == "xla" or stats is not None or halloffame is not None
    full = fetch_global(spop) if gathered else None
    if halloffame is not None:
        _hof_setup(halloffame, full)
        halloffame.update(full)
    rec0 = _record(stats, full, nevals0)
    records = []
    for gen in range(1, ngen + 1):
        if engine == "xla":
            key, spop = _sharded_ask(key, spop, toolbox, cxpb, mutpb, full)
        else:
            key, spop = ea_ask(key, spop, toolbox, cxpb, mutpb)
        spop, nevals = ea_tell(toolbox, spop)
        full = fetch_global(spop) if gathered else None
        if halloffame is not None:
            halloffame.update(full)
        records.append(_record(stats, full, nevals))
        _stream(smode, stream_every, gen, ngen, records[-1])
    return spop, _logbook(stats, rec0, records, ngen, verbose)


def ea_simple(key, population: Population, toolbox, cxpb: float, mutpb: float,
              ngen: int, stats=None, halloffame=None, verbose=False,
              reevaluate_all: bool = False, stream_every: int = 0,
              stream_mode: str = "auto"):
    """The simplest GA (reference eaSimple): per generation select, vary
    (:func:`var_and`) and evaluate — ``ngen`` calls of :func:`ea_step`,
    each with ``reevaluate_all`` — then update the hall of fame with the
    offspring.  Returns ``(population, logbook)``.  Records stay on the
    device until the run ends, but for the generations streamed
    (``stream_every``, ``stream_mode``: see the module docstring).

    ``generation_engine = "streamed"`` runs the whole loop as
    :func:`deap_tpu_torch.bigpop.streamed_ea_simple` (the same
    trajectory), which refuses ``reevaluate_all`` and ``stream_every``."""
    if resolve_engine(toolbox) == "streamed":
        from .bigpop.engine import streamed_ea_simple
        if reevaluate_all or stream_every:
            raise ValueError("the streamed engine does not support "
                             "reevaluate_all/stream_every (host loop)")
        return streamed_ea_simple(key, population, toolbox, cxpb, mutpb,
                                  ngen, stats=stats, halloffame=halloffame,
                                  verbose=verbose)
    smode = _resolve_stream_mode(stream_every, stream_mode)
    population = _as_sharded(population, toolbox)
    if _sharded(population):
        return _ea_simple_sharded(key, population, toolbox, cxpb, mutpb,
                                  ngen, stats, halloffame, verbose, smode,
                                  stream_every)
    key, population, nevals0 = _start(key, population, toolbox, halloffame)
    rec0 = _record(stats, population, nevals0)
    records = []
    for gen in range(1, ngen + 1):
        key, population, nevals = ea_step(key, population, toolbox, cxpb,
                                          mutpb, reevaluate_all=reevaluate_all)
        if halloffame is not None:
            halloffame.update(population)
        records.append(_record(stats, population, nevals))
        _stream(smode, stream_every, gen, ngen, records[-1])
    return population, _logbook(stats, rec0, records, ngen, verbose)


def _sharded_var_or(key, full, spop, toolbox, lambda_, cxpb, mutpb):
    """:func:`var_or` for this rank's rows of the ``lambda_`` children of
    the gathered parents ``full``: every per-child draw is this rank's
    rows of the population-wide draw.  Returns the local children and
    their layout."""
    from .ops.generation import _var_or_law
    from .parallel.mapper import population_sharding
    if resolve_engine(toolbox) != "xla":
        raise NotImplementedError("the sharded (mu +/, lambda) loops run "
                                  "the xla engine")
    sh = population_sharding(spop.mesh, lambda_)
    if sh.rows < random.MIN_WINDOW:
        raise ValueError(f"rank {sh.rank} makes {sh.rows} children: the "
                         f"sharded loop needs at least {random.MIN_WINDOW}")
    with random.row_range((lambda_, sh.start, sh.stop)):
        use_cx, use_mut, i1, i2, im, ir, k_cx, k_mut = _var_or_law(
            key, full.size, sh.rows, cxpb, mutpb)
        g = full.genome

        def take(idx):
            return _map(lambda x: x[idx.long()], g)
        n = sh.rows
        child_cx, _ = _apply_op(toolbox.mate, k_cx, n, take(i1), take(i2))
        child_mut = _apply_op(toolbox.mutate, k_mut, n, take(im))
    child = _where_rows(use_cx, child_cx,
                        _where_rows(use_mut, child_mut, take(ir)))
    old = full.fitness
    return Population(child, Fitness.empty(n, old.weights, old.values.dtype,
                                           old.values.device)), sh


def _ea_mu_lambda_sharded(key, spop, toolbox, mu, lambda_, cxpb, mutpb,
                          ngen, stats, halloffame, verbose, plus, smode,
                          stream_every):
    """The (mu +/, lambda) loops on this rank's block of a sharded
    population: each rank makes and evaluates its rows of the children,
    and every rank selects the next parents from the gathered pool."""
    from .parallel.mapper import ShardedPopulation, population_sharding
    from .parallel.multihost import fetch_global
    from .parallel import collectives
    assert cxpb + mutpb <= 1.0, (
        "The sum of the crossover and mutation probabilities must be smaller "
        "or equal to 1.0.")
    require_ported(resolve_engine(toolbox))
    mesh = spop.mesh
    key, _ = random.split(key)
    spop, nevals0 = ea_tell(toolbox, spop)
    full = fetch_global(spop)
    if halloffame is not None:
        _hof_setup(halloffame, full)
        halloffame.update(full)
    rec0 = _record(stats, full, nevals0)
    records = []
    for gen in range(1, ngen + 1):
        key, k_var, k_sel = random.split(key, 3)
        off, osh = _sharded_var_or(k_var, full, spop, toolbox, lambda_,
                                   cxpb, mutpb)
        off, nev = evaluate_population(toolbox, off)
        nevals = collectives.gather_sum(torch.as_tensor(nev), mesh)
        off_full = fetch_global(ShardedPopulation(
            off.genome, off.fitness, mesh, lambda_, 1))
        if halloffame is not None:
            halloffame.update(off_full)
        pool = full.concat(off_full) if plus else off_full
        full = pool.take(toolbox.select(k_sel, pool.fitness, mu))
        sh = population_sharding(mesh, mu, spop.quantum)
        spop = ShardedPopulation(
            _map(lambda x: x[sh.start:sh.stop], full.genome),
            full.fitness.take(torch.arange(sh.start, sh.stop,
                                           device=full.fitness.valid.device)),
            mesh, mu, spop.quantum)
        records.append(_record(stats, full, nevals))
        _stream(smode, stream_every, gen, ngen, records[-1])
    return spop, _logbook(stats, rec0, records, ngen, verbose)


def _ea_mu_lambda(key, population, toolbox, mu, lambda_, cxpb, mutpb, ngen,
                  stats, halloffame, verbose, plus: bool,
                  stream_every: int = 0, stream_mode: str = "auto"):
    smode = _resolve_stream_mode(stream_every, stream_mode)
    if _sharded(population):
        return _ea_mu_lambda_sharded(key, population, toolbox, mu, lambda_,
                                     cxpb, mutpb, ngen, stats, halloffame,
                                     verbose, plus, smode, stream_every)
    key, population, nevals0 = _start(key, population, toolbox, halloffame)
    rec0 = _record(stats, population, nevals0)
    records = []
    for gen in range(1, ngen + 1):
        key, k_var, k_sel = random.split(key, 3)
        off = var_or(k_var, population, toolbox, lambda_, cxpb, mutpb)
        off, nevals = evaluate_population(toolbox, off)
        if halloffame is not None:
            halloffame.update(off)
        pool = population.concat(off) if plus else off
        population = pool.take(toolbox.select(k_sel, pool.fitness, mu))
        records.append(_record(stats, population, nevals))
        _stream(smode, stream_every, gen, ngen, records[-1])
    return population, _logbook(stats, rec0, records, ngen, verbose)


def ea_mu_plus_lambda(key, population, toolbox, mu, lambda_, cxpb, mutpb,
                      ngen, stats=None, halloffame=None, verbose=False,
                      stream_every: int = 0, stream_mode: str = "auto"):
    """(mu + lambda) strategy (reference eaMuPlusLambda): offspring by
    :func:`var_or`, the next generation selected from parents and
    offspring.  Returns ``(population, logbook)``."""
    return _ea_mu_lambda(key, population, toolbox, mu, lambda_, cxpb, mutpb,
                         ngen, stats, halloffame, verbose, plus=True,
                         stream_every=stream_every, stream_mode=stream_mode)


def ea_mu_comma_lambda(key, population, toolbox, mu, lambda_, cxpb, mutpb,
                       ngen, stats=None, halloffame=None, verbose=False,
                       stream_every: int = 0, stream_mode: str = "auto"):
    """(mu , lambda) strategy (reference eaMuCommaLambda): the next
    generation selected from the offspring only (``lambda_ >= mu``)."""
    assert lambda_ >= mu, ("lambda must be greater or equal to mu.")
    return _ea_mu_lambda(key, population, toolbox, mu, lambda_, cxpb, mutpb,
                         ngen, stats, halloffame, verbose, plus=False,
                         stream_every=stream_every, stream_mode=stream_mode)


def ea_generate_update(key, toolbox, state, ngen: int, weights=(-1.0,),
                       stats=None, halloffame=None, verbose=False,
                       stream_every: int = 0, stream_mode: str = "auto"):
    """Ask-tell loop (reference eaGenerateUpdate):
    ``toolbox.generate(state, key)`` gives a genome batch, evaluated, then
    ``toolbox.update(state, population)`` gives the next state — the
    functional form of the reference's strategy objects (CMA-ES).

    The key discipline is the JAX package's: the population's shape comes
    from ``generate(state, fold_in(key, 0))``, then each generation takes
    ``key, k_gen = split(key)``.  There is no initial evaluation, and the
    logbook holds generations 1..ngen.  Returns ``(population, state,
    logbook)``; with ``ngen`` 0 the population is the unevaluated shape
    sample."""
    smode = _resolve_stream_mode(stream_every, stream_mode)
    weights = tuple(weights)
    sample = toolbox.generate(state, random.fold_in(key, 0))
    first = _leaves(sample)[0]
    n, dev = first.shape[0], first.device
    pop = Population(sample, Fitness.empty(n, weights, device=dev))
    _hof_setup(halloffame, pop)
    records = []
    for gen in range(1, ngen + 1):
        key, k_gen = random.split(key)
        genome = toolbox.generate(state, k_gen)
        pop = Population(genome, Fitness.empty(n, weights, device=dev))
        pop, nevals = evaluate_population(toolbox, pop)
        state = toolbox.update(state, pop)
        if halloffame is not None:
            halloffame.update(pop)
        records.append(_record(stats, pop, nevals))
        _stream(smode, stream_every, gen, ngen, records[-1])
    return pop, state, _logbook(stats, None, records, ngen, verbose)


varAnd = var_and
varOr = var_or
eaSimple = ea_simple
eaMuPlusLambda = ea_mu_plus_lambda
eaMuCommaLambda = ea_mu_comma_lambda
eaGenerateUpdate = ea_generate_update
