"""The streamed generation engine: out-of-core evolution.

One generation at population ``n`` runs as a *sliced pipeline* over a
:class:`~deap_tpu_torch.bigpop.host.HostPopulation`: while slice *k* is
varied and evaluated on the card, slice *k + 1*'s parent rows are
gathered on the host and copied up, and slice *k - 1*'s children drain
back to the host, so the card holds O(slice) genome rows, never O(pop).

Bitwise contract (``tests/test_torch_bigpop.py`` on the CPU against the
JAX package's jitted resident ``ea_step``; ``chip_smoke.py`` on the card
against the port's resident step): a streamed generation at pop ``n``
equals the resident :func:`deap_tpu_torch.algorithms.ea_step` at the
same pop and key, for float32, bfloat16 and int8 storage alike.  Three
facts make that possible:

* every *decision-sized* tensor of the resident path (tournament
  winners, crossover coin flips and cut points, the mutation row mask,
  the key chain) is O(pop) and small, so the **generation plan**
  computes them for the whole population on the device from the fitness
  table, with the registered operators themselves (``toolbox.select``
  runs unmodified);
* the only genome-sized draws (``mut_gaussian``'s mask and noise,
  ``mut_flip_bit``'s mask, ``cx_uniform``'s swap mask) are regenerated
  a slice at a time by :mod:`~deap_tpu_torch.bigpop.slicedprng`, and the
  arithmetic on them is the operators' own (``ops.mutation.
  gaussian_from_draws``, ``flip_where``; ``ops.crossover``'s masks);
* slice boundaries are **even**, so the crossover pairs ``(2p, 2p +
  1)`` never straddle one, and evaluation is a per-row function.  On the
  card a PyTorch reduction may split a row's work over more threads when
  it reduces fewer than 16 rows at once, so every slice is evaluated at
  the full slice height (a short tail slice padded with copies of its
  first row); the resident step evaluates its population at once.

**The pipeline on a card.**  The host gathers each slice's parent rows
(``index_select`` with ``out=``) into one of three pinned staging
buffers; a copy stream moves them to the card (``non_blocking``) and
records an event, which the compute stream waits on.  The children and
their values come back on a second copy stream into pinned buffers; the
host synchronizes that copy's event before it copies them into the child
store, and synchronizes each staging buffer's last upload before it
refills the buffer.  Device tensors that cross streams are
``record_stream``-ed.  Nothing falls back: a failed pinning or copy
raises.  On the CPU the same loop runs with the host tensors in place.

The engine supports the ask / tell split and the ``live`` prefix-mask
padding contract, row for row as the resident path.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import torch

from .. import random
from .._device import resolve_device
from ..base import Fitness, Population, _leaves
from ..ops import crossover, mutation
from ..ops.generation import GenomeStorage, storage_of
from .host import HostPopulation
from .slicedprng import (check_prng_compat, sliced_bernoulli,
                         sliced_normal)

__all__ = ["StreamedEngine", "GenerationResult", "streamed_params",
           "streamed_ea_ask", "streamed_ea_step", "streamed_ea_simple",
           "DEFAULT_SLICE_ROWS"]

#: default slice: even (crossover pairs never straddle a boundary), big
#: enough to amortize the launches of a slice, small enough that the
#: three slices of the pipeline are a sliver of the card at any dim
DEFAULT_SLICE_ROWS = 8192

#: pinned staging buffers a direction (one uploading, one computing,
#: one draining)
STAGING_DEPTH = 3

_SUPPORTED_MATE = ("cx_two_point", "cx_one_point", "cx_uniform")
_SUPPORTED_MUTATE = ("mut_gaussian", "mut_flip_bit")


def streamed_params(toolbox) -> dict:
    """Validate a toolbox for the streamed engine and extract its
    operator configuration.  Selection is unrestricted (every ``sel_*``
    reads only the fitness table, which goes to the device whole), but
    mate and mutate must be operators whose genome-sized randomness the
    slices regenerate, registered with keyword parameters only (the rule
    of the batched dispatch)."""
    from ..algorithms import _batched_form

    def base_fn(tool):
        return getattr(tool, "func", tool)

    mate_kind = getattr(base_fn(toolbox.mate), "__name__", "?")
    if base_fn(toolbox.mate) not in (crossover.cx_two_point,
                                     crossover.cx_one_point,
                                     crossover.cx_uniform):
        raise ValueError("streamed generation supports mate in "
                         f"{_SUPPORTED_MATE}; got {mate_kind}")
    mut_kind = getattr(base_fn(toolbox.mutate), "__name__", "?")
    if base_fn(toolbox.mutate) not in (mutation.mut_gaussian,
                                       mutation.mut_flip_bit):
        raise ValueError("streamed generation supports mutate in "
                         f"{_SUPPORTED_MUTATE}; got {mut_kind}")
    for name in ("mate", "mutate"):
        if _batched_form(getattr(toolbox, name)) is None:
            raise ValueError(
                f"streamed generation: toolbox.{name} does not dispatch "
                "to its batched form (positional frozen args, or a "
                "wrapping decorator); the resident path would draw per-row "
                "keys, which the slices do not regenerate: register "
                "keyword parameters only")
    if getattr(toolbox, "quarantine", None) is not None:
        raise ValueError("streamed generation does not support "
                         "toolbox.quarantine (it rewrites fitness from "
                         "the whole population); clear it or use the "
                         "resident engine")
    if hasattr(toolbox, "evaluate_population"):
        raise ValueError("streamed generation needs a per-individual "
                         "toolbox.evaluate (a population-level "
                         "evaluate_population would need the whole "
                         "genome on the device)")
    if not hasattr(toolbox, "evaluate"):
        raise ValueError("streamed generation needs toolbox.evaluate")
    return {"mate": mate_kind, "mutate": mut_kind,
            "mate_kw": dict(getattr(toolbox.mate, "keywords", {})),
            "mut_kw": dict(getattr(toolbox.mutate, "keywords", {}))}


@dataclasses.dataclass
class GenerationResult:
    """Outcome of one (possibly interrupted) streamed generation."""

    completed: bool
    key: Optional[torch.Tensor] = None          # advanced key (completed)
    nevals: int = 0
    cursor: int = 0                             # next slice (preempted)
    staged_rows: Optional[torch.Tensor] = None  # child rows [0, bounds[cursor])
    staged_vals: Optional[torch.Tensor] = None  # their values
    final_valid: Optional[torch.Tensor] = None  # ask-time offspring validity


class _InPlace:
    """The CPU: a slice's host tensors are its tensors; nothing is
    copied and no stream is involved."""

    def stage(self, k: int, s: int, fills):
        return [fill(None) for _, _, fill in fills]

    def take(self, staged):
        return staged

    def send(self, k: int, tensors):
        return tensors

    def receive(self, sent):
        return sent


class _CardStaging:
    """Pinned host buffers and two copy streams of one engine on a card
    (module docstring).  ``timings`` collects the host seconds spent
    waiting on copies and the compute stream's milliseconds from each
    slice's start to its end."""

    def __init__(self, device: torch.device, rows: int, timings: dict):
        self.device = device
        self.rows = rows
        self.timings = timings
        self.upload = torch.cuda.Stream(device)
        self.download = torch.cuda.Stream(device)
        self._pinned = {}
        self._uploaded = [None] * STAGING_DEPTH   # each slot's last upload
        self._spans = []                          # compute (start, end)

    def _buffer(self, role: str, k: int, j: int, width: int, dtype):
        key = (role, k % STAGING_DEPTH, j, width, dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty((self.rows, width), dtype=dtype,
                              pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _wait(self, event) -> None:
        t = time.perf_counter()
        event.synchronize()
        self.timings["wait_s"] += time.perf_counter() - t

    def stage(self, k: int, s: int, fills):
        slot = k % STAGING_DEPTH
        if self._uploaded[slot] is not None:
            self._wait(self._uploaded[slot])      # its last upload is done
        bufs = []
        for j, (width, dtype, fill) in enumerate(fills):
            buf = self._buffer("up", k, j, width, dtype)[:s]
            fill(buf)
            bufs.append(buf)
        with torch.cuda.stream(self.upload):
            dev = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                   for b in bufs]
            for d, b in zip(dev, bufs):
                d.copy_(b, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.upload)
        self._uploaded[slot] = done
        return dev, done

    def take(self, staged):
        dev, uploaded = staged
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(uploaded)
        for d in dev:
            d.record_stream(compute)
        start = torch.cuda.Event(enable_timing=True)
        start.record(compute)
        self._spans.append([start, None])
        return dev

    def send(self, k: int, tensors):
        compute = torch.cuda.current_stream(self.device)
        computed = torch.cuda.Event(enable_timing=True)
        computed.record(compute)
        self._spans[-1][1] = computed
        self.download.wait_event(computed)
        outs = []
        with torch.cuda.stream(self.download):
            for j, t in enumerate(tensors):
                buf = self._buffer("down", k, j, t.shape[1], t.dtype)[:len(t)]
                buf.copy_(t, non_blocking=True)
                t.record_stream(self.download)
                outs.append(buf)
            done = torch.cuda.Event()
            done.record(self.download)
        return outs, done

    def receive(self, sent):
        outs, done = sent
        self._wait(done)
        return outs

    def close_timings(self) -> None:
        """Add the finished slices' compute spans (every event of them is
        complete once their downloads were received)."""
        self.timings["compute_span_ms"] += sum(a.elapsed_time(b)
                                         for a, b in self._spans)
        self._spans = []


class StreamedEngine:
    """Runs streamed generations over a :class:`HostPopulation` on
    ``device`` (default ``"cuda"``; raises
    :class:`~deap_tpu_torch.NoCudaDevice` without a card unless
    ``device="cpu"``).

    The engine keeps no state between generations that a checkpoint
    would need: a generation is a function of (key, host store), which
    is what a mid-generation checkpoint saves (the host chunks and the
    slice cursor; :mod:`deap_tpu_torch.bigpop.runner`).  ``timings``
    accumulates host seconds (``gather_s``: the host gathers;
    ``wait_s``: waits on copies; ``dispatch_s``: issuing the slice
    programs; ``store_s``: copies into the child store) and, on a card,
    ``compute_span_ms``, the compute stream's time from each slice's
    start to its end (the card's idle gaps while the host issues the
    slice's launches included)."""

    def __init__(self, toolbox, host: HostPopulation, *,
                 slice_rows: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.toolbox = toolbox
        self.host = host
        self.params = streamed_params(toolbox)
        self.storage = storage_of(toolbox) or GenomeStorage()
        if host.genome_dtype != self.storage.torch_dtype:
            raise ValueError(
                f"host store dtype {host.genome_dtype} does not match the "
                f"toolbox genome storage {self.storage.dtype!r}")
        n = host.size
        s = slice_rows or min(DEFAULT_SLICE_ROWS, n + (n % 2))
        if s % 2:
            raise ValueError(f"slice_rows={s} must be even: crossover "
                             "pairs must never straddle a slice boundary")
        self.slice_rows = int(s)
        self._bounds = [(a, min(a + self.slice_rows, n))
                        for a in range(0, n, self.slice_rows)]
        self.timings = dict.fromkeys(
            ("gather_s", "wait_s", "dispatch_s", "store_s", "compute_span_ms"),
            0.0)
        self._staging = None

    @property
    def n_slices(self) -> int:
        return len(self._bounds)

    def _copies(self):
        if self.device.type != "cuda":
            return _InPlace()
        if self._staging is None:
            self._staging = _CardStaging(self.device, self.slice_rows,
                                         self.timings)
        return self._staging

    # -- the generation plan (whole-population small tensors) ---------------

    def plan(self, key, cxpb: float, mutpb: float,
             live_n: Optional[int] = None) -> dict:
        """The whole-population generation plan, on the device: the
        resident generation's decisions, drawn as it draws them."""
        check_prng_compat(key)
        dev = self.device
        toolbox, params, host = self.toolbox, self.params, self.host
        n, dim = host.size, host.dim
        n2 = n // 2
        values, valid = (t.to(dev) for t in host.fitness_arrays())
        key_out, k_sel, k_var = random.split(key.to(dev), 3)
        idx = toolbox.select(k_sel, Fitness(values, valid, host.weights), n)
        live = live_n is not None
        if live:
            ln = max(int(live_n), 1)
            idx = torch.where(idx < ln, idx, idx % ln)
        k_cx, k_cxkeys, k_mut, k_mutkeys = random.split(k_var, 4)
        do_cx = random.bernoulli(k_cx, cxpb, (n2,))
        do_mut = random.bernoulli(k_mut, mutpb, (n,))
        out = {"key": key_out, "idx": idx, "do_cx": do_cx, "do_mut": do_mut,
               "k_cx": k_cxkeys}
        if params["mate"] == "cx_two_point":
            out["cuts"] = crossover.two_point_cuts(k_cxkeys, n2, dim)
        elif params["mate"] == "cx_one_point":
            out["cuts"] = crossover.one_point_cuts(k_cxkeys, n2, dim)
        if params["mutate"] == "mut_gaussian":
            out["k_mask"], out["k_noise"] = random.split(k_mutkeys)
        else:
            out["k_mask"] = k_mutkeys
        touched = torch.repeat_interleave(do_cx, 2)
        if n % 2:
            touched = torch.cat([touched, torch.zeros(
                n - 2 * n2, dtype=torch.bool, device=dev)])
        touched = touched | do_mut
        values_sel, valid_sel = values[idx], valid[idx]
        if live:
            lmask = torch.arange(n, device=dev) < ln
            touched = touched & lmask
            valid_ask = lmask & valid_sel & ~touched
            values_base = torch.where(lmask[:, None], values_sel, values)
            invalid = lmask & ~valid_ask
            final_valid = lmask
        else:
            valid_ask = valid_sel & ~touched
            values_base = values_sel
            invalid = ~valid_ask
            final_valid = torch.ones(n, dtype=torch.bool, device=dev)
        out.update(valid_ask=valid_ask, values_base=values_base,
                   invalid=invalid, final_valid=final_valid,
                   nevals=invalid.sum(), live_n=ln if live else None)
        return out

    # -- the per-slice device program ----------------------------------------

    def _widen(self, x):
        st = self.storage
        return st.to_compute(x) if st.is_narrow else x

    def _narrow(self, x):
        st = self.storage
        return st.to_storage(x) if st.is_narrow else x

    def slice_program(self, plan: dict, parents: torch.Tensor, a: int,
                      b: int, orig: Optional[torch.Tensor] = None,
                      with_eval: bool = True) -> list:
        """The per-slice device program: rows ``[a, b)`` of the offspring
        from their parent rows (storage dtype, on the device) by crossover
        of the slice's pairs, mutation and narrowing, then (``with_eval``)
        their values; on the live path the pad rows are ``orig``, the
        store's own rows ``[a, b)``.  Its genome-sized operands are the
        slice's rows; everything else is the plan's O(pop) tensors.
        Returns ``[child]`` or ``[child, values]``."""
        params = self.params
        n, dim = self.host.size, self.host.dim
        s = b - a
        p, q0 = s // 2, a // 2                # pairs in the slice, first pair
        g = self._widen(parents)
        ga, gb = g[0:2 * p:2], g[1:2 * p:2]
        if params["mate"] == "cx_two_point":
            lo, hi = (c[q0:q0 + p] for c in plan["cuts"])
            mask = crossover.two_point_mask(lo, hi, dim)
        elif params["mate"] == "cx_one_point":
            mask = crossover.one_point_mask(plan["cuts"][q0:q0 + p], dim)
        else:
            mask = sliced_bernoulli(plan["k_cx"],
                                    params["mate_kw"]["indpb"],
                                    (n // 2, dim), q0, p)
        ca, cb = crossover._swap_where(mask, ga, gb)
        dc = plan["do_cx"][q0:q0 + p, None]
        ga, gb = torch.where(dc, ca, ga), torch.where(dc, cb, gb)
        paired = torch.stack([ga, gb], 1).reshape(2 * p, dim)
        g = paired if s == 2 * p else torch.cat([paired, g[2 * p:]], 0)
        kw = params["mut_kw"]
        mmask = sliced_bernoulli(plan["k_mask"], kw["indpb"], (n, dim), a, s)
        if params["mutate"] == "mut_gaussian":
            mutated = mutation.gaussian_from_draws(
                g, mmask, sliced_normal(plan["k_noise"], (n, dim), a, s),
                kw["mu"], kw["sigma"])
        else:
            mutated = mutation.flip_where(g, mmask)
        g = torch.where(plan["do_mut"][a:b, None], mutated, g)
        child = self._narrow(g)
        if orig is not None:
            live = torch.arange(a, b, device=child.device) < plan["live_n"]
            child = torch.where(live[:, None], child, orig)
        return [child, self.evaluate_slice(child)] if with_eval else [child]

    def evaluate_slice(self, rows: torch.Tensor) -> torch.Tensor:
        """``(len(rows), nobj)`` values of storage-dtype rows, evaluated
        at the full slice height (module docstring)."""
        from ..algorithms import evaluate_rows
        s = len(rows)
        if s < self.slice_rows:
            rows = torch.cat([rows, rows[:1].expand(self.slice_rows - s, -1)])
        return evaluate_rows(self.toolbox.evaluate, self._widen(rows))[:s]

    # -- the pipeline -----------------------------------------------------------

    def _stream(self, k0: int, fills: Callable, compute: Callable,
                store: Callable, slice_hook=None) -> int:
        """Slices ``k0, k0 + 1, ...`` through stage, compute and drain:
        slice k + 1 is staged while k computes, and k - 1 drains then.
        ``fills(k)`` lists ``(width, dtype, fill)`` for the slice's host
        rows, ``fill(out)`` writing them into ``out`` (or returning them
        when ``out`` is None); ``compute(k, tensors)`` returns the device
        outputs; ``store(k, outputs)`` takes them on the host.  Returns
        the slice it stopped before (``slice_hook(k)`` true), else the
        slice count."""
        copies = self._copies()
        t = self.timings
        inflight: deque = deque()
        n_slices = len(self._bounds)

        def stage(k):
            a, b = self._bounds[k]
            t0, w0 = time.perf_counter(), t["wait_s"]
            staged = copies.stage(k, b - a, fills(k))
            t["gather_s"] += time.perf_counter() - t0 - (t["wait_s"] - w0)
            return staged

        def drain_one():
            k, sent = inflight.popleft()
            outs = copies.receive(sent)
            t0 = time.perf_counter()
            store(k, outs)
            t["store_s"] += time.perf_counter() - t0

        stop = n_slices
        nxt = stage(k0)
        for k in range(k0, n_slices):
            if slice_hook is not None and k > k0 and slice_hook(k):
                stop = k
                break
            t0 = time.perf_counter()
            outs = compute(k, copies.take(nxt))
            t["dispatch_s"] += time.perf_counter() - t0
            inflight.append((k, copies.send(k, outs)))
            if k + 1 < n_slices:
                nxt = stage(k + 1)         # gathered while k computes
            if len(inflight) > 1:
                drain_one()                # one slice behind
        while inflight:
            drain_one()
        if isinstance(copies, _CardStaging):
            copies.close_timings()
        return stop

    def _gather_fill(self, idx: torch.Tensor):
        return lambda out: self.host.gather(idx, out=out)

    def _rows_fill(self, a: int, b: int):
        return lambda out: self.host.rows(a, b, out=out)

    # -- generation execution -------------------------------------------------

    def run_generation(self, key, cxpb: float, mutpb: float, *,
                       with_eval: bool = True,
                       live_n: Optional[int] = None,
                       start_slice: int = 0,
                       staged_rows: Optional[torch.Tensor] = None,
                       staged_vals: Optional[torch.Tensor] = None,
                       slice_hook: Optional[Callable[[int], bool]] = None,
                       apply: bool = True) -> GenerationResult:
        """Run one generation as the sliced pipeline.  ``slice_hook(k)``
        (if given) is polled before each slice past the first; returning
        True stops the generation between slices and hands back a cursor
        and the drained prefix (the preemption path).
        ``start_slice``/``staged_*`` resume such an interrupted generation:
        with the same ``key`` this is bit-exact, because the plan is a pure
        function of (key, fitness table).  ``apply=False`` leaves the host
        store untouched and returns the offspring in the result (the ask
        half)."""
        host = self.host
        n, dim, dtype = host.size, host.dim, host.genome_dtype
        live = live_n is not None
        plan = self.plan(key, cxpb, mutpb, live_n)
        idx = plan["idx"].to("cpu")
        nobj = len(host.weights)
        child = torch.empty((n, dim), dtype=dtype)
        vals = torch.empty((n, nobj), dtype=torch.float32) if with_eval \
            else None
        if start_slice:
            a0 = self._bounds[start_slice][0]
            child[:a0] = staged_rows
            if with_eval:
                vals[:a0] = staged_vals

        def fills(k):
            a, b = self._bounds[k]
            f = [(dim, dtype, self._gather_fill(idx[a:b]))]
            if live:
                f.append((dim, dtype, self._rows_fill(a, b)))
            return f

        def compute(k, dev):
            a, b = self._bounds[k]
            return self.slice_program(plan, dev[0], a, b,
                                      dev[1] if live else None, with_eval)

        def store(k, outs):
            a, b = self._bounds[k]
            child[a:b].copy_(outs[0])
            if with_eval:
                vals[a:b].copy_(outs[1])

        stop = self._stream(start_slice, fills, compute, store, slice_hook)
        if stop < len(self._bounds):
            a = self._bounds[stop][0]
            return GenerationResult(
                completed=False, cursor=stop, staged_rows=child[:a].clone(),
                staged_vals=vals[:a].clone() if with_eval else None)

        values_base = plan["values_base"].cpu()
        if with_eval:
            invalid = plan["invalid"].cpu()
            final_values = torch.where(invalid[:, None], vals, values_base)
            final_valid = plan["final_valid"].cpu()
        else:
            final_values = values_base
            final_valid = plan["valid_ask"].cpu()
        result = GenerationResult(completed=True, key=plan["key"],
                                  nevals=int(plan["nevals"]))
        if apply:
            host.swap_genome(list(child.split(host.chunk_rows)))
            host.set_fitness(final_values, final_valid)
        else:
            result.staged_rows = child
            result.staged_vals = final_values
            result.cursor = len(self._bounds)
            result.final_valid = final_valid
        return result

    def step(self, key, cxpb: float, mutpb: float, *,
             live_n: Optional[int] = None, **kw):
        """One full generation (ask and a fused per-slice evaluation),
        applied to the host store.  Returns ``(key, nevals)``, or the
        :class:`GenerationResult` of a generation ``slice_hook`` stopped."""
        res = self.run_generation(key, cxpb, mutpb, with_eval=True,
                                  live_n=live_n, **kw)
        if not res.completed:
            return res
        return res.key, res.nevals

    def _evaluate_rows(self, fill_of) -> torch.Tensor:
        """Values of every row, a slice at a time (``fill_of(a, b)`` fills
        rows ``[a, b)``)."""
        n, dim, dtype = self.host.size, self.host.dim, self.host.genome_dtype
        vals = torch.empty((n, len(self.host.weights)), dtype=torch.float32)

        def store(k, outs):
            a, b = self._bounds[k]
            vals[a:b].copy_(outs[0])

        self._stream(0, lambda k: [(dim, dtype, fill_of(*self._bounds[k]))],
                     lambda k, dev: [self.evaluate_slice(dev[0])], store)
        return vals

    def _live_mask(self, live_n: Optional[int]) -> torch.Tensor:
        n = self.host.size
        if live_n is None:
            return torch.ones(n, dtype=torch.bool)
        return torch.arange(n) < max(int(live_n), 1)

    def evaluate_initial(self, live_n: Optional[int] = None) -> int:
        """Sliced equivalent of the loops' generation-0
        :func:`~deap_tpu_torch.algorithms.evaluate_population`: evaluate
        every row, assign where invalid (and live).  Returns ``nevals``."""
        values, valid = self.host.fitness_arrays()
        lmask = self._live_mask(live_n)
        invalid = lmask & ~valid
        vals = self._evaluate_rows(self._rows_fill)
        self.host.set_fitness(torch.where(invalid[:, None], vals, values),
                              (valid | invalid) & lmask)
        return int(invalid.sum())

    # -- ask / tell -------------------------------------------------------------

    def ask(self, key, cxpb: float, mutpb: float, *,
            live_n: Optional[int] = None):
        """Selection and variation without evaluation.  Returns ``(key,
        pending)``: the offspring rows and their carried fitness, on the
        host; the store is untouched until :meth:`tell`."""
        res = self.run_generation(key, cxpb, mutpb, with_eval=False,
                                  live_n=live_n, apply=False)
        return res.key, {"rows": res.staged_rows, "values": res.staged_vals,
                         "valid": res.final_valid, "live_n": live_n}

    def tell(self, pending: dict, values=None) -> int:
        """Complete an :meth:`ask`: assign external ``values`` (the whole
        ``(pop, nobj)``, pad rows ignored) or, when ``values`` is None,
        evaluate the pending rows a slice at a time; then swap the
        offspring into the store.  Returns ``nevals``."""
        host = self.host
        lmask = self._live_mask(pending["live_n"])
        invalid = lmask & ~pending["valid"]
        rows = pending["rows"]
        if values is None:
            def fill_of(a, b):
                return lambda out: rows[a:b] if out is None \
                    else out.copy_(rows[a:b])
            vals = self._evaluate_rows(fill_of)
        else:
            vals = torch.as_tensor(values, dtype=torch.float32).cpu()
            if vals.ndim == 1:
                vals = vals[:, None]
        host.swap_genome(list(rows.split(host.chunk_rows)))
        host.set_fitness(torch.where(invalid[:, None], vals,
                                     pending["values"]), lmask)
        return int(invalid.sum())


# ---------------------------------------------------------------------------
# Population-level wrappers (the generation_engine="streamed" routing)
# ---------------------------------------------------------------------------


def _live_count(live) -> Optional[int]:
    if live is None:
        return None
    return int(torch.as_tensor(live).sum())


def _validate_engine(toolbox) -> None:
    """A toolbox that declares the streamed engine and a
    ``generation_mesh`` is refused here, by the registry's one rejection
    site (:func:`deap_tpu_torch.engines.resolve_engine`)."""
    from ..engines import resolve_engine
    resolve_engine(toolbox)


def _engine_for(population, toolbox, slice_rows, device=None):
    """A host store of ``population`` and its engine, on the device of
    the population's tensors (or ``device``, for a
    :class:`HostPopulation`)."""
    _validate_engine(toolbox)
    if isinstance(population, HostPopulation):
        host, dev = population, device
    else:
        host = HostPopulation.from_population(population, toolbox)
        dev = device if device is not None else \
            _leaves(population.genome)[0].device
    return StreamedEngine(toolbox, host, slice_rows=slice_rows, device=dev)


def streamed_ea_ask(key, population: Population, toolbox, cxpb, mutpb, *,
                    live=None, slice_rows: Optional[int] = None):
    """Streamed form of the :func:`~deap_tpu_torch.algorithms.ea_ask`
    half: ``(key, offspring)`` with untouched rows' fitness carried and
    touched rows invalid, equal to the resident ask."""
    eng = _engine_for(population, toolbox, slice_rows)
    key, pending = eng.ask(key, cxpb, mutpb, live_n=_live_count(live))
    dev = eng.device
    return key, Population(
        pending["rows"].to(dev),
        Fitness(values=pending["values"].to(dev),
                valid=pending["valid"].to(dev),
                weights=population.fitness.weights))


def streamed_ea_step(key, population: Population, toolbox, cxpb, mutpb, *,
                     live=None, slice_rows: Optional[int] = None):
    """Streamed form of one :func:`~deap_tpu_torch.algorithms.ea_step`
    generation (evaluation fused into each slice).  Returns ``(key,
    population, nevals)``, equal to the resident step."""
    eng = _engine_for(population, toolbox, slice_rows)
    key, nevals = eng.step(key, cxpb, mutpb, live_n=_live_count(live))
    return key, eng.host.to_population(eng.device), nevals


def streamed_ea_simple(key, population, toolbox, cxpb: float, mutpb: float,
                       ngen: int, stats=None, halloffame=None,
                       verbose: bool = False,
                       slice_rows: Optional[int] = None, telemetry=None,
                       device=None):
    """The streamed ``ea_simple`` loop: same signature, same key
    schedule, the resident trajectory bit for bit.  ``population`` is a
    :class:`Population` or a :class:`HostPopulation` (then ``device``
    picks the card or the CPU).  ``stats`` and ``halloffame`` put the
    population on the device once a generation (monitoring at
    out-of-core scale should sample instead); ``verbose`` prints the
    logbook's new lines after each generation; ``telemetry`` is not
    supported.  Returns ``(population, logbook)``, the population on the
    engine's device."""
    from ..algorithms import _hof_setup, _record, _scalar, _stack_records
    from ..utils.support import Logbook

    if telemetry is not None:
        raise ValueError("streamed_ea_simple does not support telemetry")
    eng = _engine_for(population, toolbox, slice_rows, device)
    host, dev = eng.host, eng.device
    key, _ = random.split(key.to(dev))          # ea_simple's unused key
    nevals0 = eng.evaluate_initial()
    monitor = stats is not None or halloffame is not None
    pop = host.to_population(dev) if monitor else None
    if halloffame is not None:
        _hof_setup(halloffame, pop)
        halloffame.update(pop)
    logbook = Logbook()
    logbook.header = ["gen", "nevals"] + (stats.fields if stats else [])
    logbook.record(gen=0, **{k: _scalar(v) for k, v in
                             _record(stats, pop, nevals0).items()})
    for gen in range(1, ngen + 1):
        key, nevals = eng.step(key, cxpb, mutpb)
        pop = host.to_population(dev) if monitor else None
        if halloffame is not None:
            halloffame.update(pop)
        logbook.record_stacked(gen=torch.tensor([gen]), **_stack_records(
            [_record(stats, pop, nevals)]))
        if verbose:
            print(logbook.stream)
    return host.to_population(dev), logbook
