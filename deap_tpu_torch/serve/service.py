""":class:`EvolutionService` — many concurrent EC runs multiplexed onto one
device as an async ask/tell service (the port of ``deap_tpu/serve``).

Each :class:`Session` is an independent evolution run: its padded state
lives on the service's device (``device=``, default the card) between
requests, and every request kind is executed by a slot program whose
shapes come from the service's :class:`~deap_tpu_torch.serve.buckets.
BucketPolicy`:

* ``step``    — one full :func:`~deap_tpu_torch.algorithms.ea_step`
  generation (select → vary → evaluate on the device); sessions sharing a
  toolbox and a bucket are **slot-packed**: up to ``max_batch`` sessions
  advance in one dispatch, the batch's real slots one after another
  (pad slots are not run), and a slot's result depends only on that
  slot, so multiplexed results are bitwise identical to the same session
  served alone (held by ``tests/test_torch_serve.py``).  A megakernel
  session's step is the live-masked fused generation, which launches K1
  (``megakernel_vary``);
* ``ask`` / ``tell`` — the generate/update split for clients that evaluate
  externally: ``ask`` returns the varied offspring genomes, ``tell`` feeds
  fitness values back (``toolbox.quarantine`` applied to fresh rows);
* ``evaluate`` — fitness for an ad-hoc genome batch, **row-packed** across
  sessions into one padded bucket, deduplicated on the device
  (:func:`~deap_tpu_torch.serve.cache.rep_indices`) and served through the
  host :class:`~deap_tpu_torch.serve.cache.FitnessCache` (content-addressed,
  never caches non-finite values).

A program is built once per ``(kind, bucket, toolbox)`` and re-dispatched
from the cache; it records the shapes and dtypes it was built for, and a
dispatch whose state differs raises (where the JAX package would
recompile) instead of silently running another shape — so the
``compiles*`` counters in :class:`~deap_tpu_torch.serve.metrics.
ServeMetrics` count program builds exactly.  Backpressure, deadlines,
cancellation and retry semantics live in :class:`~deap_tpu_torch.serve.
dispatcher.BatchDispatcher`.

All device work runs on the dispatcher's worker thread: batches, and the
placements and host reads other threads hand it
(:meth:`~deap_tpu_torch.serve.dispatcher.BatchDispatcher.call`); the
worker binds the service's CUDA device (``torch.cuda.set_device``) first.
Results reach callers as CPU tensors.

Not ported yet (the next slice, queue 1 item 11b of ROADMAP.md):
pop-sharded sessions (``shard_threshold`` / ``mesh`` raise
:class:`NotImplementedError`), the fleet router and autoscaling.

::

    svc = EvolutionService(max_batch=4)            # device="cuda"
    s1 = svc.open_session(key1, pop1, toolbox, cxpb=0.6, mutpb=0.3)
    s2 = svc.open_session(key2, pop2, toolbox)
    futs = [s.step(10) for s in (s1, s2)]          # pipelined + microbatched
    for f in futs[0]: f.result()
    print(svc.stats())
    svc.close()
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import sanitize
from .._device import resolve_device
from ..base import Population, Fitness, _leaves, _map
from ..algorithms import ea_step, ea_ask, ea_tell, evaluate_rows
from ..observability import events as _events
from ..observability import fleettrace
from ..observability.fleettrace import FleetTracer
from ..observability.profiling import ProgramProfiler
from ..observability.sinks import emit_text
from .buckets import (BucketPolicy, BucketKey, ShapeHistogram, pad_rows,
                      unpad_rows, genome_signature)
from .cache import FitnessCache, flatten_rows, row_digests, rep_indices
from .dispatcher import (BatchDispatcher, Request, ServeFuture, ServeError,
                         ServiceClosed, ServiceDraining, SessionUnknown)
from .metrics import ServeMetrics

__all__ = ["EvolutionService", "Session", "build_slot_program",
           "SlotProgram", "NEXT_SLICE"]

#: where the parts of the JAX service not ported yet are queued
NEXT_SLICE = ("the next slice of the port (queue 1 item 11b of ROADMAP.md: "
              "pop-sharded sessions, the router and autoscaling)")


def _host(tree):
    """A tree of tensors as CPU tensors (a copy off the device)."""
    return _map(lambda x: x.detach().cpu(), tree)


def _to_numpy(x):
    """A host leaf for a snapshot: numpy, except bfloat16, which numpy
    lacks without ``ml_dtypes``: a CPU bfloat16 tensor (the wire encodes
    either under the same dtype token)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x
    return x.numpy()


def _host_numpy(tree):
    return _map(_to_numpy, tree)


def _as_tensor(x, copy: bool = True) -> torch.Tensor:
    """A leaf — numpy (``ml_dtypes`` bfloat16 included), a list, a scalar
    or a tensor — as a tensor: host leaves become CPU tensors (always
    copied); a tensor stays where it is, cloned to the host when
    ``copy``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone() if copy else x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _as_tensor_tree(tree, copy: bool = True):
    """A genome tree of leaves as tensors (:func:`_as_tensor`), its
    container structure kept."""
    if isinstance(tree, dict):
        return {k: _as_tensor_tree(tree[k], copy) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_tensor_tree(t, copy) for t in tree)
    return _as_tensor(tree, copy)


def _as_raw_key(key) -> torch.Tensor:
    """Canonical key form: the raw ``uint32`` words (2 for threefry, 4
    for rbg) as the port's int64 key tensor, on the host.  Accepts a
    port key tensor or raw words (numpy ``uint32``, as the JAX package's
    ``key_data`` and the wire carry them)."""
    if isinstance(key, torch.Tensor):
        return key.detach().cpu().to(torch.int64)
    words = np.asarray(key)
    if words.ndim == 0 or words.shape[-1] not in (2, 4):
        raise ValueError(f"key words of shape {words.shape}: the last "
                         "dimension is 2 (threefry2x32) or 4 (rbg)")
    return torch.from_numpy(words.astype(np.uint32).astype(np.int64))


def _signature(tree) -> tuple:
    """Shapes and dtypes of every tensor of a slot's arguments: what a
    built program was built for."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(t) for t in tree)
    return type(tree).__name__


class SlotProgram:
    """One built request-kind program: the per-slot function and the
    argument signature it was built for.  Calling it with a slot's
    arguments of another shape or dtype raises :class:`ServeError` — the
    JAX package would compile a new executable there, and a served shape
    that drifts is a bug to see, not a cost to hide."""

    def __init__(self, fn, signature: tuple, kind: str):
        self.fn = fn
        self.signature = signature
        self.kind = kind

    def __call__(self, *args):
        sig = _signature(args)
        if sig != self.signature:
            raise ServeError(
                f"{self.kind} program called with argument shapes "
                f"{sig} but built for {self.signature}: a shape drift "
                "the bucket policy should have prevented")
        return self.fn(*args)


def build_slot_program(kind: str, toolbox, weights: tuple):
    """Request-kind program over one session state dict (the dict
    ``EvolutionService._make_state`` builds: ``key``/``genome``/``values``/
    ``valid`` on the device, ``live_n``/``cxpb``/``mutpb`` 0-d host
    tensors, int32 and float32).  The service runs it once per real slot
    of a batch.

    The trajectory knobs (``cxpb``/``mutpb``) and the key ride in the
    state as operands, as in the JAX package: one program serves every
    session of the bucket whatever its knobs."""

    def as_population(state):
        return Population(state["genome"],
                          Fitness(values=state["values"],
                                  valid=state["valid"], weights=weights))

    def live_of(state):
        rows = state["valid"].shape[0]
        return torch.arange(rows, device=state["valid"].device) < \
            int(state["live_n"])

    def knobs(state):
        return float(state["cxpb"]), float(state["mutpb"])

    def pack(state, pop):
        return {**state, "genome": pop.genome,
                "values": pop.fitness.values, "valid": pop.fitness.valid}

    if kind == "step":
        def one(state):
            cx, mut = knobs(state)
            key, pop, nevals = ea_step(
                state["key"], as_population(state), toolbox, cx, mut,
                live=live_of(state))
            return {**pack(state, pop), "key": key}, nevals
        return one
    if kind == "init":
        def one(state):
            pop, nevals = ea_tell(toolbox, as_population(state),
                                  live=live_of(state))
            return pack(state, pop), nevals
        return one
    if kind == "ask":
        def one(state):
            cx, mut = knobs(state)
            key, off = ea_ask(state["key"], as_population(state),
                              toolbox, cx, mut, live=live_of(state))
            return ({**state, "key": key}, off.genome,
                    off.fitness.values, off.fitness.valid)
        return one
    if kind == "tell":
        def one(state, pending, values):
            pg, pv, pvalid = pending
            pop, nevals = ea_tell(
                toolbox, Population(pg, Fitness(pv, pvalid, weights)),
                values, live=live_of(state))
            return pack(state, pop), nevals
        return one
    raise ValueError(f"unknown slot program kind {kind!r}")


class Session:
    """One live evolution run inside an :class:`EvolutionService`.

    All methods are thread-safe and **asynchronous**: they enqueue a
    request and return a :class:`~deap_tpu_torch.serve.dispatcher.ServeFuture`
    (``step(n)`` returns a list of ``n`` chained futures).  State advances
    strictly in submission order; the service packs compatible requests
    from *different* sessions into shared device batches."""

    #: the protocol phase's check-and-transition runs under
    #: ``_phase_lock`` (client threads ask / step / tell, the dispatch
    #: worker completes a tell)
    _GUARDED_BY = {"_phase_lock": ("phase",)}

    def __init__(self, service: "EvolutionService", name: str, toolbox,
                 bucket: BucketKey, state: Dict[str, Any],
                 gen: int = 0, phase: str = "idle", pending=None,
                 streamed: bool = False, priority: int = 1):
        self._service = service
        self.name = name
        self.toolbox = toolbox
        self.bucket = bucket
        #: load-shedding class every request of this session carries
        #: (higher = more important; the fleet router stamps it from the
        #: owning tenant's quota) — under sustained queue pressure the
        #: dispatcher sheds lower-priority admissions first
        self.priority = int(priority)
        self._state = state          # swapped atomically by the dispatcher
        self._pending = pending      # offspring awaiting tell (phase=asked)
        self.gen = int(gen)
        self.phase = phase           # idle | asked
        self.closed = False
        #: live-migration quiesce flag: flipped ONLY under the
        #: dispatcher's queue lock (``set_session_migrating``), checked
        #: there at submit — while up, this session's submissions are
        #: rejected (``ServiceDraining``) and its pending work can only
        #: shrink; every other session keeps flowing
        self.migrating = False
        #: pop-sharded placement: not ported yet (the next slice)
        self.sharded = False
        #: generation dispatched through the out-of-core streamed engine
        #: (:mod:`deap_tpu_torch.bigpop`): host-driven sliced pipeline, no
        #: slot program, capacity-1 dispatch
        self.streamed = bool(streamed)
        #: objects pinned on this session's behalf (toolbox, evaluators) —
        #: captured at open/adopt time, released exactly once at close, so
        #: re-registering toolbox attributes mid-run can never skew the
        #: service's refcounts
        self._pins: List[Any] = []
        # guards the phase check-and-transition (concurrent ask()/step()
        # from two client threads must not both pass the guard); NEVER
        # held across a submit — the dispatcher takes its own lock first
        # on some failure paths, and the reverse order would deadlock
        self._phase_lock = sanitize.lock()

    def _rollback_ask(self) -> None:
        """Failure hook of an ask() that never executed (deadline miss,
        cancellation, batch fault): the session returns to 'idle' so the
        client can re-ask or step instead of being wedged."""
        with self._phase_lock:
            if self.phase == "asked" and self._pending is None:
                self.phase = "idle"

    # -- introspection -------------------------------------------------------

    @property
    def pop_size(self) -> int:
        # the live count is a host scalar of the state: no device read
        return int(self._state["live_n"])

    @property
    def weights(self) -> tuple:
        return self.bucket.weights

    def population(self) -> Population:
        """Current (unpadded) population as CPU tensors, copied on the
        dispatch worker."""
        def read():
            st = self._state
            n = int(st["live_n"])
            return Population(
                genome=_host(unpad_rows(st["genome"], n)),
                fitness=Fitness(values=_host(st["values"][:n]),
                                valid=_host(st["valid"][:n]),
                                weights=self.bucket.weights))
        return self._service._on_worker(read)

    # -- request API ---------------------------------------------------------

    def step(self, n: int = 1, deadline: Optional[float] = None,
             block: bool = False) -> List[ServeFuture]:
        """Advance ``n`` generations.  Returns the list of ``n``
        per-generation futures (each resolves to ``{"gen", "nevals"}``) —
        always a list, so call sites never branch on ``n``.  ``deadline``
        is seconds from now; a generation not dispatched by then fails
        (later ones still run on the state reached so far)."""
        with self._phase_lock:
            if self.phase != "idle":
                raise ServeError(f"session {self.name!r} has an "
                                 "outstanding ask(); tell() first")
        return self._service._submit_pipeline(self, "step", int(n),
                                              deadline, block)

    def ask(self, deadline: Optional[float] = None) -> ServeFuture:
        """Produce the next offspring batch (selection + variation, no
        evaluation).  Resolves to the host genome rows awaiting external
        evaluation; the session then expects :meth:`tell`.  An ask that
        fails before executing (deadline, cancellation, fault) rolls the
        session back to 'idle'."""
        with self._phase_lock:
            if self.phase != "idle":
                raise ServeError(f"session {self.name!r} already asked")
            self.phase = "asked"
        try:
            return self._service._submit(self, "ask", {}, deadline,
                                         on_failure=self._rollback_ask)
        except BaseException:
            self._rollback_ask()
            raise

    def tell(self, values, deadline: Optional[float] = None) -> ServeFuture:
        """Complete an :meth:`ask` with externally computed objective
        ``values`` (``(pop, nobj)`` or ``(pop,)``, one row per live
        individual); quarantine applies to the freshly assigned rows.
        Resolves to ``{"gen", "nevals"}``."""
        with self._phase_lock:
            if self.phase != "asked":
                raise ServeError(f"session {self.name!r} has no "
                                 "outstanding ask()")
        values = _as_tensor(values, copy=False)   # no device work here
        if values.shape[0] != self.pop_size:
            raise ValueError(
                f"tell() got {values.shape[0]} fitness rows for a "
                f"population of {self.pop_size}: every live individual "
                "needs a value (zero-filling the gap would silently "
                "assign fitness 0.0)")
        return self._service._submit(self, "tell", {"values": values},
                                     deadline)

    def evaluate(self, genomes, deadline: Optional[float] = None
                 ) -> ServeFuture:
        """Fitness for an ad-hoc genome batch (same structure as the
        session's genomes, any row count within the bucket policy; host
        arrays or tensors on any device, a tensor unchanged until the
        future resolves), served through the content-addressed cache.
        Resolves to a CPU ``(rows, nobj)`` float32 tensor."""
        return self._service._submit_evaluate(self, genomes, deadline)

    def close(self) -> None:
        """Detach from the service; queued requests fail at dispatch."""
        self.closed = True
        self._service._forget(self)


class EvolutionService:
    """Multi-tenant ask/tell evaluation service (see module docstring).

    Parameters
    ----------
    policy:
        Row :class:`~deap_tpu_torch.serve.buckets.BucketPolicy` (default: powers
        of two from 8).
    max_batch:
        Slot count of step/ask/tell microbatches — up to this many
        sessions advance per dispatch (the ``slot_occupancy`` gauge is
        the filled fraction).  A slot's result does not depend on it.
    max_pending / batch_window:
        Queue bound (backpressure) and optional linger seconds to fill a
        partial batch.
    brownout_watermark / brownout_grace_s:
        Priority load shedding (off by default): once the queue has sat
        at or above ``watermark * max_pending`` for ``grace`` seconds,
        admissions whose session priority is below the highest queued
        priority are shed with typed
        :class:`~deap_tpu_torch.serve.dispatcher.ServiceBrownout` — see
        :class:`~deap_tpu_torch.serve.dispatcher.BatchDispatcher`.
    cache_capacity / dedup_max_flat_dim:
        Host fitness-cache entries; flat genome width beyond which the
        device unique dedup is skipped.
    eval_retries / retry_backoff:
        Transient-fault retry budget around every device dispatch
        (:func:`deap_tpu_torch.resilience.with_retries`).
    device:
        Where session state lives and every program runs (default
        ``"cuda"``; raises :class:`~deap_tpu_torch.NoCudaDevice` without a
        card — pass ``device="cpu"`` to serve on the host on purpose).
        On the card the constructor builds (or loads) the CUDA kernels,
        so no build runs inside a request.
    shard_threshold / mesh:
        Pop-sharded sessions: not ported yet (the next slice) — passing
        either raises :class:`NotImplementedError`.
    sinks / stats_every:
        Observability: emit a stats :class:`MetricRecord` to ``sinks``
        every N batches (0 = never); compile events also go to the
        event tap when one is open.
    tracer:
        :class:`~deap_tpu_torch.observability.fleettrace.FleetTracer` recording
        the request span trees (queue wait / pad-bucket / cache lookup /
        device execute phases).  Default: a fresh enabled tracer on the
        service clock; pass ``FleetTracer(enabled=False)`` to opt out —
        the compiled programs and trajectories are identical either way
        (tracing is pure host bookkeeping).
    profiler:
        :class:`~deap_tpu_torch.observability.profiling.ProgramProfiler`
        recording per-program measured profiles: the build time (beside
        the ``compiles*`` counters — same event, same program key) and
        min-of-k execute walls at the exact ``device_execute`` span
        bounds (the JAX package's XLA cost fields are absent).  Default:
        a fresh enabled profiler on the service clock; pass
        ``ProgramProfiler(enabled=False)`` to opt out — pure host
        bookkeeping, bitwise-identical trajectories either way.  Read it
        back via :meth:`stats` (``meta["programs"]`` and the
        ``profile_programs`` gauge) or ``GET /v1/profile``.
    rebucket_policy:
        Optional :class:`~deap_tpu_torch.serve.rebucket.RebucketPolicy` —
        evaluated after every dispatched batch; fires
        :meth:`rebucket` automatically on histogram drift + pad waste
        (see :meth:`set_rebucket_policy`).
    fault_hook:
        Test seam: called as ``fault_hook(kind, requests)`` before every
        batch execution (raise to inject an evaluation fault).
    """

    #: lock-guarded shared state: the session table, the pin refcounts,
    #: and the admission name reservations are written from any client
    #: thread and read by the dispatch worker — writes only under
    #: ``with self._lock:``.  NOT registered: ``_programs`` (worker-
    #: thread-owned in steady state, locked only where client paths touch
    #: it) and ``_draining`` (opportunistic flag; the authoritative gate
    #: is the dispatcher's, under ITS queue lock).
    _GUARDED_BY = {"_lock": ("_sessions", "_refs", "_refcounts",
                             "_reserved", "_names")}

    def __init__(self, *, policy: Optional[BucketPolicy] = None,
                 max_batch: int = 4, max_pending: int = 256,
                 batch_window: float = 0.0,
                 brownout_watermark: Optional[float] = None,
                 brownout_grace_s: float = 0.0,
                 cache_capacity: int = 4096,
                 dedup_max_flat_dim: int = 512, eval_retries: int = 2,
                 retry_backoff: float = 0.05, sinks: Sequence = (),
                 stats_every: int = 0, verbose: bool = False,
                 shard_threshold: Optional[int] = None, mesh=None,
                 tracer: Optional[FleetTracer] = None,
                 profiler: Optional[ProgramProfiler] = None,
                 rebucket_policy=None,
                 fault_hook=None, clock=time.monotonic, device=None):
        if shard_threshold is not None or mesh is not None:
            raise NotImplementedError(
                "pop-sharded sessions (shard_threshold / mesh) are not "
                f"ported yet: they come with {NEXT_SLICE}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                # the worker binds this exact card (set_device needs one)
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            # the CUDA kernels are built (or loaded from the build
            # directory) here, never inside a request's deadline
            from .. import kernels
            kernels.load()
        self.policy = policy if policy is not None else BucketPolicy()
        self.max_batch = int(max_batch)
        self.dedup_max_flat_dim = int(dedup_max_flat_dim)
        self.sinks = list(sinks)
        self.stats_every = int(stats_every)
        self.verbose = bool(verbose)
        self.metrics = ServeMetrics()
        self.cache = FitnessCache(cache_capacity, metrics=self.metrics)
        self.shapes = ShapeHistogram()
        self.tracer = (tracer if tracer is not None
                       else FleetTracer(clock=clock))
        self.profiler = (profiler if profiler is not None
                         else ProgramProfiler(clock=clock))
        self._rebucket_policy = None
        self._fault_hook = fault_hook
        self._clock = clock
        self._programs: Dict[tuple, SlotProgram] = {}
        # id() pins keep toolboxes/evaluators alive (program keys use
        # id(), which must not be recycled) — refcounted per session so a
        # long-lived service releases dead tenants' objects AND their
        # programs instead of leaking them forever
        self._refs: Dict[int, Any] = {}
        self._refcounts: Dict[int, int] = {}
        self._sessions: Dict[str, Session] = {}
        self._reserved: set = set()   # names mid-admission (see _admit)
        self._names = 0
        self._lock = sanitize.lock()
        self._closed = False
        self._draining = False
        dev = self.device
        self._dispatcher = BatchDispatcher(
            self._execute, max_pending=max_pending,
            batch_window=batch_window,
            brownout_watermark=brownout_watermark,
            brownout_grace_s=brownout_grace_s, metrics=self.metrics,
            retries=eval_retries, backoff=retry_backoff, clock=clock,
            tracer=self.tracer, after_batch=self._after_batch,
            worker_init=((lambda: torch.cuda.set_device(dev))
                         if dev.type == "cuda" else None))
        if rebucket_policy is not None:
            self.set_rebucket_policy(rebucket_policy)

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        self._closed = True
        self._dispatcher.close()

    def _on_worker(self, fn):
        """``fn()`` run on the dispatch worker (in place when called
        there): the one thread that touches the device."""
        return self._dispatcher.call(fn)

    def _sync(self) -> None:
        """Wait for the device's queued work (worker thread): the execute
        walls the profiler and the trace spans record end here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def quiesce(self):
        """Pause dispatch (in-flight batch completes) — session states are
        stable inside the context.  Queued requests resume after."""
        self._dispatcher.pause()
        try:
            yield
        finally:
            self._dispatcher.resume()

    def stats(self, *, programs: bool = True):
        """Current :class:`~deap_tpu_torch.observability.sinks.MetricRecord`
        — counters (requests/compiles/cache/...) + gauges (queue depth,
        occupancy, pad waste, latency p50/p90/p99); per-tenant SLO
        counters ride in ``meta["tenants"]`` and (with the profiler
        enabled) the per-program table in ``meta["programs"]``.
        ``programs=False`` skips building the program table (the
        streaming metrics endpoint emits one record per batch)."""
        from .rebucket import pad_waste_of
        live = self.sessions()
        self.metrics.set_gauge("sessions", len(live))
        self.metrics.set_gauge(
            "sessions_streamed",
            sum(1 for s in live.values() if s.streamed))
        self.metrics.set_gauge("pad_waste", pad_waste_of(self))
        # always written: after a live `profiler.enabled = False` the
        # gauge must read zero, not freeze at the last enabled value
        agg = (self.profiler.aggregates() if self.profiler.enabled
               else {"programs": 0.0})
        self.metrics.set_gauge("profile_programs", agg["programs"])
        rec = self.metrics.snapshot(self._dispatcher.batches)
        if programs and self.profiler.enabled:
            table = self.profiler.profiles()
            if table:
                rec.meta["programs"] = table
        return rec

    def set_rebucket_policy(self, policy) -> None:
        """Install (or, with ``None``, remove) the auto-rebucket policy.
        The policy's drift baseline anchors to the current shape
        histogram; from then on :meth:`RebucketPolicy.tick` runs on the
        dispatch worker after every batch and may fire
        :meth:`rebucket` at that quiesce point."""
        if policy is not None:
            policy.observe_baseline(self)
        self._rebucket_policy = policy

    def _after_batch(self) -> None:
        """Dispatcher worker hook (post-batch, not busy, no locks held):
        evaluate the auto-rebucket policy.  Policy failures are counted
        and reported, never propagated — the dispatch worker must
        survive a control-loop bug."""
        policy = self._rebucket_policy
        if policy is None:
            return
        try:
            info = policy.tick(self)
        except Exception as e:  # noqa: BLE001 — contained by design
            self.metrics.inc("rebucket_policy_errors")
            if self.verbose:
                emit_text(f"[serve] rebucket policy error: {e!r}",
                          self.sinks)
            return
        if info is not None and self.verbose:
            emit_text(f"[serve] auto-rebucket fired: sizes={info['sizes']} "
                      f"moved={info['moved']} compiles={info['compiles']}",
                      self.sinks)

    @property
    def draining(self) -> bool:
        return self._draining

    def wait_for_activity(self, seen: int,
                          timeout: Optional[float] = None) -> int:
        """Block until the dispatched-batch count exceeds ``seen`` (or
        ``timeout``); returns the current count.  Condition-based — the
        streaming metrics endpoint tails service activity through this."""
        return self._dispatcher.wait_for_batches(seen, timeout=timeout)

    def drain(self, timeout: Optional[float] = 60.0) -> Dict[str, dict]:
        """Failover step 1 of 2: stop admitting work, flush the queue, and
        return the final host snapshot of every live session (the payload
        :meth:`restore_sessions` / :meth:`adopt_sessions` consumes on the
        replacement instance).

        After ``drain()`` every further submission raises
        :class:`~deap_tpu_torch.serve.dispatcher.ServiceDraining`; the already
        queued requests execute to completion first, so the snapshot sits
        at a request boundary every client observed.  If the queue fails
        to flush within ``timeout`` the drain RAISES (still draining —
        retry with a larger timeout) rather than snapshotting state that
        queued requests would advance past.  The service stays up for
        metrics/introspection until :meth:`close`."""
        self._draining = True
        # the dispatcher-level flag is the authoritative gate: it flips
        # under the queue lock, so a submit racing this drain either
        # lands BEFORE it (and flushes below) or is rejected — never
        # between the flush and the snapshot
        self._dispatcher.set_draining(True)
        if not self._dispatcher.drain(timeout=timeout):
            raise ServeError(
                f"drain timed out after {timeout}s with "
                f"{self._dispatcher.queue_depth} requests still pending — "
                "the service remains draining; retry with a larger "
                "timeout (snapshotting now would lose queued progress)")
        snaps = self.snapshot_sessions()
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            s.closed = True
        # postmortem flight record: the last spans before this instance
        # went away, through the ordinary sink stack (no sinks, no write)
        self.tracer.dump("drain", self.sinks, force=True)
        return snaps

    # -- sessions ------------------------------------------------------------

    def open_session(self, key, population: Population, toolbox, *,
                     cxpb: float = 0.5, mutpb: float = 0.2,
                     name: Optional[str] = None, evaluate_initial: bool = True,
                     priority: int = 1,
                     timeout: Optional[float] = 60.0) -> Session:
        """Register a run and (synchronously, by default) evaluate its
        initial population through the service.  ``population`` is the
        UNPADDED initial population (tensors on any device, or host
        arrays); the service pads it to its bucket and places it on its
        device.  ``priority`` is the session's load-shedding class (see
        :class:`Session`)."""
        fit = population.fitness
        population = Population(   # host arrays as CPU tensors, no copy
            _as_tensor_tree(population.genome, copy=False),
            Fitness(values=_as_tensor(fit.values, copy=False),
                    valid=_as_tensor(fit.valid, copy=False),
                    weights=tuple(fit.weights)))
        session = self._admit(key, population, toolbox, cxpb=cxpb,
                              mutpb=mutpb, name=name, priority=priority)
        if evaluate_initial:
            self._submit(session, "init", {}).result(timeout=timeout)
        return session

    def _admit(self, key, population: Population, toolbox, *, cxpb: float,
               mutpb: float, name: Optional[str], gen: int = 0,
               phase: str = "idle", pending_host=None,
               priority: int = 1) -> Session:
        """Shared admission path of :meth:`open_session` and
        :meth:`adopt_sessions`: bucket, state build (placed and padded on
        the device by the worker), registration, pinning, shape
        observation."""
        if self._closed:
            raise ServiceClosed("service is closed")
        if self._draining:
            raise ServiceDraining("service is draining for failover")
        bucket = self.policy.bucket_for(population)
        # registry-typed admission: unknown engine strings and invalid
        # engine/mesh combos reject HERE, before any device state builds
        from ..engines import resolve_engine
        streamed = resolve_engine(toolbox) == "streamed"
        with self._lock:
            if name is None:
                name = f"session-{self._names}"
            self._names += 1
            # reserve the name NOW: the device-state build below runs
            # outside the lock, and two concurrent opens of the same name
            # (an HTTP create retried after a timeout) must not both pass
            # the check and silently shadow each other's registration
            if name in self._sessions or name in self._reserved:
                raise ValueError(f"session name {name!r} already open")
            self._reserved.add(name)
        try:
            self.shapes.observe(population.size)
            state, pending = self._on_worker(lambda: (
                self._make_state(key, population, bucket, cxpb, mutpb),
                None if pending_host is None else self._padded(
                    (pending_host["genome"], pending_host["values"],
                     pending_host["valid"]), bucket.rows)))
            session = Session(self, name, toolbox, bucket, state, gen=gen,
                              phase=phase, pending=pending,
                              streamed=streamed, priority=priority)
            session._pins = [toolbox]
            evaluate = getattr(toolbox, "evaluate", None)
            if evaluate is not None:
                session._pins.append(evaluate)
            with self._lock:
                self._sessions[name] = session
                self._pin_locked(session)
        finally:
            with self._lock:
                self._reserved.discard(name)
        return session

    def _padded(self, tree, rows: int):
        """A tree of host arrays or tensors (any device) as new tensors on
        the service's device, rows padded to ``rows`` (worker thread).
        Always a copy: a session never aliases its caller's tensors."""
        def put(x):
            x = _as_tensor(x, copy=False).to(self.device)
            return pad_rows(x, rows) if x.shape[0] != rows else x.clone()
        return _map(put, _as_tensor_tree(tree, copy=False))

    def sessions(self) -> Dict[str, Session]:
        with self._lock:
            return dict(self._sessions)

    def _pin_locked(self, session: Session) -> None:
        for obj in session._pins:
            oid = id(obj)
            self._refs[oid] = obj
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1

    def _pin_extra(self, session: Session, obj) -> None:
        """Refcounted late pin (an evaluator registered on the toolbox
        after the session opened): joins the session's pin set so close
        releases it exactly once — an unrefcounted pin here would let one
        session's close drop an evaluator its siblings still dispatch
        (the ``_refs.setdefault`` lifecycle bug)."""
        with self._lock:
            if any(p is obj for p in session._pins):
                return
            session._pins.append(obj)
            oid = id(obj)
            self._refs[oid] = obj
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1

    def _forget(self, session: Session) -> None:
        """Drop a closed session and, when its toolbox/evaluator pins hit
        refcount zero, release the pinned objects plus every compiled
        program AND fitness-cache namespace keyed on them.  The cache purge is load-bearing, not
        tidiness: entries are namespaced by ``id(evaluator)``, and a later
        evaluator allocated at the recycled address would otherwise be
        served the dead evaluator's fitness bit-for-bit."""
        with self._lock:
            if self._sessions.pop(session.name, None) is None:
                return          # already forgotten: don't double-release
            released = []
            for obj in session._pins:
                oid = id(obj)
                left = self._refcounts.get(oid, 0) - 1
                if left > 0:
                    self._refcounts[oid] = left
                    continue
                self._refcounts.pop(oid, None)
                self._refs.pop(oid, None)
                self._programs = {k: v for k, v in self._programs.items()
                                  if oid not in k[1][:2]}
                released.append(oid)
        for oid in released:
            self.cache.purge_namespace(oid)

    def _make_state(self, key, population: Population, bucket: BucketKey,
                    cxpb: float, mutpb: float) -> Dict[str, Any]:
        """The session's padded state (worker thread): ``key`` (the raw
        words), ``genome``/``values`` (float32)/``valid`` padded to the
        bucket on the device (pad rows zero and invalid), and the host
        scalars ``live_n`` (int32), ``cxpb``/``mutpb`` (float32)."""
        fit = population.fitness
        genome, values, valid = self._padded(
            (population.genome, fit.values, fit.valid), bucket.rows)
        return {"key": _as_raw_key(key).to(self.device),
                "genome": genome,
                "values": values.to(torch.float32),
                "valid": valid.to(torch.bool),
                "live_n": torch.tensor(population.size, dtype=torch.int32),
                "cxpb": torch.tensor(cxpb, dtype=torch.float32),
                "mutpb": torch.tensor(mutpb, dtype=torch.float32)}

    # -- request submission --------------------------------------------------

    def _deadline_at(self, deadline: Optional[float]) -> Optional[float]:
        return None if deadline is None else self._clock() + float(deadline)

    def _trace_ctx(self):
        """Per-request trace context: a child of the thread's current
        context (the HTTP handler installs the adopted wire context
        there) or a fresh root for in-process callers; ``None`` with
        tracing off."""
        if not self.tracer.enabled:
            return None
        return self.tracer.context(fleettrace.current())

    def _build_request(self, session: Session, kind: str, payload: dict,
                       deadline: Optional[float] = None,
                       on_failure=None) -> Request:
        if self._draining:
            raise ServiceDraining("service is draining for failover")
        if session.closed:
            raise ServiceClosed(f"session {session.name!r} is closed")
        if session.streamed:
            # a streamed session's generation runs the host-driven sliced
            # pipeline — nothing to co-batch, dispatch one at a time
            program_key: tuple = ("streamed", id(session.toolbox),
                                  session.bucket)
            capacity = 1
        else:
            program_key = (id(session.toolbox), session.bucket)
            capacity = self.max_batch
        req = Request(kind=kind, program_key=program_key,
                      payload=payload, session=session, weight=1,
                      capacity=capacity,
                      deadline=self._deadline_at(deadline),
                      trace=self._trace_ctx(),
                      priority=session.priority)
        if on_failure is not None:
            req.future._on_failure = on_failure
        return req

    def _submit(self, session: Session, kind: str, payload: dict,
                deadline: Optional[float] = None, block: bool = False,
                on_failure=None) -> ServeFuture:
        req = self._build_request(session, kind, payload, deadline,
                                  on_failure)
        return self._dispatcher.submit(req, block=block)

    def _submit_pipeline(self, session: Session, kind: str, n: int,
                         deadline: Optional[float] = None,
                         block: bool = False) -> List[ServeFuture]:
        """Queue ``n`` identical requests ATOMICALLY (all or none) —
        ``step(n)`` must never race a drain into queueing a prefix that
        executes while the call reports failure; see
        :meth:`BatchDispatcher.submit_many`."""
        reqs = [self._build_request(session, kind, {}, deadline)
                for _ in range(int(n))]
        return self._dispatcher.submit_many(reqs, block=block)

    def _submit_evaluate(self, session: Session, genomes,
                         deadline: Optional[float] = None) -> ServeFuture:
        if self._draining:
            raise ServiceDraining("service is draining for failover")
        if session.closed:
            raise ServiceClosed(f"session {session.name!r} is closed")
        # no device work here: host arrays become CPU tensors, tensors
        # stay where they are (unchanged until the future resolves); the
        # worker pads them and moves them over
        genomes = _as_tensor_tree(genomes, copy=False)
        sig = genome_signature(genomes)
        n = _leaves(genomes)[0].shape[0]
        rows = self.policy.rows_for(n)
        self.shapes.observe(n)
        evaluate = session.toolbox.evaluate
        # normally pinned at open_session; this covers an evaluator
        # registered on the toolbox after the session opened — refcounted
        # into the session's pin set, NOT a bare setdefault, so closing
        # one session cannot drop an evaluator a sibling still uses
        self._pin_extra(session, evaluate)
        nobj = session.bucket.nobj
        req = Request(kind="evaluate",
                      program_key=(id(evaluate), sig, rows, nobj),
                      payload={"genome": genomes, "n": n},
                      session=session, weight=n, capacity=rows,
                      deadline=self._deadline_at(deadline),
                      trace=self._trace_ctx(),
                      priority=session.priority)
        return self._dispatcher.submit(req)

    # -- program cache -------------------------------------------------------

    def _program(self, kind: str, program_key: tuple, build, args):
        """Build on first use; every later dispatch reuses the program,
        so the ``compiles`` counters count program builds exactly (a
        shape drift raises instead of silently running another shape).
        ``args`` is one slot's arguments: the signature the program
        holds every later call to."""
        key = (kind, program_key)
        program = self._programs.get(key)
        if program is None:
            t0 = self._clock()
            program = SlotProgram(build(), _signature(tuple(args)), kind)
            self._programs[key] = program
            self.metrics.inc("compiles")
            self.metrics.inc(f"compiles_{kind}")
            if self.profiler.enabled:
                self.profiler.observe_compile(kind, program_key,
                                              self._clock() - t0)
            if _events.active():     # event tap, if one is open
                _events.emit("serve_compiles", 1)
            if self.verbose:
                emit_text(f"[serve] compiled {kind} program "
                          f"#{self.metrics.counter('compiles')}", self.sinks)
        return program

    # -- program builders (one per request kind) -----------------------------

    def _build_slot_program(self, kind: str, toolbox, weights: tuple):
        return build_slot_program(kind, toolbox, weights)

    def _build_evaluate_program(self, evaluate, flat_dim: int):
        dedup = flat_dim <= self.dedup_max_flat_dim

        def prog(genome):
            values = evaluate_rows(evaluate, genome)
            if dedup:
                rep, _ = rep_indices(flatten_rows(genome))
                values = values[rep.long()]
            return values
        return prog

    # -- executors (dispatcher worker thread) --------------------------------

    def _execute(self, kind: str, program_key: tuple,
                 requests: List[Request]) -> list:
        if self._fault_hook is not None:
            self._fault_hook(kind, requests)
        if kind == "evaluate":
            # a stale (pre-rebucket) rows value still pads/executes
            # correctly — it just uses the old evaluate program
            return self._exec_evaluate(program_key, requests)
        healed = self._heal_stale_keys(program_key, requests)
        if healed is not None:
            return healed
        if program_key and program_key[0] == "streamed":
            return self._exec_streamed(kind, program_key, requests)
        return self._exec_slots(kind, program_key, requests)

    def _current_key(self, session: Session) -> tuple:
        if session.streamed:
            return ("streamed", id(session.toolbox), session.bucket)
        return (id(session.toolbox), session.bucket)

    def _heal_stale_keys(self, program_key: tuple,
                         requests: List[Request]) -> Optional[list]:
        """A submit that raced a rebucket can enqueue with a program key
        read from the PRE-refit bucket (remap_pending rewrites only
        already-queued requests).  Session state/buckets are
        authoritative at execution time: when they disagree with the
        batch's key, regroup by each session's current identity and
        dispatch the subgroups through the normal paths.  Returns None
        when the batch identity is already current (the common case)."""
        groups: Dict[tuple, List[Request]] = {}
        for r in requests:
            groups.setdefault(self._current_key(r.session), []).append(r)
        if len(groups) == 1 and next(iter(groups)) == program_key:
            return None
        out: Dict[int, Any] = {}
        for cur, reqs in groups.items():
            kind = reqs[0].kind
            if cur[0] == "streamed":
                # streamed dispatch is strictly one request at a time
                sub = [self._exec_streamed(kind, cur, [r])[0] for r in reqs]
            else:
                sub = self._exec_slots(kind, cur, reqs)
            for r, res in zip(reqs, sub):
                out[id(r)] = res
        return [out[id(r)] for r in requests]

    def _exec_streamed(self, kind: str, program_key: tuple,
                       requests: List[Request]) -> list:
        """Dispatch one streamed (out-of-core) session's request through
        the host-driven sliced pipeline (:mod:`deap_tpu_torch.bigpop`):
        the genome goes to the engine's host store, and a slice at a time
        to the device, on the engine's copy streams (created here, on the
        worker thread).  There is no slot program, so the ``compiles*``
        counters never move here; ``steps_streamed`` counts the
        generations instead.  Capacity 1: ``requests`` is always a single
        request."""
        from ..bigpop.engine import (StreamedEngine, streamed_ea_ask,
                                     streamed_ea_step)
        from ..bigpop.host import HostPopulation
        [req] = requests
        s = req.session
        state = s._state
        weights = s.bucket.weights
        rows = s.bucket.rows
        live = torch.arange(rows, device=self.device) < int(state["live_n"])
        cx, mut = float(state["cxpb"]), float(state["mutpb"])
        pop = Population(state["genome"],
                         Fitness(values=state["values"],
                                 valid=state["valid"], weights=weights))
        t_dev0 = self._clock()
        if kind == "step":
            key, out, nevals = streamed_ea_step(
                state["key"], pop, s.toolbox, cx, mut, live=live)
            s._state = {**state, "key": key.to(self.device),
                        "genome": out.genome,
                        "values": out.fitness.values,
                        "valid": out.fitness.valid}
            s.gen += 1
            self.metrics.inc("steps")
            self.metrics.inc("steps_streamed")
            self.metrics.inc_tenant(s.name, "steps")
            results = [{"gen": s.gen, "nevals": int(nevals)}]
        elif kind == "init":
            host = HostPopulation.from_population(pop, s.toolbox)
            eng = StreamedEngine(s.toolbox, host, device=self.device)
            nevals = eng.evaluate_initial(live_n=int(state["live_n"]))
            out = host.to_population(self.device)
            s._state = {**state, "values": out.fitness.values,
                        "valid": out.fitness.valid}
            results = [{"gen": s.gen, "nevals": int(nevals)}]
        elif kind == "ask":
            key, off = streamed_ea_ask(
                state["key"], pop, s.toolbox, cx, mut, live=live)
            s._state = {**state, "key": key.to(self.device)}
            s._pending = (off.genome, off.fitness.values, off.fitness.valid)
            results = [_host(unpad_rows(off.genome, s.pop_size))]
        elif kind == "tell":
            if s._pending is None:
                raise ServeError(
                    f"session {s.name!r} has no pending offspring (its "
                    "ask() may have failed) — re-ask before telling")
            pg, pv, pvalid = s._pending
            vals = self._pad_values(req.payload["values"], rows,
                                    s.bucket.nobj)
            # with externally computed values the tell half is O(pop)-small
            # fitness math — no genome-sized compute, resident ea_tell is
            # exact here
            out, nevals = ea_tell(
                s.toolbox, Population(pg, Fitness(pv, pvalid, weights)),
                vals, live=live)
            s._state = {**state, "genome": out.genome,
                        "values": out.fitness.values,
                        "valid": out.fitness.valid}
            with s._phase_lock:
                s._pending = None
                s.phase = "idle"
            s.gen += 1
            results = [{"gen": s.gen, "nevals": int(nevals)}]
        else:
            raise ServeError(f"unknown streamed request kind {kind!r}")
        self._sync()
        t_dev1 = self._clock()
        prof_attrs = self.profiler.observe_execute(kind, program_key,
                                                   t_dev1 - t_dev0)
        if req.trace is not None and self.tracer.enabled:
            self.tracer.phase("device_execute", req.trace, t_dev0, t_dev1,
                              attrs={"kind": kind, "streamed": True,
                                     **(prof_attrs or {})})
        self._maybe_emit_stats()
        return results

    def _exec_slots(self, kind: str, program_key: tuple,
                    requests: List[Request]) -> list:
        """Run one microbatch: the bucket's program once per real slot,
        one after another (the JAX package vmaps one executable over the
        slots padded to ``max_batch``; a slot's result is the same)."""
        sessions = [r.session for r in requests]
        t_pad0 = self._clock()
        toolbox = sessions[0].toolbox
        weights = sessions[0].bucket.weights
        build = lambda: self._build_slot_program(kind, toolbox, weights)  # noqa: E731

        if kind == "tell":
            for s in sessions:
                if s._pending is None:
                    raise ServeError(
                        f"session {s.name!r} has no pending offspring (its "
                        "ask() may have failed) — re-ask before telling")
            rows, nobj = sessions[0].bucket.rows, sessions[0].bucket.nobj
            args = [(s._state, s._pending,
                     self._pad_values(r.payload["values"], rows, nobj))
                    for r, s in zip(requests, sessions)]
        else:
            args = [(s._state,) for s in sessions]
        t_pad1 = self._clock()

        program = self._program(kind, program_key, build, args[0])
        t_dev0 = self._clock()
        outs = [program(*a) for a in args]

        self.metrics.set_gauge("slot_occupancy",
                               len(requests) / self.max_batch)
        results = []
        if kind == "ask":
            for s, (new_state, off_g, off_v, off_valid) in zip(sessions,
                                                               outs):
                s._state = new_state
                s._pending = (off_g, off_v, off_valid)
                results.append(_host(unpad_rows(off_g, s.pop_size)))
        else:
            nevals = [int(n) for _, n in outs]
            for s, (new_state, _), ne in zip(sessions, outs, nevals):
                s._state = new_state
                if kind == "step":
                    s.gen += 1
                    self.metrics.inc("steps")
                    self.metrics.inc_tenant(s.name, "steps")
                elif kind == "tell":
                    with s._phase_lock:
                        s._pending = None
                        s.phase = "idle"
                    s.gen += 1
                results.append({"gen": s.gen, "nevals": ne})
        self._sync()
        t_dev1 = self._clock()
        prof_attrs = self.profiler.observe_execute(kind, program_key,
                                                   t_dev1 - t_dev0)
        if self.tracer.enabled:
            # the microbatch's phases are shared work: each traced
            # request gets the same bounds under its own span
            for r in requests:
                if r.trace is not None:
                    self.tracer.phase(
                        "pad_bucket", r.trace, t_pad0, t_pad1,
                        attrs={"rows": sessions[0].bucket.rows,
                               "slots": len(requests)})
                    self.tracer.phase("device_execute", r.trace,
                                      t_dev0, t_dev1,
                                      attrs={"kind": kind,
                                             **(prof_attrs or {})})
        self._maybe_emit_stats()
        return results

    def _pad_values(self, values, rows: int, nobj: int) -> torch.Tensor:
        values = _as_tensor(values, copy=False).to(
            device=self.device, dtype=torch.float32)
        if values.ndim == 1:
            values = values[:, None]
        return pad_rows(values, rows)

    def _exec_evaluate(self, program_key: tuple,
                       requests: List[Request]) -> list:
        evaluate_id, sig, rows, nobj = program_key
        with self._lock:
            # the ref is pinned by the requests' sessions, but the dict
            # itself is shared with open/close on the API threads
            evaluate = self._refs[evaluate_id]
        genomes = [r.payload["genome"] for r in requests]
        counts = [r.payload["n"] for r in requests]
        total = sum(counts)
        t_pad0 = self._clock()
        merged = _map(lambda *xs: torch.cat(xs, 0), *genomes)
        padded = _map(lambda x: pad_rows(x.to(self.device), rows), merged)
        t_pad1 = self._clock()

        flat = flatten_rows(merged)
        digests = row_digests(flat)
        namespace = (evaluate_id, sig, nobj)
        hits = self.cache.lookup(namespace, digests)
        t_cache = self._clock()
        self.metrics.inc("dedup_rows", total - len(set(digests)))
        self.metrics.set_gauge("row_occupancy", total / rows)
        # per-tenant cache attribution: each request owns a contiguous
        # row range of the merged batch
        off = 0
        for r, n in zip(requests, counts):
            k = sum(1 for h in hits[off:off + n] if h is not None)
            self.metrics.inc_tenant(r.tenant, "cache_hits", k)
            self.metrics.inc_tenant(r.tenant, "cache_misses", n - k)
            off += n

        t_dev0 = t_dev1 = None
        if all(h is not None for h in hits):
            values = np.stack(hits).astype(np.float32)
        else:
            flat_dim = flat.shape[1]
            build = lambda: self._build_evaluate_program(  # noqa: E731
                evaluate, flat_dim)
            program = self._program("evaluate", program_key, build,
                                    (padded,))
            t_dev0 = self._clock()
            # a writable host copy: cached rows are spliced over it below
            values = program(padded)[:total].detach().cpu().numpy().copy()
            if values.ndim == 1:
                values = values[:, None]
            miss = [i for i, h in enumerate(hits) if h is None]
            self.cache.insert(namespace, [digests[i] for i in miss],
                              values[miss])
            for i, h in enumerate(hits):
                if h is not None:
                    values[i] = h
            t_dev1 = self._clock()
        self.metrics.inc("evaluations", total)
        prof_attrs = None
        if t_dev0 is not None:
            prof_attrs = self.profiler.observe_execute(
                "evaluate", program_key, t_dev1 - t_dev0)
        if self.tracer.enabled:
            for r in requests:
                if r.trace is None:
                    continue
                self.tracer.phase("pad_bucket", r.trace, t_pad0, t_pad1,
                                  attrs={"rows": rows, "live": total})
                self.tracer.phase("cache_lookup", r.trace, t_pad1, t_cache,
                                  attrs={"rows": total})
                if t_dev0 is not None:
                    self.tracer.phase("device_execute", r.trace,
                                      t_dev0, t_dev1,
                                      attrs={"kind": "evaluate",
                                             **(prof_attrs or {})})

        results, off = [], 0
        for n in counts:
            results.append(torch.from_numpy(values[off:off + n].copy()))
            off += n
        self._maybe_emit_stats()
        return results

    def _maybe_emit_stats(self) -> None:
        if (self.stats_every and self.sinks
                and self._dispatcher.batches % self.stats_every == 0):
            self.metrics.emit(self.sinks, self._dispatcher.batches)

    # -- checkpoint / restore ------------------------------------------------

    def snapshot_sessions(self) -> Dict[str, dict]:
        """Host-side snapshot of every live session (unpadded state +
        run metadata) — the payload
        :func:`deap_tpu_torch.resilience.save_session_states` persists."""
        with self.quiesce():
            sessions = self.sessions()
            return self._on_worker(lambda: {
                name: self._snapshot_one(s) for name, s in sessions.items()})

    @staticmethod
    def _snapshot_one(s: Session) -> dict:
        """One session's host snapshot (the versioned wire/checkpoint
        form, the JAX package's keys and host types: numpy arrays — a
        bfloat16 genome as a CPU tensor —, the key as its raw ``uint32``
        words, Python scalars).  Worker thread; the caller must hold the
        session at a dispatch boundary — either the global
        :meth:`quiesce` or the single-session migration quiesce
        (``migrating`` flag + ``wait_session_idle``)."""
        st = s._state
        n = int(st["live_n"])
        snap = {"gen": s.gen, "phase": s.phase, "n": n,
                "priority": s.priority,
                "weights": s.bucket.weights,
                "rows": s.bucket.rows,
                "key": st["key"].cpu().numpy().astype(np.uint32),
                "genome": _host_numpy(unpad_rows(st["genome"], n)),
                "values": st["values"][:n].cpu().numpy(),
                "valid": st["valid"][:n].cpu().numpy(),
                "cxpb": float(st["cxpb"]),
                "mutpb": float(st["mutpb"])}
        if s._pending is not None:
            pg, pv, pvalid = s._pending
            snap["pending"] = {"genome": _host_numpy(unpad_rows(pg, n)),
                               "values": pv[:n].cpu().numpy(),
                               "valid": pvalid[:n].cpu().numpy()}
        return snap

    def export_session(self, name: str, *,
                       timeout: Optional[float] = 30.0) -> dict:
        """Live-migration step 1 of 2: quiesce exactly ONE session at a
        dispatch boundary, snapshot it, and detach it from this instance
        — without draining, pausing, or otherwise disturbing its
        neighbors.

        The session's ``migrating`` flag flips under the dispatcher's
        queue lock, so every later submission for it is rejected with
        :class:`~deap_tpu_torch.serve.dispatcher.ServiceDraining` (the same
        provably-not-executed contract a drain gives: the caller re-sends
        to wherever the route now points).  Already-queued requests
        execute to completion first — the snapshot sits at a request
        boundary every client of this session observed, so adopting it
        elsewhere continues the trajectory bit-for-bit when bucket
        policies match.  Raises on timeout with the flag rolled back
        (the session keeps serving here)."""
        with self._lock:
            s = self._sessions.get(name)
        if s is None:
            raise SessionUnknown(f"no session named {name!r}")
        self._dispatcher.set_session_migrating(s, True)
        try:
            if not self._dispatcher.wait_session_idle(s, timeout=timeout):
                raise ServeError(
                    f"session {name!r} did not reach a dispatch boundary "
                    f"within {timeout}s — migration aborted, the session "
                    "keeps serving on this instance")
            snap = self._on_worker(lambda: self._snapshot_one(s))
        except BaseException:
            self._dispatcher.set_session_migrating(s, False)
            raise
        s.closed = True
        self._forget(s)
        return snap

    def checkpoint(self, path, **io_kwargs) -> None:
        """Persist every live session through the resilient checkpoint
        tier (see :func:`deap_tpu_torch.resilience.save_session_states`)."""
        from ..resilience.runner import save_session_states
        save_session_states(path, self.snapshot_sessions(), **io_kwargs)

    def restore_sessions(self, path, toolboxes: Dict[str, Any],
                         **io_kwargs) -> Dict[str, Session]:
        """Re-open the sessions checkpointed at ``path``.  ``toolboxes``
        maps session name → toolbox (functions are not persisted); only
        named sessions are restored.  Bucketing re-applies the CURRENT
        policy, so restore works across policy changes."""
        from ..resilience.runner import load_session_states
        return self.adopt_sessions(load_session_states(path, **io_kwargs),
                                   toolboxes)

    def adopt_sessions(self, snaps: Dict[str, dict],
                       toolboxes: Dict[str, Any]) -> Dict[str, Session]:
        """Re-open sessions from an in-memory snapshot dict (the
        :meth:`snapshot_sessions` / :meth:`drain` payload) — the transport-
        agnostic half of :meth:`restore_sessions`, and what the network
        frontend's cross-instance failover feeds after moving the snapshot
        over the wire.  Bucketing re-applies the CURRENT policy; when a
        snapshot records the bucket ``rows`` it was padded to and this
        instance buckets differently, a warning is emitted — the live-row
        trajectory is a function of the session's bucket, so bitwise
        continuation needs matching policies."""
        out: Dict[str, Session] = {}
        for name, toolbox in toolboxes.items():
            snap = snaps[name]
            pop = Population(
                genome=_as_tensor_tree(snap["genome"]),
                fitness=Fitness(values=_as_tensor(snap["values"]),
                                valid=_as_tensor(snap["valid"]),
                                weights=tuple(snap["weights"])))
            pending_host = snap.get("pending")
            session = self._admit(snap["key"], pop, toolbox,
                                  cxpb=snap["cxpb"], mutpb=snap["mutpb"],
                                  name=name, gen=int(snap["gen"]),
                                  phase=snap["phase"],
                                  pending_host=pending_host,
                                  priority=int(snap.get("priority", 1)))
            want_rows = snap.get("rows")
            if want_rows is not None and int(want_rows) != session.bucket.rows:
                import warnings
                warnings.warn(
                    f"session {name!r} restored into bucket "
                    f"rows={session.bucket.rows} but was checkpointed at "
                    f"rows={want_rows}: the continuation will diverge from "
                    "the origin instance (match BucketPolicy for bitwise "
                    "failover)")
            out[name] = session
        return out

    # -- adaptive bucket grid ------------------------------------------------

    def rebucket(self, *, max_buckets: int = 8,
                 warm: Sequence[str] = ("step",),
                 sizes: Optional[Sequence[int]] = None) -> dict:
        """Re-derive the bucket grid from the observed request-shape
        histogram at a quiesce point.

        The default power-of-two grid is an a-priori guess; after real
        traffic the service knows better.  ``rebucket()`` pauses dispatch,
        fits an explicit grid to ``self.shapes`` (at most ``max_buckets``
        sizes, padding-cost-greedy —
        :func:`deap_tpu_torch.serve.derive_sizes`),
        re-pads every live session whose bucket changed (live rows are
        moved verbatim; the *continuation* trajectory is a function of the
        new bucket), installs the new policy, and eagerly builds the
        ``warm`` request kinds (any of ``step``/``init``/``ask``) for every
        live session so steady-state traffic after the quiesce point
        triggers **zero** unplanned builds.  All builds are counted
        through the ordinary tap (``compiles*`` counters + events), so the
        build budget of a rebucket is exactly observable.  Returns a summary dict (old/new sizes, moved
        sessions, compiles spent).

        ``sizes`` (optional) installs an EXPLICIT grid instead of
        deriving one from this instance's histogram — the predictive
        pre-warm path: a freshly scaled-out instance has observed no
        traffic (``derive_policy`` raises on an empty histogram), so the
        autoscaler pushes the fleet-merged grid the router's placement
        layer already tracks, and the first migrated-in session lands in
        a bucket compiled before its traffic arrives."""
        bad = [k for k in warm if k not in ("step", "init", "ask")]
        if bad:
            raise ValueError(f"cannot pre-warm kinds {bad!r} (tell needs a "
                             "pending offspring batch)")
        with self.quiesce():
            before = self.metrics.counter("compiles")
            old_sizes = self.policy.sizes
            if sizes is not None:
                if not sizes or any(int(r) < 1 for r in sizes):
                    raise ValueError(f"explicit bucket sizes {sizes!r} must "
                                     "be a non-empty list of positive rows")
                policy = BucketPolicy(
                    sizes=tuple(sorted(int(r) for r in sizes)),
                    min_rows=self.policy.min_rows,
                    max_rows=self.policy.max_rows, grow_beyond=True)
            else:
                policy = self.shapes.derive_policy(
                    max_buckets=max_buckets, min_rows=self.policy.min_rows,
                    max_rows=self.policy.max_rows)
            moved = []
            sessions = self.sessions()
            for name, s in sessions.items():
                rows = policy.rows_for(s.pop_size)
                if rows != s.bucket.rows:
                    self._on_worker(lambda s=s, rows=rows:
                                    self._move_session(s, rows))
                    moved.append(name)
            self.policy = policy
            # requests enqueued BEFORE the refit still carry program keys
            # built from the old buckets — rewrite them in place so they
            # dispatch through the new programs instead of feeding
            # new-shaped state to a stale executable
            self._dispatcher.remap_pending(self._remap_request)
            if moved:
                self._release_stale_buckets(sessions)
            self.metrics.inc("rebuckets")
            for kind in warm:
                for s in sessions.values():
                    self._on_worker(lambda kind=kind, s=s:
                                    self._warm_program(kind, s))
            spent = self.metrics.counter("compiles") - before
        if self.verbose:
            emit_text(f"[serve] rebucket: sizes={policy.sizes} "
                      f"moved={moved} compiles={spent}", self.sinks)
        return {"old_sizes": tuple(old_sizes), "sizes": policy.sizes,
                "moved": moved, "compiles": spent}

    def _release_stale_buckets(self, sessions: Dict[str, Session]) -> None:
        """Drop slot programs for buckets no live session occupies
        anymore — without this every rebucket that moves sessions strands
        a full program set per abandoned bucket for as long as the
        tenant's toolbox stays pinned.  (Evaluate programs are keyed on
        observed batch row counts, not session buckets, and are left
        alone.)"""
        tb_ids = {id(s.toolbox) for s in sessions.values()}
        keep = {(id(s.toolbox), s.bucket) for s in sessions.values()}

        def stale(pk: tuple) -> bool:
            if (len(pk) == 2 and pk[0] in tb_ids
                    and isinstance(pk[1], BucketKey)):
                return pk not in keep
            return False

        with self._lock:
            self._programs = {k: v for k, v in self._programs.items()
                              if not stale(k[1])}

    def _remap_request(self, req: Request) -> None:
        """Recompute one queued request's batching identity against the
        CURRENT policy/buckets (see :meth:`rebucket`)."""
        s = req.session
        if req.kind == "evaluate":
            eid, sig, _rows, nobj = req.program_key
            rows = self.policy.rows_for(req.payload["n"])
            req.program_key = (eid, sig, rows, nobj)
            req.capacity = rows
        elif s is not None:
            if s.streamed:
                req.program_key = ("streamed", id(s.toolbox), s.bucket)
            else:
                req.program_key = (id(s.toolbox), s.bucket)
                req.capacity = self.max_batch

    def _move_session(self, s: Session, rows: int) -> None:
        """Re-pad a live session's device state into a ``rows`` bucket
        (live rows are copied bit-for-bit; pad rows are rebuilt zeros).
        Worker thread."""
        n = s.pop_size
        st = s._state
        state = dict(st,
                     genome=pad_rows(unpad_rows(st["genome"], n), rows),
                     values=pad_rows(st["values"][:n], rows),
                     valid=pad_rows(st["valid"][:n], rows))
        pending = s._pending
        if pending is not None:
            pg, pv, pvalid = pending
            pending = (pad_rows(unpad_rows(pg, n), rows),
                       pad_rows(pv[:n], rows),
                       pad_rows(pvalid[:n], rows))
        s._state = state
        s._pending = pending
        s.bucket = dataclasses.replace(s.bucket, rows=rows)

    def _warm_program(self, kind: str, s: Session) -> None:
        """Build ``kind`` for ``s``'s current bucket ahead of traffic (no
        state is advanced — only the program cache is populated, through
        the ordinary counted :meth:`_program` path).  Streamed sessions
        run no slot program: nothing to build."""
        if s.streamed:
            return
        program_key = (id(s.toolbox), s.bucket)
        build = lambda: self._build_slot_program(  # noqa: E731
            kind, s.toolbox, s.bucket.weights)
        self._program(kind, program_key, build, (s._state,))
