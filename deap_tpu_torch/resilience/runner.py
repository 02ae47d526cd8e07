"""Preemption-safe resumable evolution driver, and the serving layer's
session checkpoints.

:func:`run_resumable` makes the reference's checkpoint pattern ("pickle
a dict every FREQ generations", doc/tutorials/advanced/checkpoint.rst) a
driver:

* the run is segmented into ``checkpoint_every``-generation calls of the
  loop;
* after each boundary the full run state — population, PRNG key,
  generation, hall-of-fame archive, logbook records — is checkpointed
  through :mod:`deap_tpu_torch.utils.checkpoint` with bounded retries
  (:func:`~deap_tpu_torch.resilience.retry.with_retries`) against flaky
  filesystems;
* SIGTERM (the preemption notice) trips a flag that is **agreed across
  ranks** at the next segment boundary (``torch.distributed``): every
  rank then checkpoints the same generation and the driver raises
  :class:`Preempted` — the scheduler restarts the job, and the same
  ``run_resumable`` call finds the checkpoint and resumes bit-exactly;
* with ``sharded=True`` the state goes through the per-rank tier
  (:func:`~deap_tpu_torch.utils.checkpoint.save_sharded_checkpoint`), so
  a restart may come back on another rank count: pass the template
  population on the new mesh.

Resume is exact: a run killed at any boundary and resumed produces the
bitwise-identical trajectory (population, fitness, logbook) of the same
driver left uninterrupted, because the per-segment key-split schedule is
a pure function of the generation number.  Any loop of the port with
``ea_simple``'s calling convention is a ``loop=``: ``ea_simple``,
``ea_mu_plus_lambda`` / ``ea_mu_comma_lambda`` (``mu`` / ``lambda_`` in
``loop_kwargs``), and the out-of-core
:func:`~deap_tpu_torch.bigpop.streamed_ea_simple`.

Fault paths are tested by injection:
``run_resumable(..., faults=FaultInjector(plan))`` deterministically
poisons an evaluation, fails checkpoint writes, or delivers a simulated
preemption — see :mod:`deap_tpu_torch.resilience.faultinject`.

:func:`save_session_states` / :func:`load_session_states` persist the
snapshot of an :class:`~deap_tpu_torch.serve.EvolutionService` (its
``snapshot_sessions()``: host numpy state, the key as raw ``uint32``
words) through the same retried tier.

The loops' ``telemetry`` is not ported yet (queue 1 item 12 of
ROADMAP.md): ``telemetry=`` raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import contextlib
import pickle
import signal as _signal
import threading
import time
import warnings
from pathlib import Path

import torch

from .. import random
from ..base import _leaves
from ..utils.checkpoint import (save_checkpoint, load_checkpoint,
                                save_sharded_checkpoint,
                                load_sharded_checkpoint, _read_commit)
from ..utils.support import Logbook
from .retry import with_retries

__all__ = ["run_resumable", "Preempted", "save_session_states",
           "load_session_states"]


class Preempted(RuntimeError):
    """The run was interrupted (SIGTERM or injected preemption) and its
    state was checkpointed at generation ``gen``; re-running the same
    driver call resumes from there."""

    def __init__(self, gen: int, path):
        super().__init__(
            f"preempted at generation {gen}; state checkpointed to {path} "
            "— re-run to resume")
        self.gen = gen
        self.path = path


class _PreemptFlag:
    def __init__(self):
        self.tripped = False

    def trip(self, *_args) -> None:
        self.tripped = True


@contextlib.contextmanager
def _trap_signals(signals, flag: _PreemptFlag):
    """Install flag-tripping handlers (main thread only: signal.signal
    raises elsewhere); always restore the previous handlers."""
    installed = []
    if threading.current_thread() is threading.main_thread():
        for s in signals:
            try:
                installed.append((s, _signal.signal(s, flag.trip)))
            except (ValueError, OSError):
                pass
    try:
        yield
    finally:
        for s, old in installed:
            _signal.signal(s, old)


def _dist_world() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _dist_rank() -> int:
    import torch.distributed as dist
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _dist_values(value: int) -> list:
    """Every rank's ``value`` (an int), in rank order, over the default
    group (a CPU tensor under gloo, the rank's card under NCCL)."""
    import torch.distributed as dist
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [int(p.item()) for p in parts]


def _global_any(flag: bool) -> bool:
    """Cross-rank OR — a preemption notice lands on ONE rank; every
    process must agree to take the checkpoint-and-exit path together."""
    if _dist_world() == 1:
        return bool(flag)
    return any(_dist_values(int(bool(flag))))


def _global_agree(value: int) -> int:
    """Rank 0's value, everywhere — resume decisions must not rest on
    every process re-reading a cached shared filesystem."""
    if _dist_world() == 1:
        return int(value)
    return _dist_values(int(value))[0]


def _nested_record(lb: Logbook, i: int) -> dict:
    """Re-nest entry ``i`` of a segment logbook (chapters back inside the
    record) so it can be re-``record()``-ed into the master logbook."""
    rec = dict(lb[i])
    for name, ch in lb.chapters.items():
        rec[name] = _nested_record(ch, i)
    return rec


def _has_checkpoint(path, sharded: bool) -> bool:
    p = Path(path)
    if not sharded:
        return p.exists()
    try:
        return _read_commit(p) is not None
    except ValueError:
        return True     # corrupt marker: surface the load error, not a
                        # silent fresh start over a half-dead checkpoint


def _device_of(population, key) -> torch.device:
    if isinstance(key, torch.Tensor):
        return key.device
    return _leaves(population.genome)[0].device


def _telemetry_refused() -> NotImplementedError:
    return NotImplementedError(
        "telemetry= is not ported to deap_tpu_torch yet (queue 1 item 12, "
        "the tooling: the loops' on-device metric buffer)")


_SESSION_FORMAT = 1


def save_session_states(ckpt_path, sessions: dict, *, io_retries: int = 3,
                        io_backoff: float = 0.5, io_sleep=time.sleep,
                        io_clock=time.monotonic) -> None:
    """Checkpoint the live-session snapshot of a
    :class:`deap_tpu_torch.serve.EvolutionService` (the dict its
    ``snapshot_sessions()`` returns: per-session host state + run
    metadata) through the same retried single-pickle tier
    :func:`run_resumable` uses — a flaky filesystem costs retries, not the
    service.  Rank 0 only under ``torch.distributed``.

    The on-disk payload wraps the snapshot in a versioned envelope so a
    future layout change can migrate instead of corrupting restores."""
    state = {"format": _SESSION_FORMAT,
             "sessions": {name: dict(snap)
                          for name, snap in sessions.items()}}

    def _save():
        if _dist_rank() == 0:
            save_checkpoint(ckpt_path, state)
    with_retries(_save, retries=io_retries, backoff=io_backoff,
                 sleep=io_sleep, clock=io_clock,
                 retry_on=(OSError, TimeoutError))()


def load_session_states(ckpt_path, *, io_retries: int = 3,
                        io_backoff: float = 0.5, io_sleep=time.sleep,
                        io_clock=time.monotonic) -> dict:
    """Load a :func:`save_session_states` checkpoint back into the
    snapshot dict ``EvolutionService.restore_sessions`` consumes (host
    numpy state: the snapshot holds no tensor)."""
    loader = with_retries(
        lambda p: load_checkpoint(p, device="cpu"), retries=io_retries,
        backoff=io_backoff, sleep=io_sleep, clock=io_clock,
        retry_on=(OSError, TimeoutError))
    state = loader(ckpt_path)
    fmt = state.get("format")
    if fmt != _SESSION_FORMAT:
        raise ValueError(f"unsupported session checkpoint format {fmt!r} "
                         f"(this build reads format {_SESSION_FORMAT})")
    return {name: dict(snap) for name, snap in state["sessions"].items()}


def run_resumable(key, population, toolbox, ngen: int, *, ckpt_path,
                  checkpoint_every: int = 10, loop=None,
                  loop_kwargs: dict | None = None, stats=None,
                  halloffame=None, telemetry=None, sharded: bool = False,
                  io_retries: int = 3, io_backoff: float = 0.5,
                  io_sleep=time.sleep, io_clock=time.monotonic,
                  signals=(_signal.SIGTERM,), faults=None,
                  resume: str = "auto", verbose: bool = False):
    """Drive ``loop`` for ``ngen`` generations with periodic +
    preemption-triggered checkpointing and exact resume.

    ``loop`` is any ``ea_simple``-family callable — signature
    ``loop(key, population, toolbox, ngen=..., stats=..., halloffame=...,
    **loop_kwargs) -> (population, logbook)`` — e.g.
    :func:`~deap_tpu_torch.algorithms.ea_simple` (the default) with
    ``loop_kwargs=dict(cxpb=0.5, mutpb=0.2)``,
    :func:`~deap_tpu_torch.algorithms.ea_mu_plus_lambda` with
    ``mu``/``lambda_`` in ``loop_kwargs``, or
    :func:`~deap_tpu_torch.bigpop.streamed_ea_simple`.

    ``ckpt_path`` is a file for the single-pickle tier or a directory
    when ``sharded=True`` (per-shard fragments; required for populations
    not fully addressable by one process, and what makes restoring onto a
    another rank count possible).  ``resume`` is ``"auto"`` (resume iff a
    checkpoint exists), ``"never"`` or ``"require"``.

    Checkpoint I/O runs under :func:`with_retries` (``io_retries`` /
    ``io_backoff``; ``io_sleep``/``io_clock`` are injectable for tests).
    On preemption the state is saved and :class:`Preempted` is raised so
    schedulers observe a non-zero exit.  Returns
    ``(population, logbook)`` with the logbook covering generation 0
    through ``ngen`` regardless of how many restarts happened.

    ``telemetry`` is not ported yet (queue 1 item 12): passing one
    raises :class:`NotImplementedError`.
    """
    if telemetry is not None:
        raise _telemetry_refused()
    if loop is None:
        from ..algorithms import ea_simple as loop
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if resume not in ("auto", "never", "require"):
        raise ValueError(f"resume {resume!r}: expected 'auto', 'never' "
                         "or 'require'")
    loop_kwargs = dict(loop_kwargs or {})
    plan = faults.plan if faults is not None else None
    pid = _dist_rank()
    device = _device_of(population, key)

    def _save_state(state) -> None:
        if sharded:
            save_sharded_checkpoint(ckpt_path, state)
        elif pid == 0:
            save_checkpoint(ckpt_path, state)

    saver = faults.wrap_save(_save_state) if faults is not None else _save_state
    if not (sharded and _dist_world() > 1):
        # Per-host retry of a MULTI-PROCESS sharded save is unsafe: the
        # save contains cross-host collectives (version broadcast,
        # barriers), and one host re-entering from the top after a local
        # OSError would pair its collectives against the other hosts'
        # mid-save ones.  A flaky write there must fail the step for every
        # host together; retry wrapping applies everywhere else.
        saver = with_retries(saver, retries=io_retries, backoff=io_backoff,
                             sleep=io_sleep, clock=io_clock,
                             retry_on=(OSError, TimeoutError))
    # loads are collective-free (pure local reads), so retrying them is
    # safe on any topology
    loader = with_retries(
        (lambda p, like: load_sharded_checkpoint(p, like, device=device))
        if sharded else (lambda p: load_checkpoint(p, device=device)),
        retries=io_retries, backoff=io_backoff, sleep=io_sleep,
        clock=io_clock, retry_on=(OSError, TimeoutError))

    def _hof_template():
        if halloffame is None:
            return None
        return (halloffame.state if halloffame.state is not None
                else halloffame.init_state(population))

    # -- resume --------------------------------------------------------------
    gen = 0
    records: list[dict] = []
    found = _global_agree(_has_checkpoint(ckpt_path, sharded))
    if resume == "require" and not found:
        raise FileNotFoundError(
            f"resume='require' but no checkpoint at {ckpt_path}")
    if resume != "never" and found:
        if sharded:
            like = {"population": population, "key": key,
                    "hof": _hof_template(), "telemetry": None,
                    "gen": 0, "records": b"",
                    "meta": {"checkpoint_every": 0, "ngen": 0}}
            state = loader(ckpt_path, like)
        else:
            state = loader(ckpt_path)
        population = state["population"]
        key = state["key"]
        hof_state = state["hof"]
        gen = int(state["gen"])
        records = pickle.loads(state["records"])
        if halloffame is not None and hof_state is not None:
            halloffame.state = hof_state
        saved_every = int(state["meta"]["checkpoint_every"])
        if saved_every != checkpoint_every:
            warnings.warn(
                f"resuming with checkpoint_every={checkpoint_every} but the "
                f"checkpoint was written with {saved_every}: the continued "
                "trajectory will not match an uninterrupted run (segment "
                "key-split schedule differs)")
        if verbose:
            from ..observability.sinks import emit_text
            emit_text(f"[run_resumable] resumed at generation {gen} "
                      f"from {ckpt_path}")
    else:
        # a fresh run starts fresh accumulators; continuation comes from
        # the checkpoint, never from leftover host state on the objects
        if halloffame is not None:
            halloffame.clear()

    flag = _PreemptFlag()

    def _checkpoint(at_gen: int) -> None:
        state = {"population": population, "key": key,
                 "hof": halloffame.state if halloffame is not None else None,
                 "telemetry": None,
                 "gen": int(at_gen), "records": pickle.dumps(records),
                 "meta": {"checkpoint_every": int(checkpoint_every),
                          "ngen": int(ngen)}}
        saver(state)

    # -- drive ---------------------------------------------------------------
    with _trap_signals(signals, flag):
        while gen < ngen:
            boundary = min(ngen, (gen // checkpoint_every + 1)
                           * checkpoint_every)
            seg_toolbox = toolbox
            seg_end = boundary
            if faults is not None and plan.nan_at_gen is not None \
                    and gen < plan.nan_at_gen <= boundary:
                if plan.nan_at_gen - 1 > gen:
                    seg_end = plan.nan_at_gen - 1  # stop short of it
                else:
                    seg_end = gen + 1              # the poisoned gen
                    seg_toolbox = faults.poison_toolbox(toolbox, seg_end)

            key, k_seg = random.split(key)
            population, seg_lb = loop(
                k_seg, population, seg_toolbox, ngen=seg_end - gen,
                stats=stats, halloffame=halloffame, **loop_kwargs)
            for i in range(len(seg_lb)):
                rec = _nested_record(seg_lb, i)
                local = int(rec.get("gen", i))
                if local == 0 and (gen > 0 or records):
                    continue      # segment-start record duplicates the
                                  # previous segment's final state
                rec["gen"] = gen + local
                records.append(rec)
            gen = seg_end

            if faults is not None:
                faults.maybe_preempt(gen, flag.trip)
            preempt = _global_any(flag.tripped)
            if preempt or gen >= ngen or gen % checkpoint_every == 0:
                _checkpoint(gen)
            if preempt:
                raise Preempted(gen, ckpt_path)

    logbook = Logbook()
    logbook.header = ["gen", "nevals"] + (stats.fields if stats else [])
    for rec in records:
        logbook.record(**rec)
    return population, logbook
