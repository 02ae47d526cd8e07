"""Preemption-safe driver for streamed (out-of-core) runs.

At out-of-core scale a *generation* is minutes of streaming, and a
preemption notice in the middle of one would lose all of it.  This
driver checkpoints **between slices**: the host chunks, the slice cursor
and the already drained child prefix go to disk, and resume re-derives
the generation plan (a pure function of the pre-generation key and the
fitness table), then continues from slice *k*, bit for bit.

The checkpoint is the port's single-file tier
(:func:`~deap_tpu_torch.utils.checkpoint.save_checkpoint`), written with
:func:`~deap_tpu_torch.resilience.retry.with_retries`, by rank 0 alone
when ``torch.distributed`` is initialized.  Its format is the JAX
package's (``kind="bigpop-streamed"``, ``format`` 1, the cursor and the
staged prefix); the key is a tensor, stored as the checkpoint tier
stores keys.  A :class:`~deap_tpu_torch.resilience.faultinject.
FaultInjector`'s ``FaultPlan(preempt_at_gen=g)`` lands at the first
between-slice boundary of generation ``g``.  The undisturbed trajectory
equals :func:`~deap_tpu_torch.bigpop.engine.streamed_ea_simple` (same
key schedule), which equals the resident ``ea_simple``.
"""

from __future__ import annotations

import pickle
import signal as _signal
import time
from pathlib import Path
from typing import Optional

import torch

from .. import random
from ..ops.generation import GenomeStorage
from ..resilience.retry import with_retries
from ..resilience.runner import Preempted, _PreemptFlag, _trap_signals
from ..utils.checkpoint import save_checkpoint, load_checkpoint
from ..utils.support import Logbook
from .engine import _engine_for
from .host import HostPopulation

__all__ = ["run_streamed_resumable"]

_FORMAT = 1


def _snapshot(host: HostPopulation) -> dict:
    values, valid = host.fitness_arrays()
    return {"chunks": host.clone_chunks(), "values": values, "valid": valid,
            "weights": host.weights, "chunk_rows": host.chunk_rows,
            "storage": (host.storage.dtype, host.storage.bound)}


def _restore_host(state: dict) -> HostPopulation:
    dtype, bound = state["storage"]
    return HostPopulation(state["chunks"], state["values"], state["valid"],
                          state["weights"],
                          storage=GenomeStorage(dtype, bound),
                          chunk_rows=state["chunk_rows"])


def _saves_here() -> bool:
    """Rank 0 saves when ``torch.distributed`` is initialized; otherwise
    the one process does."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def run_streamed_resumable(key, population, toolbox, ngen: int, *,
                           ckpt_path, cxpb: float, mutpb: float,
                           checkpoint_every: int = 10,
                           slice_rows: Optional[int] = None,
                           io_retries: int = 3, io_backoff: float = 0.5,
                           io_sleep=time.sleep, io_clock=time.monotonic,
                           signals=(_signal.SIGTERM,), faults=None,
                           resume: str = "auto", verbose: bool = False,
                           device=None):
    """Drive a streamed run for ``ngen`` generations with
    generation-boundary checkpoints every ``checkpoint_every`` and
    **mid-generation** checkpoints on preemption.

    ``population`` is a :class:`~deap_tpu_torch.base.Population` (the
    engine runs on its tensors' device) or a :class:`HostPopulation`
    (on ``device``, default ``"cuda"``).  Returns ``(host_population,
    logbook)``; the trajectory and the logbook equal an uninterrupted
    :func:`~deap_tpu_torch.bigpop.engine.streamed_ea_simple` of the same
    arguments, whatever the preemptions and restarts.  Raises
    :class:`~deap_tpu_torch.resilience.Preempted` after saving."""
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if resume not in ("auto", "never", "require"):
        raise ValueError(f"resume {resume!r}: expected 'auto', 'never' "
                         "or 'require'")

    def _save_state(state) -> None:
        if _saves_here():
            save_checkpoint(ckpt_path, state)

    saver = faults.wrap_save(_save_state) if faults is not None \
        else _save_state
    saver = with_retries(saver, retries=io_retries, backoff=io_backoff,
                         sleep=io_sleep, clock=io_clock,
                         retry_on=(OSError, TimeoutError))
    loader = with_retries(load_checkpoint, retries=io_retries,
                          backoff=io_backoff, sleep=io_sleep, clock=io_clock,
                          retry_on=(OSError, TimeoutError))

    # -- resume ----------------------------------------------------------------
    gen = 0
    records: list = []
    cursor = None
    found = Path(ckpt_path).exists()
    if resume == "require" and not found:
        raise FileNotFoundError(
            f"resume='require' but no checkpoint at {ckpt_path}")
    fresh = not (resume != "never" and found)
    if fresh:
        eng = _engine_for(population, toolbox, slice_rows, device)
    else:
        # the host state stays on the host; only the key goes to the device
        state = loader(ckpt_path, device="cpu")
        if state.get("kind") != "bigpop-streamed" \
                or state.get("format") != _FORMAT:
            raise ValueError(f"{ckpt_path} is not a format-{_FORMAT} "
                             "streamed checkpoint")
        if device is None and not isinstance(population, HostPopulation):
            device = population.genome.device
        eng = _engine_for(_restore_host(state), toolbox, slice_rows, device)
        key = state["key"]
        gen = int(state["gen"])
        records = pickle.loads(state["records"])
        cursor = state["cursor"]
    host = eng.host
    key = key.to(eng.device)

    def _checkpoint(at_gen: int, cursor_state=None) -> None:
        state = dict(_snapshot(host), format=_FORMAT, kind="bigpop-streamed",
                     key=key, gen=int(at_gen),
                     records=pickle.dumps(records), cursor=cursor_state,
                     meta={"checkpoint_every": int(checkpoint_every),
                           "ngen": int(ngen)})
        saver(state)

    flag = _PreemptFlag()

    def hook_for(at_gen: int):
        def hook(_k: int) -> bool:
            if faults is not None:
                faults.maybe_preempt(at_gen, flag.trip)
            return flag.tripped
        return hook

    with _trap_signals(signals, flag):
        if fresh:
            key, _ = random.split(key)          # ea_simple's unused key
            records.append({"gen": 0, "nevals": eng.evaluate_initial()})
        while gen < ngen or cursor is not None:
            at_gen = gen + 1
            if cursor is not None:
                res = eng.run_generation(
                    key, cxpb, mutpb,
                    start_slice=int(cursor["slice"]),
                    staged_rows=cursor["staged_rows"],
                    staged_vals=cursor["staged_vals"],
                    slice_hook=hook_for(at_gen))
                cursor = None
            else:
                res = eng.run_generation(key, cxpb, mutpb,
                                         slice_hook=hook_for(at_gen))
            if not res.completed:
                _checkpoint(gen, {"slice": int(res.cursor),
                                  "staged_rows": res.staged_rows,
                                  "staged_vals": res.staged_vals})
                raise Preempted(gen, ckpt_path)
            key = res.key
            gen = at_gen
            records.append({"gen": gen, "nevals": res.nevals})
            boundary = gen >= ngen or gen % checkpoint_every == 0
            preempt = flag.tripped
            if preempt or boundary:
                _checkpoint(gen)
            if preempt and gen < ngen:
                raise Preempted(gen, ckpt_path)
            if verbose:
                print(f"[run_streamed_resumable] gen {gen}: "
                      f"nevals={records[-1]['nevals']}", flush=True)

    logbook = Logbook()
    logbook.header = ["gen", "nevals"]
    for rec in records:
        logbook.record(**rec)
    return host, logbook
