"""Deterministic fault injection (the port of
``deap_tpu/resilience/faultinject.py``).

Robustness claims must be *driven*, not hoped for: a recovery path is
exercised by injecting the fault it recovers from.  A :class:`FaultPlan`
declares the faults; a :class:`FaultInjector` is handed to a driver
(``run_streamed_resumable(..., faults=...)``) and delivers them
deterministically:

* ``nan_at_gen`` — the evaluation of generation ``g`` returns NaN for the
  chosen rows (:meth:`FaultInjector.poison_toolbox`; the port's
  ``run_resumable``, which installs it, comes with the rest of
  ``resilience/``);
* ``ckpt_fail_times`` — the first N checkpoint saves raise ``OSError``
  (a flaky shared filesystem); with ``ckpt_delay`` the virtual clock
  also makes them *slow*, driving ``with_retries``' timeout logic
  without real sleeping;
* ``preempt_at_gen`` — once the run reaches generation ``g`` the
  injector delivers the same preemption flag a real SIGTERM sets, so the
  driver takes the checkpoint-and-exit path (the streamed driver: at the
  first between-slice boundary of generation ``g``).

The injector records everything it did (``saves_failed``,
``gens_poisoned``, ``preempts_delivered``) so tests can assert the fault
actually fired: a recovery test whose fault never triggered is a false
pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

__all__ = ["FaultPlan", "FaultInjector", "VirtualClock"]


class VirtualClock:
    """A manually-advanced monotonic clock with a matching ``sleep`` —
    lets backoff/timeout logic run instantly in tests."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.sleeps: list[float] = []

    def time(self) -> float:
        return self.now

    def sleep(self, dt: float) -> None:
        self.sleeps.append(float(dt))
        self.now += float(dt)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule (all faults optional).

    ``nan_at_gen`` is 1-based (the loop's generation numbering); a plan
    targeting the generation-0 initial evaluation is rejected rather than
    silently never firing."""

    nan_at_gen: int | None = None        # poison this generation's eval
    nan_rows: Sequence[int] = (0,)       # rows to poison
    nan_value: float = float("nan")      # or e.g. inf
    ckpt_fail_times: int = 0             # first N saves raise OSError
    ckpt_delay: float = 0.0              # virtual seconds per save
    preempt_at_gen: int | None = None    # deliver preemption at gen >= g

    def __post_init__(self):
        if self.nan_at_gen is not None and self.nan_at_gen < 1:
            raise ValueError(
                f"nan_at_gen={self.nan_at_gen}: generations are 1-based; "
                "a gen-0 (initial-evaluation) fault would silently never "
                "fire")


class FaultInjector:
    """Stateful delivery of a :class:`FaultPlan` (one run per injector —
    counters are not reset on resume, which is exactly what a flaky
    filesystem looks like to a restarted process)."""

    def __init__(self, plan: FaultPlan, clock: VirtualClock | None = None):
        self.plan = plan
        self.clock = clock if clock is not None else VirtualClock()
        self.saves_attempted = 0
        self.saves_failed = 0
        self.gens_poisoned: list[int] = []
        self.preempts_delivered = 0

    # -- checkpoint I/O ------------------------------------------------------

    def wrap_save(self, save_fn: Callable) -> Callable:
        """Make ``save_fn`` fail the first ``ckpt_fail_times`` calls and
        cost ``ckpt_delay`` virtual seconds per attempt."""
        def save(*args, **kwargs):
            self.saves_attempted += 1
            if self.plan.ckpt_delay:
                self.clock.now += self.plan.ckpt_delay
            if self.saves_failed < self.plan.ckpt_fail_times:
                self.saves_failed += 1
                raise OSError(
                    f"injected checkpoint write failure "
                    f"#{self.saves_failed}/{self.plan.ckpt_fail_times}")
            return save_fn(*args, **kwargs)
        return save

    # -- evaluator poisoning -------------------------------------------------

    def poisons_gen(self, gen: int) -> bool:
        return self.plan.nan_at_gen is not None and gen == self.plan.nan_at_gen

    def _poison_rows(self, values: torch.Tensor, skip) -> torch.Tensor:
        """``nan_rows`` names the target rows when every row is assigned;
        when the loop assigns only rows whose fitness is invalid (``skip``
        marks the rest), the same COUNT of actually evaluated rows is
        poisoned instead, so the fault lands whenever anything is
        evaluated (a poison written to a skipped row would be discarded by
        the masked assignment: the false pass this module exists to
        prevent)."""
        count = len(tuple(self.plan.nan_rows))
        if skip is None:
            rows = torch.tensor(tuple(self.plan.nan_rows), dtype=torch.int64,
                                device=values.device)
        else:
            invalid_first = torch.argsort(
                torch.as_tensor(skip, device=values.device).to(torch.int8),
                stable=True)
            rows = invalid_first[:count]
        values = values.clone()
        values[rows] = self.plan.nan_value
        return values

    def poison_toolbox(self, toolbox, gen: int):
        """A shallow toolbox copy whose population-level evaluation writes
        ``nan_value`` into evaluated rows (see :meth:`_poison_rows`),
        registered as ``evaluate_population`` so it overrides either
        evaluation tier and receives the ``skip`` mask."""
        import copy
        from ..algorithms import _accepts_skip, evaluate_rows

        self.gens_poisoned.append(int(gen))
        if hasattr(toolbox, "evaluate_population"):
            base = toolbox.evaluate_population
            base_skip = _accepts_skip(base)

            def eval_pop(genome, skip=None):
                values = base(genome, skip=skip) if base_skip else base(genome)
                if values.ndim == 1:
                    values = values[:, None]
                return self._poison_rows(values, skip)
        else:
            evaluate = toolbox.evaluate

            def eval_pop(genome, skip=None):
                return self._poison_rows(evaluate_rows(evaluate, genome),
                                         skip)

        tb = copy.copy(toolbox)
        tb.evaluate_population = eval_pop
        return tb

    # -- preemption ----------------------------------------------------------

    def maybe_preempt(self, gen: int, deliver: Callable[[], None]) -> None:
        """Call ``deliver()`` (once) when the run has reached the planned
        preemption generation — the simulated SIGTERM."""
        if (self.plan.preempt_at_gen is not None
                and gen >= self.plan.preempt_at_gen
                and not self.preempts_delivered):
            self.preempts_delivered += 1
            deliver()
