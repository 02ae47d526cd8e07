"""Preemption signalling shared by the resumable drivers (the part of
``deap_tpu/resilience/runner.py`` the streamed driver needs).

A preemption notice (SIGTERM, or a :class:`~deap_tpu_torch.resilience.
faultinject.FaultInjector`'s simulated one) trips a :class:`_PreemptFlag`;
the driver checkpoints and raises :class:`Preempted`, and re-running the
same call resumes from the checkpoint.  The generic ``run_resumable``
driver comes with the rest of ``resilience/``.
"""

from __future__ import annotations

import contextlib
import signal as _signal
import threading

__all__ = ["Preempted"]


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
