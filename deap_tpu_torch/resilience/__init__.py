"""Resilient evolution runtime — the port's ``deap_tpu/resilience/``.

* :func:`with_retries` — bounded exponential-backoff retry for checkpoint
  I/O and the serving layer's dispatch (:mod:`.retry`).
* :class:`Quarantine` — non-finite fitness policy applied after every
  evaluation of the loops and the served sessions (:mod:`.quarantine`).
* :class:`FaultPlan` / :class:`FaultInjector` / :class:`VirtualClock` —
  declarative, deterministic fault schedules for tests and drills
  (:mod:`.faultinject`).
* :func:`run_resumable` — segment-and-checkpoint driver with exact
  resume for any loop of the port (the streamed one included), and
  :func:`save_session_states` / :func:`load_session_states` for the
  serving layer's sessions (:mod:`.runner`); :class:`Preempted` is what
  a driver raises after it checkpointed on a preemption notice.

Not ported yet (queue 1 item 11b of ROADMAP.md): the chaos plans
(``chaos.py``) and the chaos and fault drills.
"""

from .retry import with_retries, RetriesExhausted  # noqa: F401
from .quarantine import (Quarantine, NonFiniteFitnessError,  # noqa: F401
                         nonfinite_rows)
from .faultinject import FaultPlan, FaultInjector, VirtualClock  # noqa: F401
from .runner import (run_resumable, Preempted,  # noqa: F401
                     save_session_states, load_session_states)

__all__ = ["run_resumable", "Preempted", "save_session_states",
           "load_session_states", "with_retries", "RetriesExhausted",
           "Quarantine", "NonFiniteFitnessError", "nonfinite_rows",
           "FaultPlan", "FaultInjector", "VirtualClock"]
