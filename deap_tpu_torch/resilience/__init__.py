"""Resilient evolution runtime: the part of ``deap_tpu/resilience/`` that
the streamed driver (:func:`deap_tpu_torch.bigpop.run_streamed_resumable`)
needs.

* :func:`with_retries` — bounded exponential-backoff retry for checkpoint
  I/O (:mod:`.retry`).
* :class:`FaultPlan` / :class:`FaultInjector` / :class:`VirtualClock` —
  declarative, deterministic fault schedules for tests and drills
  (:mod:`.faultinject`).
* :class:`Preempted` — raised by a driver after it checkpointed on a
  preemption notice (:mod:`.runner`).

Not ported yet (queue 1 item 11): ``run_resumable`` (the generic
segment-and-checkpoint driver, and with it the streamed loop as its
``loop=``), ``Quarantine``, the chaos plans and the fault and chaos
drills, and the serve layer's session checkpoints.
"""

from .retry import with_retries, RetriesExhausted  # noqa: F401
from .faultinject import FaultPlan, FaultInjector, VirtualClock  # noqa: F401
from .runner import Preempted  # noqa: F401

__all__ = ["Preempted", "with_retries", "RetriesExhausted", "FaultPlan",
           "FaultInjector", "VirtualClock"]
