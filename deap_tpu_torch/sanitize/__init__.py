"""``deap_tpu_torch.sanitize`` — the lock factory of the serving layer.

Every lock, condition and event of ``deap_tpu_torch/serve/`` and
``observability/fleettrace.py`` is built here::

    from deap_tpu_torch import sanitize
    self._lock = sanitize.lock()        # threading.Lock()
    self._cv = sanitize.condition()     # threading.Condition()

With the sanitizer off these are the stdlib primitives themselves —
identical objects, zero overhead.  The classes that share state across
threads declare it in ``_GUARDED_BY`` (``{lock attribute: (guarded
attributes, ...)}``), the contract the runtime sanitizer checks.

The runtime sanitizer itself (the lockset race detector, the lock-order
witness, the stall watchdog and the guard shims that :func:`arm`
installs) is not ported yet: it comes with the tooling (queue 1 item 12
of ROADMAP.md).  Until then :func:`arm`, and a factory call in a process
started with ``DEAP_TPU_TSAN=1``, raise :class:`NotImplementedError`
rather than run unsanitized while the caller believes otherwise.
"""

from __future__ import annotations

import os
import threading

__all__ = ["TSAN_ENV", "lock", "rlock", "condition", "event", "active",
           "arm", "disarm"]

#: environment variable that arms the sanitizer from process start
TSAN_ENV = "DEAP_TPU_TSAN"

_NOT_PORTED = ("the runtime concurrency sanitizer is not ported to "
               "deap_tpu_torch yet (queue 1 item 12, the tooling); "
               "unset DEAP_TPU_TSAN or run the JAX package's sanitizer")


def _refuse_if_requested() -> None:
    if os.environ.get(TSAN_ENV, "") == "1":
        raise NotImplementedError(_NOT_PORTED)


def active() -> bool:
    """True while the sanitizer is armed — never, in this port (a
    process that asked for it with ``DEAP_TPU_TSAN=1`` raises)."""
    _refuse_if_requested()
    return False


def lock():
    """A mutex: ``threading.Lock()``."""
    _refuse_if_requested()
    return threading.Lock()


def rlock():
    """A reentrant mutex: ``threading.RLock()``."""
    _refuse_if_requested()
    return threading.RLock()


def condition(lock=None):
    """A condition variable: ``threading.Condition(lock)`` (the default
    lock is reentrant, as in the stdlib)."""
    _refuse_if_requested()
    return threading.Condition(lock)


def event():
    """A ``threading.Event`` (events carry no mutual exclusion to check)."""
    _refuse_if_requested()
    return threading.Event()


def arm(**_kwargs):
    """Arm the runtime sanitizer: not ported yet (item 12) — raises."""
    raise NotImplementedError(_NOT_PORTED)


def disarm():
    """Disarm the runtime sanitizer: not ported yet (item 12) — raises."""
    raise NotImplementedError(_NOT_PORTED)
