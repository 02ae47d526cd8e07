"""Bounded retries with exponential backoff for flaky I/O (the port of
``deap_tpu/resilience/retry.py``).

A long run writes its checkpoints to a shared filesystem, which fails
transiently: an NFS server hiccup must not kill an otherwise healthy
run.  :func:`with_retries` is the one retry policy; the clock and sleep
are injectable, so tests can assert the exact backoff sequence without
real waiting (``tests/test_torch_bigpop.py``).
"""

from __future__ import annotations

import random
import time
from functools import wraps
from typing import Callable

__all__ = ["with_retries", "RetriesExhausted"]


class RetriesExhausted(RuntimeError):
    """Raised when every attempt failed.  ``__cause__`` is the last
    underlying exception; ``attempts`` counts the calls made."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"gave up after {attempts} attempt(s): {last!r}")
        self.attempts = attempts
        self.last = last


def with_retries(fn: Callable | None = None, *, retries: int = 3,
                 backoff: float = 0.5, factor: float = 2.0,
                 max_backoff: float = 60.0, timeout: float | None = None,
                 retry_on: tuple = (OSError, TimeoutError, ConnectionError),
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 jitter: bool = False,
                 rng: Callable[[], float] | None = None,
                 on_retry: Callable | None = None):
    """Wrap ``fn`` so transient failures are retried with exponential
    backoff.

    * ``retries`` — how many times to retry after the first failure
      (``retries + 1`` total attempts).
    * ``backoff`` / ``factor`` / ``max_backoff`` — delay before retry
      ``i`` (0-based) is ``min(backoff * factor**i, max_backoff)``.
    * ``timeout`` — total deadline in seconds measured on ``clock``; once
      waiting for the next attempt would cross it, give up immediately.
    * ``retry_on`` — exception classes considered transient; anything else
      propagates on the first occurrence (a ``ValueError`` from a corrupt
      checkpoint must not be retried into oblivion).
    * ``jitter`` — FULL jitter (AWS-style): the actual delay before retry
      ``i`` is uniform in ``[0, min(backoff * factor**i, max_backoff)]``.
      Off by default so existing callers keep their exact deterministic
      backoff sequence; reconnect storms (every client of a crashed
      backend retrying in lockstep) are what it exists to break up.
    * ``rng`` — zero-arg callable returning a float in ``[0, 1)`` used by
      ``jitter`` (defaults to :func:`random.random`); injectable so tests
      can pin the jittered sequence.
    * ``sleep`` / ``clock`` — injectable for deterministic tests.
    * ``on_retry(attempt, exc, delay)`` — optional observer hook
      (receives the post-jitter delay actually slept).

    When every attempt fails, raises :class:`RetriesExhausted` chained to
    the last exception.  Usable as a decorator (``@with_retries(...)``) or
    as a direct wrapper (``with_retries(fn, retries=5)`` returns the
    wrapped callable).
    """
    if retries < 0:
        raise ValueError("retries must be >= 0")
    draw = rng if rng is not None else random.random

    def deco(func: Callable) -> Callable:
        @wraps(func)
        def wrapper(*args, **kwargs):
            start = clock()
            last: BaseException | None = None
            for attempt in range(retries + 1):
                try:
                    return func(*args, **kwargs)
                except retry_on as e:          # noqa: PERF203
                    last = e
                    if attempt == retries:
                        break
                    delay = min(backoff * factor ** attempt, max_backoff)
                    if jitter:
                        delay *= draw()
                    if timeout is not None and \
                            clock() - start + delay > timeout:
                        break
                    if on_retry is not None:
                        on_retry(attempt, e, delay)
                    if delay > 0:
                        sleep(delay)
            raise RetriesExhausted(attempt + 1, last) from last
        return wrapper

    return deco if fn is None else deco(fn)
