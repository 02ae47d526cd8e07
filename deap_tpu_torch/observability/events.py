"""Event tap — how deep library code reports countable events to an
enclosing collector without threading a carry argument through every
call signature.

Operators, policies and the serving layer (quarantine, program builds)
call :func:`emit` with scalar values — Python numbers or 0-d tensors,
which stay on their device.  A caller that wants the counts wraps the
work in :func:`collect` and drains the emitted values, summed by name.

When no collector is active (the default), :func:`emit` is a
two-instruction no-op: instrumented operators cost nothing and never
read a device value.

The tap is thread-local: the service's dispatch worker and the caller's
thread cannot observe each other's events.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Tuple

__all__ = ["emit", "collect", "active"]

_tls = threading.local()


def _stack() -> List["_Collector"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def active() -> bool:
    """True iff a :func:`collect` context is open on this thread."""
    return bool(getattr(_tls, "stack", None))


def emit(name: str, value: Any) -> None:
    """Report ``value`` (a scalar, possibly a device tensor) under ``name``
    to the innermost open collector; no-op when none is active."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    stack[-1].items.append((name, value))


class _Collector:
    """Accumulates ``(name, value)`` pairs emitted while its context is
    open; :meth:`drain` sums same-named values (tensor additions, so
    device values stay on their device)."""

    def __init__(self):
        self.items: List[Tuple[str, Any]] = []

    def drain(self) -> Dict[str, Any]:
        import torch
        out: Dict[str, Any] = {}
        for name, value in self.items:
            v = torch.as_tensor(value)
            out[name] = v if name not in out else out[name] + v
        self.items = []
        return out


@contextlib.contextmanager
def collect() -> Iterator[_Collector]:
    """Open an event collector for the current thread.  Nested contexts
    shadow outer ones (events go to the innermost only) — a collecting
    caller used as a building block inside another keeps its events to
    itself."""
    stack = _stack()
    c = _Collector()
    stack.append(c)
    try:
        yield c
    finally:
        stack.pop()
