"""Measured device-execute profiles of the serving layer's programs.

The fleet trace's ``device_execute`` span is one wall-clock blob per
request; :class:`ProgramProfiler` keeps, per slot program, the measured
execute walls behind it: calls, total, all-time minimum, and the min-of-k
window over the recent dispatches (min-of-k is the repo's standing noise
defense: the minimum is the run least disturbed by the timeshared host),
observed at the exact ``device_execute`` bounds the span records.

This is the measured half of the JAX package's profiler.  Its other half
reads XLA's ``cost_analysis()`` / ``memory_analysis()`` and the optimized
HLO of each compiled program (flops, bytes accessed, peak bytes, the
collective counts and the roofline split of the wall built from them).
The port compiles no XLA program, so a profile row here has none of
those fields — they are absent, never zero — and ``aggregates()``
reports the program count only.  What takes their place (CUDA events,
``torch.profiler``) comes with the tooling (queue 1 item 12 of
ROADMAP.md).

Everything here is host-side bookkeeping on the serving control plane: a
disabled profiler (``enabled=False``) reduces every entry point to one
attribute check, and the trajectories are bitwise the same either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Dict, Optional

from .. import sanitize

__all__ = ["ProgramProfiler", "ProgramProfile", "describe_program_key"]


def describe_program_key(kind: str, program_key: tuple) -> str:
    """Stable, readable name for one serve program key.

    The service's keys are tuples mixing ``id()`` pins, bucket records
    and genome signatures — process-local and unreadable (the names are
    the JAX package's, so one dashboard reads either).  This renders
    the SHAPE identity (kind, bucket rows/nobj, sharded placement) in
    clear text and folds the full key into a short digest suffix so two
    same-shaped programs of different toolboxes stay distinct::

        step[rows=64,nobj=1]#3f9a2c
        step.sharded[rows=128,nobj=2]#b01d77
        evaluate[rows=64,nobj=1]#8c44e1
    """
    rows = nobj = None
    sharded = bool(program_key) and program_key[0] == "sharded"
    for part in program_key:
        r = getattr(part, "rows", None)
        if r is not None:
            rows, nobj = int(r), int(getattr(part, "nobj", 0))
            break
    if rows is None and kind == "evaluate" and len(program_key) >= 4:
        # evaluate keys carry (id, sig, rows, nobj) as plain ints
        rows, nobj = int(program_key[2]), int(program_key[3])
    shape = (f"[rows={rows},nobj={nobj}]" if rows is not None else "[]")
    digest = hashlib.blake2b(
        repr((kind, program_key)).encode("utf-8"),
        digest_size=3).hexdigest()
    return f"{kind}{'.sharded' if sharded else ''}{shape}#{digest}"


@dataclasses.dataclass
class ProgramProfile:
    """One slot program's profile: its build time and the measured
    execute-wall statistics (min-of-k over the recent window)."""

    key: str
    kind: str
    compile_s: Optional[float] = None
    calls: int = 0
    device_total_s: float = 0.0
    device_min_s: Optional[float] = None      # all-time minimum
    window: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=64))

    def observe(self, seconds: float) -> None:
        seconds = float(seconds)
        self.calls += 1
        self.device_total_s += seconds
        if self.device_min_s is None or seconds < self.device_min_s:
            self.device_min_s = seconds
        self.window.append(seconds)

    def window_stats(self) -> Dict[str, float]:
        if not self.window:
            return {}
        w = sorted(self.window)
        return {"k": len(w),
                "min_s": w[0],
                "p50_s": w[len(w) // 2],
                "max_s": w[-1]}

    def as_dict(self) -> Dict[str, Any]:
        win = self.window_stats()
        out: Dict[str, Any] = {
            "kind": self.kind,
            "calls": self.calls,
            "device_total_s": round(self.device_total_s, 6),
        }
        if self.compile_s is not None:
            out["compile_s"] = round(self.compile_s, 6)
        if self.device_min_s is not None:
            out["device_min_s"] = round(self.device_min_s, 6)
        if win:
            out["window"] = {k: (v if k == "k" else round(v, 6))
                             for k, v in win.items()}
        return out


class ProgramProfiler:
    """Thread-safe per-program profile store for one serving process.

    The service calls :meth:`observe_compile` once per program build
    (beside its ``compiles*`` counters, so profile records and build
    counters always join on the same event) and :meth:`observe_execute`
    at the same bounds its ``device_execute`` trace span uses.  Scrapers
    read :meth:`profiles` (``/v1/profile``, the metrics snapshot's
    ``meta["programs"]`` table, the Prometheus program series).

    ``enabled`` is a live toggle like the tracer's: disabled, both
    observe paths are one attribute check and the store stays empty.
    """

    #: lock-guarded shared state: the profile
    #: table and the key-description memo are written by the dispatch
    #: worker (observes) and read by scraper/handler threads
    #: (profiles/aggregates)
    _GUARDED_BY = {"_lock": ("_profiles", "_descs")}

    def __init__(self, *, enabled: bool = True, window: int = 64,
                 clock=time.monotonic):
        self.enabled = bool(enabled)
        self.clock = clock
        self.window = int(window)
        self._lock = sanitize.lock()
        self._profiles: Dict[str, ProgramProfile] = {}
        # program keys repeat for every dispatch of a warm program: the
        # repr+digest rendering is memoized so the steady-state observe
        # path is one dict hit (bounded: one entry per compiled program)
        self._descs: Dict[tuple, str] = {}

    # -- writers (dispatch worker) -------------------------------------------

    def _describe_locked(self, kind: str, program_key: tuple) -> str:
        memo_key = (kind, program_key)
        desc = self._descs.get(memo_key)
        if desc is None:
            desc = self._descs[memo_key] = describe_program_key(
                kind, program_key)
        return desc

    def _profile_locked(self, desc: str, kind: str) -> ProgramProfile:
        p = self._profiles.get(desc)
        if p is None:
            p = self._profiles[desc] = ProgramProfile(
                key=desc, kind=kind,
                window=deque(maxlen=self.window))
        return p

    def observe_compile(self, kind: str, program_key: tuple,
                        compile_s: float) -> Optional[str]:
        """Record one program build (beside the ``compiles*`` counters,
        the same event) and its build seconds."""
        if not self.enabled:
            return None
        with self._lock:
            desc = self._describe_locked(kind, program_key)
            p = self._profile_locked(desc, kind)
            p.compile_s = float(compile_s)
        return desc

    def observe_execute(self, kind: str, program_key: tuple,
                        seconds: float) -> Optional[Dict[str, Any]]:
        """Record one measured device-execute wall; returns the compact
        attr dict the ``device_execute`` trace span attaches (the program
        key), ``None`` when disabled."""
        if not self.enabled:
            return None
        with self._lock:
            desc = self._describe_locked(kind, program_key)
            p = self._profile_locked(desc, kind)
            p.observe(seconds)
        return {"program": desc}

    # -- readers (scraper threads) -------------------------------------------

    def profiles(self) -> Dict[str, Dict[str, Any]]:
        """``{program key: profile dict}`` snapshot."""
        with self._lock:
            items = [(k, dataclasses.replace(p, window=deque(p.window)))
                     for k, p in self._profiles.items()]
        return {k: p.as_dict() for k, p in sorted(items)}

    def aggregates(self) -> Dict[str, float]:
        """Fleet-gauge rollup: the profiled program count (the JAX
        package's flop/byte/peak sums need XLA's analyses: absent)."""
        with self._lock:
            return {"programs": float(len(self._profiles))}

    def clear(self) -> None:
        with self._lock:
            self._profiles.clear()
            self._descs.clear()
