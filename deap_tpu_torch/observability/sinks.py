"""Pluggable metric/text sinks with multihost write semantics.

Everything the framework says at runtime — periodic telemetry flushes,
``stream_every`` records, ``verbose`` logbook output — flows through this
module instead of bare ``print`` (``tools/check_no_bare_print.py`` pins
that, as a tier-1 test).  Centralizing the writes buys two things:

* **capturability** — tests and services swap in :class:`InMemorySink` /
  :class:`JsonlSink` / :class:`LogbookSink` instead of scraping stdout;
* **multihost discipline** — on a multi-process cluster every process
  executes the same SPMD program and would print the same (replicated)
  record; sinks write on process 0 only unless they opt into
  ``all_processes`` (e.g. :class:`InMemorySink`, which is per-process
  test capture by design).

A :class:`MetricRecord` is plain host data (python ints/floats) — by the
time a record reaches a sink, every device value has been pulled and
converted, so sinks never block on device work themselves.
"""

from __future__ import annotations

import dataclasses
import io
import json
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["MetricRecord", "Sink", "InMemorySink", "JsonlSink",
           "LogbookSink", "StdoutSink", "TensorBoardSink",
           "emit_record", "emit_text", "format_record"]


@dataclasses.dataclass(frozen=True)
class MetricRecord:
    """One telemetry flush: cumulative counters + last-value gauges as of
    generation ``gen`` (host scalars)."""

    gen: int
    counters: Dict[str, int]
    gauges: Dict[str, float]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"gen": self.gen, "counters": self.counters,
                           "gauges": self.gauges, **(
                               {"meta": self.meta} if self.meta else {})},
                          sort_keys=True)


def format_record(record: MetricRecord) -> str:
    """One aligned ``key=value`` line (the streaming analogue of the
    reference's ``print(logbook.stream)``)."""
    parts = [f"gen={record.gen}"]
    for k in sorted(record.counters):
        parts.append(f"{k}={record.counters[k]}")
    for k in sorted(record.gauges):
        parts.append(f"{k}={record.gauges[k]:g}")
    return "\t".join(parts)


def _is_process_zero() -> bool:
    # the rank of an initialized torch.distributed group; a process
    # outside any group is process zero
    import torch.distributed as dist
    try:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except RuntimeError:
        pass
    return True


class Sink:
    """Base sink.  ``emit`` receives :class:`MetricRecord`; ``write_text``
    receives preformatted lines (streaming records, verbose logbooks).
    ``all_processes=False`` (the default) restricts writes to process 0 —
    the dispatch helpers below enforce it, so subclasses just write."""

    all_processes: bool = False

    def emit(self, record: MetricRecord) -> None:
        raise NotImplementedError

    def write_text(self, text: str) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class InMemorySink(Sink):
    """Per-process capture (tests, notebooks): records and text lines in
    lists."""

    all_processes = True

    def __init__(self):
        self.records: List[MetricRecord] = []
        self.texts: List[str] = []

    def emit(self, record: MetricRecord) -> None:
        self.records.append(record)

    def write_text(self, text: str) -> None:
        self.texts.append(text)


class StdoutSink(Sink):
    """Write aligned ``key=value`` lines to stdout (process 0 only).  The
    ONE sanctioned home of ``print`` for runtime output."""

    def __init__(self, stream: Optional[io.TextIOBase] = None):
        self._stream = stream

    def emit(self, record: MetricRecord) -> None:
        self.write_text(format_record(record))

    def write_text(self, text: str) -> None:
        print(text, file=self._stream if self._stream is not None
              else sys.stdout, flush=True)


class JsonlSink(Sink):
    """Append one JSON object per record/line to ``path`` (process 0
    only); flushed per write, so a preempted run's file is complete up to
    its last flush."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None

    def _handle(self):
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        return self._fh

    def emit(self, record: MetricRecord) -> None:
        fh = self._handle()
        fh.write(record.to_json() + "\n")
        fh.flush()

    def write_text(self, text: str) -> None:
        fh = self._handle()
        fh.write(json.dumps({"text": text}) + "\n")
        fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class LogbookSink(Sink):
    """Record flushes into a :class:`deap_tpu_torch.utils.support.Logbook`
    (counters and gauges as nested chapters) — telemetry lands in the same
    structure the loops already return, selectable/printable with the
    familiar API."""

    all_processes = True

    def __init__(self, logbook=None):
        if logbook is None:
            from ..utils.support import Logbook
            logbook = Logbook()
        self.logbook = logbook

    def emit(self, record: MetricRecord) -> None:
        self.logbook.record(gen=record.gen,
                            counters=dict(record.counters),
                            gauges=dict(record.gauges))


class TensorBoardSink(Sink):
    """Scalar summaries to TensorBoard (optional dependency: install the
    ``obs`` extra — ``pip install deap-tpu[obs]``).  Counters and gauges
    become ``counters/<name>`` / ``gauges/<name>`` scalars at step
    ``gen``."""

    def __init__(self, logdir):
        try:
            from tensorboardX import SummaryWriter          # type: ignore
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "TensorBoardSink needs a SummaryWriter implementation; "
                    "install the obs extra: pip install deap-tpu[obs]"
                ) from e
        self._writer = SummaryWriter(str(logdir))

    def emit(self, record: MetricRecord) -> None:
        for k, v in record.counters.items():
            self._writer.add_scalar(f"counters/{k}", v, record.gen)
        for k, v in record.gauges.items():
            self._writer.add_scalar(f"gauges/{k}", v, record.gen)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


# ---------------------------------------------------------------------------
# dispatch helpers (the process-0 gate lives HERE, not in each sink)
# ---------------------------------------------------------------------------

_DEFAULT_TEXT_SINK = StdoutSink()


def _gated(sinks: Iterable[Sink]):
    """Yield the sinks a write may reach: the ONE home of the multihost
    process-0-only policy (``all_processes`` sinks always pass; the
    process index is queried lazily, at most once per dispatch)."""
    p0 = None
    for sink in sinks:
        if not sink.all_processes:
            if p0 is None:
                p0 = _is_process_zero()
            if not p0:
                continue
        yield sink


def emit_record(sinks: Iterable[Sink], record: MetricRecord) -> None:
    """Fan a record out to ``sinks``, honoring process-0-only semantics."""
    for sink in _gated(sinks):
        sink.emit(record)


def emit_text(text: str, sinks: Optional[Iterable[Sink]] = None) -> None:
    """Write a preformatted line through ``sinks`` (default: stdout,
    process 0 only) — the sanctioned replacement for bare ``print`` in
    library code."""
    for sink in _gated(sinks if sinks is not None
                       else (_DEFAULT_TEXT_SINK,)):
        sink.write_text(text)
