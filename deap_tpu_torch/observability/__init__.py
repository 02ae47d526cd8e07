"""Observability of the port: the event tap, metric sinks, fleet request
tracing and the serving layer's measured program profiles.

* :mod:`~deap_tpu_torch.observability.events` — the tap deep library
  code (quarantine, the serving layer's program builds) reports through;
  inert when no collector is open;
* :mod:`~deap_tpu_torch.observability.sinks` — where metric records and
  streaming text go (:class:`InMemorySink`, :class:`JsonlSink`,
  :class:`LogbookSink`, :class:`StdoutSink`, optional
  :class:`TensorBoardSink`), rank-0-only under ``torch.distributed``;
* :mod:`~deap_tpu_torch.observability.fleettrace` — span trees of one
  request across client, wire, server, dispatcher and device;
* :mod:`~deap_tpu_torch.observability.profiling` — per-program measured
  execute walls of the serving layer (min-of-k), served at
  ``/v1/profile``.

Not ported yet (queue 1 item 12 of ROADMAP.md): the loops' on-device
``MetricBuffer`` and ``Telemetry`` (the loops' ``telemetry=``), the
tracing spans and phase timers, the XLA cost half of the profiler and
the CLI.
"""

from . import events, fleettrace, profiling, sinks  # noqa: F401
from .profiling import (ProgramProfiler, ProgramProfile,  # noqa: F401
                        describe_program_key)
from .fleettrace import (FleetTracer, TraceContext, SpanRecord,  # noqa: F401
                         new_trace_id, new_span_id)
from .sinks import (MetricRecord, Sink, InMemorySink, JsonlSink,  # noqa: F401
                    LogbookSink, StdoutSink, TensorBoardSink,
                    emit_record, emit_text, format_record)

__all__ = [
    "FleetTracer", "TraceContext", "SpanRecord", "new_trace_id",
    "new_span_id",
    "MetricRecord", "Sink", "InMemorySink", "JsonlSink", "LogbookSink",
    "StdoutSink", "TensorBoardSink", "emit_record", "emit_text",
    "format_record",
    "ProgramProfiler", "ProgramProfile", "describe_program_key",
]
