"""Dependency-free observability: metrics registry, span tracer, request
trace contexts, tail-sampled flight recorder, SLO monitor, JSONL event
log, and a stdlib HTTP exposition/debug server.

Counterpart of ``repro.obs`` with the same metric, label and event names.
Everything in this package is importable without torch so the hot paths
can instrument themselves unconditionally; the cost of a disabled registry
(`NULL_REGISTRY`) is a no-op method call.  See `docs/observability.md`
for the metric catalog and trace-context model.
"""

from repro_torch.obs.events import (
    EventLog,
    emit,
    get_event_log,
    read_events,
    set_event_log,
)
from repro_torch.obs.metrics import (
    NULL_REGISTRY,
    Buckets,
    Counter,
    Gauge,
    Histogram,
    LabelCardinalityError,
    MetricsRegistry,
    get_registry,
    merge_snapshots,
    parse_exposition,
    set_registry,
)
from repro_torch.obs.recorder import (
    FlightRecorder,
    get_recorder,
    new_batch_id,
    set_recorder,
)
from repro_torch.obs.server import MetricsServer, ReadyState
from repro_torch.obs.slo import SLOMonitor, SLOSpec
from repro_torch.obs.trace import Span, Trace, TraceContext, new_trace_id

__all__ = [
    "Buckets",
    "Counter",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LabelCardinalityError",
    "MetricsRegistry",
    "MetricsServer",
    "NULL_REGISTRY",
    "ReadyState",
    "SLOMonitor",
    "SLOSpec",
    "Span",
    "Trace",
    "TraceContext",
    "emit",
    "get_event_log",
    "get_recorder",
    "get_registry",
    "merge_snapshots",
    "new_batch_id",
    "new_trace_id",
    "parse_exposition",
    "read_events",
    "set_event_log",
    "set_recorder",
    "set_registry",
]
