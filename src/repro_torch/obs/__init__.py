"""Host-side observability of the port: span tracing (``obs.trace``) and the
metrics registry behind ``PropagationService.stats()['metrics']``
(``obs.metrics``).  Pure Python.  The device telemetry plane, timing
helpers and run metadata of the reference's ``repro.obs`` are ROADMAP
Queue 1 item 6."""
from .metrics import SNAPSHOT_KEYS, SNAPSHOT_SCHEMA_VERSION, MetricsRegistry, default_registry
from .trace import NULL_TRACER, SPAN_KEYS, SPAN_SCHEMA_VERSION, NullTracer, Span, Tracer

__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "SNAPSHOT_KEYS",
    "SNAPSHOT_SCHEMA_VERSION",
    "SPAN_KEYS",
    "SPAN_SCHEMA_VERSION",
    "Span",
    "Tracer",
    "default_registry",
]
