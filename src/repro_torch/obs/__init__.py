"""repro_torch.obs: observability that keeps the fixed points' host reads
as they are.

* ``obs.telemetry`` -- the device half: a fixed-capacity
  :class:`TelemetryPlane` recorded after every round of every fixed point
  (per-round progress ring, early-stop and infeasibility rounds) and read
  back only where the host already reads.  Telemetry on is bitwise equal to
  telemetry off.
* ``obs.trace`` -- the host half: a :class:`Tracer` of structured spans
  (service pump/admit/step/readback, per-ticket lifecycles) exported as
  schema-pinned JSON lines, with optional ``torch.profiler`` annotations.
* ``obs.metrics`` -- the aggregation half: a :class:`MetricsRegistry`
  behind ``PropagationService.stats()['metrics']``, and :func:`run_metadata`
  for attributable benchmark results.
* ``obs.timing`` -- fenced timing (CUDA synchronization, best of repeats,
  paired trials and their median ratio).
"""
from .metrics import (
    SNAPSHOT_KEYS,
    SNAPSHOT_SCHEMA_VERSION,
    MetricsRegistry,
    default_registry,
    run_metadata,
)
from .telemetry import (
    DEFAULT_CAPACITY,
    TelemetryPlane,
    TelemetrySnapshot,
    device_plane,
    host_snapshot,
    record_round,
    reset_rows,
)
from .timing import (
    fence,
    median_of,
    median_ratio,
    paired_trials,
    time_fenced,
    time_phases,
)
from .trace import (
    NULL_TRACER,
    SPAN_KEYS,
    SPAN_SCHEMA_VERSION,
    NullTracer,
    Span,
    Tracer,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "SNAPSHOT_KEYS",
    "SNAPSHOT_SCHEMA_VERSION",
    "SPAN_KEYS",
    "SPAN_SCHEMA_VERSION",
    "Span",
    "TelemetryPlane",
    "TelemetrySnapshot",
    "Tracer",
    "default_registry",
    "device_plane",
    "fence",
    "host_snapshot",
    "median_of",
    "median_ratio",
    "paired_trials",
    "record_round",
    "reset_rows",
    "run_metadata",
    "time_fenced",
    "time_phases",
]
