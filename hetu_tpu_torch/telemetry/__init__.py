"""Unified telemetry for the PyTorch port: run-wide spans, a metrics
registry, ONE event pipeline, SLO burn rates and the flight recorder.

A copy of the JAX package's telemetry subsystem, reduced to what the
serving engine imports:

- :mod:`.events` — the single ``emit()`` every JSONL record flows
  through, ``span()`` context managers, and the event-shape contract.
- :mod:`.metrics` — thread-safe counters/gauges/histograms behind
  ``snapshot()``.
- :mod:`.slo` — declarative serving SLOs (TTFT / per-stream tok/s)
  with sliding-window burn rates behind the engine's ``health()``.
- :mod:`.flight` — the always-on bounded ring of recent records dumped
  to ``$HETU_FLIGHT_LOG`` on faults.

``trace``, ``top`` and ``health`` are not ported yet (ROADMAP A11).
``HETU_TELEMETRY=0`` turns spans and metric recording into no-ops.
"""

from . import flight, metrics, slo  # noqa: F401
from .events import (  # noqa: F401
    REQUIRED_FIELDS, STREAMS, TelemetrySink, counter, emit, enabled,
    gauge, get_sink, histogram, inc, make_record, observe, reset,
    set_gauge, snapshot, span, validate_record,
)
from .metrics import REGISTRY, percentile  # noqa: F401

__all__ = [
    "REQUIRED_FIELDS", "STREAMS", "REGISTRY", "TelemetrySink",
    "counter", "emit", "enabled", "flight", "gauge", "get_sink",
    "histogram", "inc", "make_record", "metrics", "observe",
    "percentile", "reset", "set_gauge", "slo", "snapshot", "span",
    "validate_record",
]
