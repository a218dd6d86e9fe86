"""Unified telemetry for the PyTorch port: run-wide spans, a metrics
registry, ONE event pipeline, SLO burn rates and the flight recorder.

A copy of the JAX package's telemetry subsystem:

- :mod:`.events` — the single ``emit()`` every JSONL record flows
  through, ``span()`` context managers, and the event-shape contract.
- :mod:`.metrics` — thread-safe counters/gauges/histograms behind
  ``snapshot()``.
- :mod:`.slo` — declarative serving SLOs (TTFT / per-stream tok/s)
  with sliding-window burn rates behind the engine's ``health()``.
- :mod:`.flight` — the always-on bounded ring of recent records dumped
  to ``$HETU_FLIGHT_LOG`` on faults.
- :mod:`.health` — measurement gates: sibling consistency, the physics
  ceiling, live-vs-banked provenance stamps.
- :mod:`.trace` — merge/tail the streams, export Perfetto traces, and
  ``--check`` the event contract and the fleet's balance rules
  (``python -m hetu_tpu_torch.telemetry.trace``).
- :mod:`.top` — the terminal dashboard, ``--fleet`` included
  (``python -m hetu_tpu_torch.telemetry.top``).

``trace`` and ``top`` are imported by name, not here, so that ``python
-m`` runs them without a second copy in ``sys.modules``.
``HETU_TELEMETRY=0`` turns spans and metric recording into no-ops.
"""

from . import flight, health, metrics, slo  # noqa: F401
from .events import (  # noqa: F401
    REQUIRED_FIELDS, STREAMS, TelemetrySink, counter, emit, enabled,
    gauge, get_sink, histogram, inc, make_record, observe, reset,
    set_gauge, snapshot, span, validate_record,
)
from .metrics import REGISTRY, percentile  # noqa: F401

__all__ = [
    "REQUIRED_FIELDS", "STREAMS", "REGISTRY", "TelemetrySink",
    "counter", "emit", "enabled", "flight", "gauge", "get_sink",
    "health", "histogram", "inc", "make_record", "metrics", "observe",
    "percentile", "reset", "set_gauge", "slo", "snapshot", "span",
    "validate_record",
]
