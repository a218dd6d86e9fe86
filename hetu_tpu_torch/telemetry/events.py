"""The one event pipeline: every JSONL record in the repo flows here.

Before this subsystem four emitters — launcher ``_event``,
``serving/metrics.py``, ``analysis/report.py``, and ad-hoc bench
records — each opened their own file and happened to agree on the
``{"t": <epoch, 3 decimals>, "event": <kind>, **fields}`` shape.  Now
there is exactly one ``emit()`` (lint rule ``event-emit`` keeps it
that way, the same way ``env-registry`` keeps the env registry
authoritative), and the shape is a CONTRACT (:data:`REQUIRED_FIELDS`,
asserted by one shared schema test) instead of four conventions.

Streams and sinks: each record belongs to a *stream* (``failure`` /
``serve`` / ``validate`` / ``telemetry``).  A record is appended to its
stream's legacy env-var path (``HETU_FAILURE_LOG`` etc. — existing
tail/jq pipelines keep working) AND to ``$HETU_TELEMETRY_LOG``, the
merged run-wide file ``bin/hetu_trace.py`` tails and exports to a
Perfetto trace.  Writes are best-effort: an unwritable log must never
take down a run that computed fine.

Spans: ``with span("exec.phase_a", subgraph="train"):`` times a region,
feeds a histogram (``span.exec.phase_a``) in the metrics registry, and
— when a telemetry log is configured — emits a ``span`` record carrying
the START time plus ``ms``/``pid``/``tid``, which the trace exporter
turns into a Chrome ``"X"`` duration event.  With ``HETU_TELEMETRY=0``
``span()`` returns a shared no-op and the instrumented call sites skip
the registry: near-zero overhead is the contract (asserted as a <2%
smoke-tier bound).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from .. import envvars, locks
from . import flight
from .metrics import REGISTRY

# stream -> legacy per-stream JSONL env var (None = merged log only)
STREAMS = {
    "failure": "HETU_FAILURE_LOG",
    "serve": "HETU_SERVE_LOG",
    "validate": "HETU_VALIDATE_LOG",
    "telemetry": None,
}

# per-kind required fields on top of the base {"t", "event"} pair —
# THE event contract, shared by every stream and asserted by one
# schema test (tests/test_telemetry.py) instead of four conventions.
REQUIRED_FIELDS = {
    # launcher / supervisor (failure stream)
    "worker_exit": ("rank", "rc"),
    "worker_restart": ("rank",),
    "worker_restart_scheduled": ("rank",),
    "worker_failed": ("rank", "rc"),
    "ps_restart": ("index",),
    "ps_restart_failed": ("index",),
    "ps_server_exit": ("index", "rc"),
    "ps_server_dead": ("index", "rc"),
    "ps_resynced": ("index",),
    "ps_resync_failed": ("index",),
    "ps_wedged_kill": ("index",),
    # sharded PS client (failure stream)
    "ps_shard_failover": ("shard",),
    "ps_shard_resynced": ("shard",),
    "ps_replica_write_failed": ("shard",),
    "ps_replica_rebuild_failed": ("shard",),
    # serving engine (serve stream)
    "serve_submit": ("request", "queue_depth"),
    "serve_queue_reject": ("request", "queue_depth"),
    "serve_admit": ("request", "slot", "ttft_s"),
    "serve_prefill": ("n", "bucket", "prefill_ms"),
    "serve_step": ("live", "queue_depth", "decode_ms"),
    "serve_finish": ("request", "reason", "n_generated"),
    # embedding serving engine (serve stream; per-wave cache gather)
    "serve_gather": ("n", "rows", "gather_ms"),
    # static checks (validate stream)
    "graph_verified": ("subgraph", "phase"),
    "graph_verify_error": ("kind", "error"),
    "serving_verified": ("model",),
    # concurrency sanitizer (hetu_tpu_torch/locks.py; validate stream):
    # kind = order (lock-order inversion) / held_across (blocking work
    # under a lock) / long_hold (> HETU_LOCKDEP_HOLD_MS); any one in a
    # merged stream turns hetu_trace --check red
    "lockdep_violation": ("kind", "lock"),
    # request lifecycle (serve stream)
    "req_span": ("request", "phase", "ms"),
    "req_retire": ("request", "ttft_ms"),
    # SLO monitor (telemetry/slo.py)
    "slo_violation": ("slo", "value", "target"),
    "slo_health": ("state",),
    # serving fleet: supervised replicas (failure stream)
    "replica_start": ("replica",),
    "replica_exit": ("replica", "rc"),
    "replica_restart_scheduled": ("replica", "attempt"),
    "replica_restart": ("replica", "attempt"),
    "replica_failed": ("replica", "rc"),
    "replica_wedged_kill": ("replica",),
    "replica_drain": ("replica", "requeued"),
    # serving fleet: router request path (serve stream)
    "router_route": ("request", "replica"),
    "router_hop": ("request", "to_replica"),
    "router_shed": ("request", "slo_class"),
    "router_breaker": ("replica", "state"),
    "router_deadline": ("request",),
    "router_retry_exhausted": ("request",),
    # serving fleet: KV directory + prefill/decode handoff (an
    # out/in pair per moved span — hetu_trace --check enforces the
    # pairing; drop = a failed import that degraded to cold admission)
    "kv_handoff_out": ("request", "replica", "to_replica"),
    "kv_handoff_in": ("request", "replica", "from_replica"),
    "kv_handoff_drop": ("request", "replica"),
    "directory_killed": ("reason",),
    # live weight sync (serving/weight_sync.py): the rolling
    # quiesce->drain->swap->probe->readmit cycle per replica (serve
    # stream) plus rollout lifecycle; failures (stale push, mid-swap
    # death) ride the failure stream
    "weight_swap": ("version",),
    "swap_quiesce": ("replica", "version"),
    "swap_drained": ("replica", "version"),
    "swap_probe": ("replica", "version", "ok"),
    "swap_readmit": ("replica", "version"),
    "swap_rejected_stale": ("version", "committed"),
    "rollout_start": ("version", "replicas"),
    "rollout_advance": ("version", "done", "replicas"),
    "rollout_done": ("version", "swapped"),
    "rollout_failed": ("version", "reason"),
    "rollout_rollback": ("version", "replicas"),
    "ps_version_skew": ("before", "after"),
    # elastic fleet (serving/autoscaler.py + router add/retire):
    # scale actions and per-replica lifecycle transitions (failure
    # stream).  hetu_trace --check pairs every scale_up with a
    # replica_ready and every scale_down with a replica_retired whose
    # drained rids each retire exactly once on a peer.
    "scale_up": ("replica", "reason"),
    "scale_down": ("replica", "reason"),
    "replica_warming": ("replica",),
    "replica_ready": ("replica",),
    "replica_draining": ("replica",),
    "replica_retired": ("replica", "requeued"),
    # tiered KV (serving/kv_tiers.py): every kv_spill opens a
    # tier residency for one prefix; exactly one terminal kv_fetch
    # (re-admitted into a pool) or kv_tier_drop (ring overflow past a
    # dead PS, corruption, shutdown) closes it.  hetu_trace --check
    # tier-balance enforces the pairing.  kvtier_ps_killed (failure
    # stream) marks the one-shot PS-rung death that degrades the
    # ladder to drop-on-evict.
    "kv_spill": ("prefix", "tier", "length"),
    "kv_fetch": ("prefix", "tier", "length"),
    "kv_tier_drop": ("prefix", "tier"),
    "kvtier_ps_killed": ("reason",),
    # flight recorder dump header (telemetry/flight.py)
    "flight_dump": ("reason",),
    # telemetry core + bench
    "span": ("name", "ms"),
    "gauge": ("name", "value"),
    "bench_row": ("config",),
    "bench_probe_health": ("ok",),
}


def validate_record(rec):
    """Contract check for one record; returns a list of problems
    (empty = conforming).  Unknown kinds only need the base shape —
    the registry constrains kinds we HAVE agreed on, it does not ban
    new ones."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not a dict"]
    if not isinstance(rec.get("t"), (int, float)):
        problems.append("missing/non-numeric 't'")
    kind = rec.get("event")
    if not isinstance(kind, str):
        problems.append("missing/non-string 'event'")
        return problems
    for field in REQUIRED_FIELDS.get(kind, ()):
        if field not in rec:
            problems.append(f"{kind!r} record missing field {field!r}")
    return problems


def enabled() -> bool:
    """Master switch for spans + metric instrumentation
    (``HETU_TELEMETRY``, default on).  Explicit event streams
    (failure/serve/validate) flow regardless — they predate the switch
    and are low-frequency by construction."""
    return envvars.get_bool("HETU_TELEMETRY")


def make_record(event, t=None, **fields):
    """One contract-shaped record: {"t": ..., "event": event, **fields}."""
    return {"t": round(time.time() if t is None else t, 3),
            "event": event, **fields}


class TelemetrySink:
    """Process-wide sink: bounded in-memory ring + JSONL fan-out."""

    def __init__(self):
        self._lock = locks.TracedLock("telemetry.sink")
        self._buffer = collections.deque(
            maxlen=max(1, envvars.get_int("HETU_TELEMETRY_BUFFER")))
        self.emitted = 0
        self.dropped_writes = 0

    # ------------------------------------------------------------- #

    def _targets(self, stream, path):
        """The files one record lands in: explicit override or the
        stream's legacy env path, plus the merged telemetry log."""
        out = []
        if path:
            out.append(os.path.expanduser(str(path)))
        else:
            env = STREAMS.get(stream)
            if env:
                p = envvars.get_path(env)
                if p:
                    out.append(p)
        merged = envvars.get_path("HETU_TELEMETRY_LOG")
        if merged and merged not in out:
            out.append(merged)
        return out

    def _write(self, records, targets):
        for target in targets:
            try:
                with open(target, "a") as f:
                    for rec in records:
                        f.write(json.dumps(rec, default=str) + "\n")
            except OSError:
                self.dropped_writes += 1

    def emit(self, event, stream="telemetry", path=None, t=None,
             **fields):
        """Append one record to the ring and its sinks; returns it."""
        rec = make_record(event, t=t, **fields)
        with self._lock:
            self._buffer.append(rec)
            self.emitted += 1
        flight.RECORDER.record(rec)   # the always-on black box
        self._write([rec], self._targets(stream, path))
        return rec

    def emit_prebuilt(self, records, stream="telemetry", path=None):
        """Route already-shaped records (``make_record`` output) —
        the analysis layer batches its reports."""
        records = list(records)
        if not records:
            return records
        with self._lock:
            self._buffer.extend(records)
            self.emitted += len(records)
        flight.RECORDER.extend(records)
        self._write(records, self._targets(stream, path))
        return records

    def recent(self, n=None, kind=None):
        with self._lock:
            events = list(self._buffer)
        if kind is not None:
            events = [e for e in events if e.get("event") == kind]
        return events[-n:] if n else events

    def reset(self):
        with self._lock:
            self._buffer = collections.deque(
                maxlen=max(1, envvars.get_int("HETU_TELEMETRY_BUFFER")))
            self.emitted = 0
            self.dropped_writes = 0


_SINK = TelemetrySink()


def get_sink() -> TelemetrySink:
    return _SINK


def emit(event, _stream="telemetry", _path=None, _t=None, **fields):
    """Module-level emit — THE one event pipeline."""
    return _SINK.emit(event, stream=_stream, path=_path, t=_t, **fields)


# ------------------------------------------------------------------- #
# spans
# ------------------------------------------------------------------- #

class _Span:
    __slots__ = ("name", "fields", "_t0", "_epoch")

    def __init__(self, name, fields):
        self.name = name
        self.fields = fields

    def __enter__(self):
        self._epoch = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        ms = (time.perf_counter() - self._t0) * 1e3
        REGISTRY.histogram("span." + self.name).observe(ms)
        # JSONL only when a merged log is configured: per-step span
        # records are trace-export payload, not an always-on cost
        if envvars.is_set("HETU_TELEMETRY_LOG"):
            _SINK.emit("span", stream="telemetry", t=self._epoch,
                       name=self.name, ms=round(ms, 3),
                       pid=os.getpid(),
                       tid=threading.current_thread().name,
                       **self.fields)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


def span(name, **fields):
    """Timed region context manager; no-op when telemetry is off."""
    if not enabled():
        return _NOOP_SPAN
    return _Span(name, fields)


# ------------------------------------------------------------------- #
# guarded metric helpers (the instrumentation call-site surface)
# ------------------------------------------------------------------- #

def inc(name, n=1):
    if enabled():
        REGISTRY.counter(name).inc(n)


def observe(name, v):
    if enabled():
        REGISTRY.histogram(name).observe(v)


def set_gauge(name, v):
    if enabled():
        REGISTRY.gauge(name).set(v)
        # gauges are the only metric kind with a time dimension worth
        # exporting (occupancy, queue depth, blocks_free over the run),
        # so a configured merged log also gets a JSONL sample per set —
        # the trace exporter renders them as Chrome "C" counter tracks
        if envvars.is_set("HETU_TELEMETRY_LOG"):
            _SINK.emit("gauge", stream="telemetry", name=name, value=v)


def counter(name):
    return REGISTRY.counter(name)


def gauge(name):
    return REGISTRY.gauge(name)


def histogram(name):
    return REGISTRY.histogram(name)


def snapshot():
    """JSON-able view tests and tools assert against: every metric plus
    the event-ring status."""
    out = REGISTRY.snapshot()
    out["enabled"] = enabled()
    out["events_emitted"] = _SINK.emitted
    out["events_buffered"] = len(_SINK.recent())
    out["dropped_writes"] = _SINK.dropped_writes
    return out


def reset():
    """Clear metrics + the event ring + the flight ring (test
    isolation)."""
    REGISTRY.reset()
    _SINK.reset()
    flight.RECORDER.reset()
