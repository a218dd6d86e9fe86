"""Declarative serving SLOs with sliding-window burn-rate tracking.

An :class:`SLO` states one objective over finished requests:

- ``latency``: TTFT must be <= ``target`` milliseconds;
- ``throughput``: the request's per-stream decode rate must be >=
  ``target`` tokens/second (TPOT inverted — what a streaming client
  experiences once tokens start).

plus an ``objective`` — the fraction of requests that must meet the
target (default 0.99, i.e. a 1% error budget).

:class:`SLOMonitor` holds one sliding window of pass/fail samples per
SLO (last ``window`` finished requests) and reports the classic SRE
*burn rate*: the window's failing fraction divided by the error budget.
Burn 1.0 means the budget is being consumed exactly as provisioned;
above it the budget is burning faster than it refills.  The monitor's
``health()`` collapses the worst burn rate across SLOs into the
three-state admission signal the serving engine exposes (and the
multi-replica router will consume — ROADMAP item 1):

- ``ok``        worst burn < 1 (inside budget)
- ``degraded``  1 <= worst burn < ``breach_burn`` (default 2)
- ``breach``    worst burn >= ``breach_burn``

Every failing sample emits an ``slo_violation`` event and every state
change an ``slo_health`` event through the one event pipeline, so
violations land in the serve stream next to the request records that
caused them (``bin/hetu_top.py`` tails both).

Env construction (``SLOMonitor.from_env``): ``HETU_SLO_TTFT_MS`` /
``HETU_SLO_TPS`` declare the two SLO kinds, ``HETU_SLO_OBJECTIVE`` the
shared objective, ``HETU_SLO_WINDOW`` the window size.  With neither
target set the monitor is empty and ``health()`` is always ``ok``.
"""

from __future__ import annotations

import collections

from .. import envvars
from . import events

OK, DEGRADED, BREACH = "ok", "degraded", "breach"
_LEVEL = {OK: 0, DEGRADED: 1, BREACH: 2}


class SLO:
    """One declarative objective over finished requests."""

    __slots__ = ("name", "kind", "target", "objective")

    def __init__(self, name, kind, target, objective=0.99):
        if kind not in ("latency", "throughput"):
            raise ValueError(
                f"SLO kind must be 'latency' or 'throughput', got {kind!r}")
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.objective = float(objective)

    def evaluate(self, ttft_ms=None, tok_s=None):
        """(value, ok) for one finished request, or None when the sample
        lacks this SLO's measurement (e.g. a one-token request has no
        decode rate)."""
        if self.kind == "latency":
            if ttft_ms is None:
                return None
            return float(ttft_ms), float(ttft_ms) <= self.target
        if tok_s is None:
            return None
        return float(tok_s), float(tok_s) >= self.target

    def describe(self):
        op = "<=" if self.kind == "latency" else ">="
        unit = "ms" if self.kind == "latency" else "tok/s"
        return (f"{self.name}: {self.kind} {op} {self.target:g}{unit} "
                f"for {self.objective:.2%} of requests")


class SLOMonitor:
    """Sliding-window burn-rate tracker over a set of SLOs.

    ``emit_fn(kind, **fields)`` routes the ``slo_violation`` /
    ``slo_health`` events; the serving engine points it at
    ``ServingMetrics.event`` so they land in the serve stream (and its
    legacy log) alongside the request records.  Default: the merged
    telemetry stream."""

    def __init__(self, slos=(), window=None, breach_burn=2.0,
                 emit_fn=None):
        self.slos = list(slos)
        self.window = int(window or envvars.get_int("HETU_SLO_WINDOW"))
        self.breach_burn = float(breach_burn)
        self.emit_fn = emit_fn or (
            lambda kind, **f: events.emit(kind, _stream="serve", **f))
        self._windows = {s.name: collections.deque(maxlen=self.window)
                        for s in self.slos}
        self._state = OK
        self.violations = 0
        self.observed = 0

    @classmethod
    def from_env(cls, emit_fn=None):
        """The env-declared monitor (``HETU_SLO_*``); empty (always ok)
        when no target is set."""
        objective = envvars.get_float("HETU_SLO_OBJECTIVE")
        slos = []
        ttft = envvars.get_float("HETU_SLO_TTFT_MS")
        if ttft is not None:
            slos.append(SLO("ttft", "latency", ttft, objective))
        tps = envvars.get_float("HETU_SLO_TPS")
        if tps is not None:
            slos.append(SLO("stream_tok_s", "throughput", tps, objective))
        return cls(slos, emit_fn=emit_fn)

    # ------------------------------------------------------------- #

    def observe(self, request_id=None, ttft_ms=None, tok_s=None):
        """Record one finished request against every SLO; emits an
        ``slo_violation`` per failing objective and re-derives health.
        Returns the (possibly updated) health state."""
        self.observed += 1
        for slo in self.slos:
            out = slo.evaluate(ttft_ms=ttft_ms, tok_s=tok_s)
            if out is None:
                continue
            value, ok = out
            self._windows[slo.name].append(bool(ok))
            if not ok:
                self.violations += 1
                self.emit_fn("slo_violation", slo=slo.name,
                             slo_kind=slo.kind, value=round(value, 3),
                             target=slo.target, request=request_id)
        return self._update_state()

    def burn_rate(self, name):
        """Failing fraction of the window divided by the error budget
        (0.0 on an empty window — no evidence is not a breach)."""
        w = self._windows[name]
        if not w:
            return 0.0
        slo = next(s for s in self.slos if s.name == name)
        bad = 1.0 - sum(w) / len(w)
        return bad / max(1.0 - slo.objective, 1e-9)

    def health(self):
        return self._state

    def _update_state(self):
        worst = max((self.burn_rate(s.name) for s in self.slos),
                    default=0.0)
        if worst < 1.0:
            state = OK
        elif worst < self.breach_burn:
            state = DEGRADED
        else:
            state = BREACH
        if state != self._state:
            self.emit_fn("slo_health", state=state, prev=self._state,
                         burn_rate=round(worst, 3))
        events.set_gauge("serve.slo_burn", round(worst, 4))
        events.set_gauge("serve.health", _LEVEL[state])
        self._state = state
        return state

    def snapshot(self):
        """JSON-able view: per-SLO burn rate + window fill, the overall
        state, and counts (``hetu_top`` and the bench artifact read
        this)."""
        return {
            "health": self._state,
            "observed": self.observed,
            "violations": self.violations,
            "window": self.window,
            "slos": {
                s.name: {
                    "kind": s.kind,
                    "target": s.target,
                    "objective": s.objective,
                    "burn_rate": round(self.burn_rate(s.name), 4),
                    "samples": len(self._windows[s.name]),
                    "describe": s.describe(),
                } for s in self.slos
            },
        }
