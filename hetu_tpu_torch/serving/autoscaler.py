"""SLO-burn-driven fleet autoscaler: grow, shrink, and rebalance a
ServingRouter fleet live, between ``HETU_FLEET_MIN`` and
``HETU_FLEET_MAX`` replicas.

The control signal is deliberately small: the worst SLO burn rate
across the fleet's monitors (telemetry/slo.py — burn >= 1 means an
error budget is being spent faster than it refills) plus the router's
aggregate queue pressure.  Galvatron-style cost-aware placement
(PAPERS.md) stays with the planner roadmap item; here cost is simply
REPLICA-SECONDS, the thing a static fleet burns all day to cover its
peak minute.

Control loop (one :meth:`tick` per ``router.step()``, exactly like the
weight-sync coordinator — no second thread, no lock):

- **scale up** after ``HETU_AUTOSCALE_UP_TICKS`` consecutive hot ticks
  (burn >= ``HETU_AUTOSCALE_UP_BURN`` or pressure >=
  ``HETU_AUTOSCALE_UP_PRESSURE``): ``router.add_replica()`` spawns a
  fresh supervised replica that admits on the COMMITTED weight version,
  prefix-warms from its peers, and probe-decodes before taking traffic.
- **scale down** after ``HETU_AUTOSCALE_DOWN_TICKS`` consecutive idle
  ticks (burn < 1 and pressure <= ``HETU_AUTOSCALE_DOWN_PRESSURE`` and
  nothing router-held): ``router.retire_replica()`` drains the
  least-loaded replica onto its peers with zero request loss.  Never
  fires mid-rollout (the version-committed quorum must hold) and never
  targets a quiesced replica.
- **hysteresis**: both streaks reset on any action and a
  ``HETU_AUTOSCALE_COOLDOWN``-tick refractory window follows, so a
  bursty signal cannot flap the fleet.

Tick-counted (not wall-clock) hysteresis keeps chaos runs and the
virtual-time traffic replay (serving/traffic.py) seed-deterministic.

Every action emits a ``scale_up``/``scale_down`` failure-stream event
(paired with ``replica_ready``/``replica_retired`` by the
``hetu_trace --check`` scale-balance rule), appends to an in-memory
scale ``timeline``, and dumps the flight ring — the scale history IS
the incident record when elasticity goes wrong.  ``enabled=False``
makes every tick a no-op: the fleet behaves byte-identically to the
static router (the degradation contract, regression-tested).
"""

from __future__ import annotations

import time

from .. import envvars, telemetry
from ..telemetry import flight
from .replica import RETIRED, UP

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Rides ``router.step()`` and resizes the fleet (see module
    docstring for the control contract).  Constructor knobs default to
    the ``HETU_FLEET_*`` / ``HETU_AUTOSCALE_*`` registry entries;
    attaching sets ``router.autoscaler`` so the router ticks it once
    per step, after supervision and placement."""

    def __init__(self, router, *, fleet_min=None, fleet_max=None,
                 up_burn=None, up_pressure=None, up_ticks=None,
                 down_pressure=None, down_ticks=None, cooldown=None,
                 warm_prefixes=None, enabled=True):
        self.router = router
        self.fleet_min = int(fleet_min if fleet_min is not None
                             else envvars.get_int("HETU_FLEET_MIN"))
        self.fleet_max = int(fleet_max if fleet_max is not None
                             else envvars.get_int("HETU_FLEET_MAX"))
        if not 1 <= self.fleet_min <= self.fleet_max:
            raise ValueError(
                f"need 1 <= fleet_min <= fleet_max, got "
                f"{self.fleet_min}..{self.fleet_max}")
        self.up_burn = float(
            up_burn if up_burn is not None
            else envvars.get_float("HETU_AUTOSCALE_UP_BURN"))
        self.up_pressure = float(
            up_pressure if up_pressure is not None
            else envvars.get_float("HETU_AUTOSCALE_UP_PRESSURE"))
        self.up_ticks = int(
            up_ticks if up_ticks is not None
            else envvars.get_int("HETU_AUTOSCALE_UP_TICKS"))
        self.down_pressure = float(
            down_pressure if down_pressure is not None
            else envvars.get_float("HETU_AUTOSCALE_DOWN_PRESSURE"))
        self.down_ticks = int(
            down_ticks if down_ticks is not None
            else envvars.get_int("HETU_AUTOSCALE_DOWN_TICKS"))
        self.cooldown = int(
            cooldown if cooldown is not None
            else envvars.get_int("HETU_AUTOSCALE_COOLDOWN"))
        self.warm_prefixes = int(
            warm_prefixes if warm_prefixes is not None
            else envvars.get_int("HETU_AUTOSCALE_WARM_PREFIXES"))
        self.enabled = bool(enabled)
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.deferred_rollout = 0   # scale-downs skipped mid-rollout
        self.replica_seconds = 0.0  # wall-clock cost surface
        self.replica_ticks = 0      # virtual-clock twin: sum of actual
                                    # per tick — deterministic under
                                    # traffic.replay, so the A/B floor
                                    # compares it, not wall seconds
        self.peak_replicas = self.actual()
        self.last_action = None
        self.last_burn = 0.0
        self.last_pressure = 0.0
        self.timeline = []
        self._up_streak = 0
        self._down_streak = 0
        self._cool = 0
        self._last_now = None
        router.autoscaler = self

    # ------------------------------------------------------------- #
    # fleet signals
    # ------------------------------------------------------------- #

    def actual(self):
        """Replicas still IN the fleet (warming and backoff-respawning
        included; retired and budget-spent slots are gone for good)."""
        return sum(1 for r in self.router.replicas
                   if r.state != RETIRED and not r.terminal)

    def worst_burn(self):
        """Max burn rate across every UP replica's SLO monitors (0.0
        with no monitors configured — no evidence is not a breach)."""
        worst = 0.0
        for r in self.router.replicas:
            if r.state != UP or r.engine is None:
                continue
            mon = getattr(r.engine, "slo", None)
            if mon is None:
                continue
            for s in mon.slos:
                worst = max(worst, mon.burn_rate(s.name))
        return worst

    # ------------------------------------------------------------- #
    # the control loop
    # ------------------------------------------------------------- #

    def tick(self, now=None):
        """One control decision (the router calls this per step).
        Disabled = a strict no-op: no gauges, no events, no membership
        changes — byte-identical to a router with no autoscaler."""
        if not self.enabled:
            return
        now = time.perf_counter() if now is None else now
        self.ticks += 1
        actual = self.actual()
        if self._last_now is not None:
            # replica-seconds integrate ACTUAL membership over wall
            # time: a warming replica costs money before it serves
            self.replica_seconds += actual * max(now - self._last_now,
                                                 0.0)
        self._last_now = now
        self.replica_ticks += actual
        self.peak_replicas = max(self.peak_replicas, actual)
        burn = self.worst_burn()
        pressure = self.router.queue_pressure()
        self.last_burn, self.last_pressure = burn, pressure
        telemetry.set_gauge("fleet.replicas", actual)
        telemetry.set_gauge("fleet.burn", round(burn, 4))
        hot = burn >= self.up_burn or pressure >= self.up_pressure
        idle = (burn < 1.0 and pressure <= self.down_pressure
                and not self.router._pending)
        self._up_streak = self._up_streak + 1 if hot else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        if self._cool > 0:
            self._cool -= 1
            return
        if self._up_streak >= self.up_ticks and actual < self.fleet_max:
            self._scale_up(burn, pressure)
        elif self._down_streak >= self.down_ticks \
                and actual > self.fleet_min:
            ws = self.router.weight_sync
            if ws is not None and ws.active is not None:
                # never drop below the version-committed quorum while a
                # rollout is in flight: retiring a replica mid-rollout
                # would shrink the set the commit is defined over
                self.deferred_rollout += 1
                return
            self._scale_down(burn, pressure)

    def _scale_up(self, burn, pressure):
        reason = "burn" if burn >= self.up_burn else "pressure"
        idx = len(self.router.replicas)   # the index add_replica takes
        self._emit("scale_up", idx, reason, burn, pressure,
                   target=min(self.actual() + 1, self.fleet_max))
        self.router.add_replica(warm_prefixes=self.warm_prefixes)
        self.scale_ups += 1
        self._settle("scale_up", idx, reason)

    def _scale_down(self, burn, pressure):
        victim = self._victim()
        if victim is None:
            return
        self._emit("scale_down", victim.index, "idle", burn, pressure,
                   target=max(self.actual() - 1, self.fleet_min))
        self.router.retire_replica(victim.index, reason="scale_down")
        self.scale_downs += 1
        self._settle("scale_down", victim.index, "idle")

    def _victim(self):
        """Least-loaded serving replica; newest breaks ties (it holds
        the least session/prefix warmth).  Quiesced (swap-held) and
        non-UP replicas are never retired from under their owner."""
        cands = [r for r in self.router.replicas
                 if r.state == UP
                 and r.index not in self.router._swap_hold]
        if len(cands) < 2:
            return None   # retiring the last UP replica strands traffic
        return min(cands,
                   key=lambda r: (r.queue_depth + r.live, -r.index))

    # ------------------------------------------------------------- #
    # bookkeeping
    # ------------------------------------------------------------- #

    def _emit(self, action, idx, reason, burn, pressure, target):
        self.router._fail_event(
            action, replica=idx, reason=reason, target=target,
            actual=self.actual(), burn=round(burn, 4),
            pressure=round(pressure, 4))
        self.timeline.append({
            "tick": self.ticks, "action": action, "replica": idx,
            "reason": reason, "burn": round(burn, 4),
            "pressure": round(pressure, 4)})

    def _settle(self, action, idx, reason):
        self.last_action = {"action": action, "replica": idx,
                            "reason": reason, "tick": self.ticks}
        self._up_streak = self._down_streak = 0
        self._cool = self.cooldown
        # the scale timeline is the incident black box: what the fleet
        # believed (burn/pressure per action) when it resized itself
        flight.RECORDER.dump(action, replica=idx, cause=reason,
                             timeline=list(self.timeline[-8:]))

    def snapshot(self):
        """JSON-able view (rides ``router.snapshot()['autoscaler']``;
        ``hetu_top --fleet`` renders the event-stream twin)."""
        return {
            "enabled": self.enabled,
            "min": self.fleet_min,
            "max": self.fleet_max,
            "actual": self.actual(),
            "peak_replicas": self.peak_replicas,
            "ticks": self.ticks,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "deferred_rollout": self.deferred_rollout,
            "replica_seconds": round(self.replica_seconds, 4),
            "replica_ticks": self.replica_ticks,
            "burn": round(self.last_burn, 4),
            "pressure": round(self.last_pressure, 4),
            "cooldown_left": self._cool,
            "last_action": self.last_action,
        }
