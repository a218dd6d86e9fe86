"""One supervised serving replica: a ServingEngine under the
launcher's respawn/backoff budget pattern.

``launcher.run_cluster`` keeps training alive by watching child exit
codes and respawning dead PS servers/workers under an exponential-
backoff restart budget (``HETU_RESTART_LIMIT`` / ``HETU_RESTART_BACKOFF``)
with structured JSONL failure events.  This module is the serving-side
analog of one of those supervisor slots: a :class:`Replica` owns one
engine incarnation, absorbs its death (an exception escaping the
scheduler, or a chaos-injected kill), and respawns a FRESH engine from
the factory under the same budget semantics, emitting the same style of
failure events (``replica_exit`` / ``replica_restart_scheduled`` /
``replica_restart`` / ``replica_failed``) through ``telemetry.emit``.

The harness is cooperative (in-process): ``step()`` advances the
wrapped engine one scheduler iteration and stamps a heartbeat.  Death
loses the incarnation's queue and in-flight slots exactly the way a
SIGKILL'd process loses its memory — the ROUTER (serving/router.py)
owns the request-level recovery, requeueing everything the dead
incarnation had not retired onto peers from its own assignment records
(it never needs to introspect the corpse).

Chaos: each ``step()`` draws one decision from the ``HETU_CHAOS`` plan
with this replica's role (``replica<k>``) passed explicitly — several
replica roles share one process, so the env-var role is not enough —
and ``inline=True`` so a drawn ``kill`` comes back as a Fault instead
of SIGKILLing the whole fleet.  ``kill=<n>`` then means "this replica's
n-th step dies"; ``wedge=<n>`` means it stops progressing AND stops
heartbeating (silently — detection is the router's stale-heartbeat
check, the serving analog of ``HETU_LIVENESS_STALE``).  The flight
recorder dumps before the death, exactly like the transport-seam kill.
"""

from __future__ import annotations

import time

from .. import envvars, telemetry
from ..ps import faults
from ..telemetry import flight
from .engine import QueueFull

# replica lifecycle states
UP = "up"              # serving traffic
WEDGED = "wedged"      # alive, not progressing, not heartbeating
BACKOFF = "backoff"    # dead, respawn scheduled
DEAD = "dead"          # dead; drain pending or budget spent (terminal
#                        once next_at is +inf)
RETIRED = "retired"    # orderly scale-down exit: terminal by intent,
#                        never respawned (elastic fleet)


class Replica:
    """One supervised engine slot in a router fleet.

    ``factory(index)`` builds a fresh ServingEngine for incarnation
    after incarnation (the router passes one that stamps shared weights
    + config and the ``replica=<index>`` event tag).  ``emit_fn`` routes
    the failure events; default is the failure stream (same sink as the
    launcher's supervisor records).
    """

    def __init__(self, index, factory, *, restart_limit=None,
                 restart_backoff=None, emit_fn=None, kind="mixed",
                 on_start=None):
        self.index = int(index)
        self.role = f"replica{self.index}"
        # serving role for prefill/decode disaggregation
        # ("prefill"/"decode"/"mixed" — HETU_ROUTER_ROLES via the
        # router); distinct from ``role``, the chaos-plan label
        self.kind = str(kind)
        # per-incarnation wiring callback (router: directory feed +
        # handoff export hook) — re-fires on every respawn so a fresh
        # engine is never left unwired
        self.on_start = on_start
        self.factory = factory
        self.restart_limit = (
            restart_limit if restart_limit is not None
            else envvars.get_int("HETU_RESTART_LIMIT"))
        self.backoff0 = (
            restart_backoff if restart_backoff is not None
            else envvars.get_float("HETU_RESTART_BACKOFF"))
        self.emit = emit_fn or (
            lambda kind, **f: telemetry.emit(kind, _stream="failure",
                                             **f))
        self.engine = None
        self.state = DEAD
        self.restarts = 0        # respawns beyond the first incarnation
        self.exit_code = None
        self.exit_error = None
        self.next_at = None      # backoff deadline (perf_counter clock)
        self.last_beat = None    # heartbeat stamp (perf_counter clock)
        self.steps = 0           # lifetime step count (all incarnations)
        self.drained = True      # router has recovered our requests
        # elastic-fleet lifecycle phase (warming/serving/draining/
        # retired) — the router's add/retire paths drive it; a
        # statically constructed replica is simply serving
        self.lifecycle = "serving"
        self._start()
        self.emit("replica_start", replica=self.index)

    # ------------------------------------------------------------- #
    # lifecycle
    # ------------------------------------------------------------- #

    def _start(self):
        """Spawn a fresh engine incarnation (the supervisor's respawn)."""
        self.engine = self.factory(self.index)
        self.engine.metrics.tags.setdefault("replica", self.index)
        self.engine.metrics.tags.setdefault("role", self.kind)
        self.state = UP
        self.exit_code = None
        self.exit_error = None
        self.next_at = None
        self.last_beat = time.perf_counter()
        self.drained = True
        if self.on_start is not None:
            self.on_start(self)

    def die(self, rc, error=None):
        """The incarnation is gone: its queue and in-flight slots are
        lost with it (the router requeues from its own records —
        ``drained`` flips once it has).  Emits ``replica_exit`` in the
        launcher's record shape."""
        self.engine = None
        self.state = DEAD
        self.exit_code = int(rc)
        self.exit_error = error
        self.drained = False
        fields = {"rc": int(rc), "restarts": self.restarts}
        if error:
            fields["error"] = str(error)[:200]
        self.emit("replica_exit", replica=self.index, **fields)

    def retire(self):
        """Orderly scale-down exit: drop the incarnation and CLOSE the
        supervisor slot for good (no respawn — retirement is intent,
        not failure, so the restart budget is not consulted).  The
        router owns the drain: by the time this fires, every request
        the incarnation held has been requeued onto peers and its hot
        prefixes exported, so the engine is dropped with nothing left
        to lose."""
        self.engine = None
        self.state = RETIRED
        self.lifecycle = "retired"
        self.next_at = float("inf")
        self.drained = True

    def schedule_restart(self, now=None):
        """Enter the backoff window, or go terminal when the budget is
        spent (``replica_failed`` + a flight dump: a replica the fleet
        can never get back is a router terminal failure)."""
        now = time.perf_counter() if now is None else now
        if self.restarts >= self.restart_limit:
            self.emit("replica_failed", replica=self.index,
                      rc=self.exit_code if self.exit_code is not None
                      else -1, restarts=self.restarts)
            flight.RECORDER.dump("replica_budget_spent",
                                 replica=self.index,
                                 restarts=self.restarts)
            self.next_at = float("inf")
            return False
        self.restarts += 1
        backoff = self.backoff0 * 2 ** (self.restarts - 1)
        self.state = BACKOFF
        self.next_at = now + backoff
        self.emit("replica_restart_scheduled", replica=self.index,
                  attempt=self.restarts, backoff_s=round(backoff, 3))
        return True

    def maybe_respawn(self, now=None):
        """Respawn once the backoff window has elapsed."""
        now = time.perf_counter() if now is None else now
        if self.state == BACKOFF and now >= self.next_at:
            self._start()
            self.emit("replica_restart", replica=self.index,
                      attempt=self.restarts)
            return True
        return False

    @property
    def terminal(self):
        """Never coming back: restart budget spent, or retired by an
        orderly scale-down."""
        return self.state in (DEAD, RETIRED) \
            and self.next_at == float("inf")

    @property
    def alive(self):
        return self.state in (UP, WEDGED)

    # ------------------------------------------------------------- #
    # serving
    # ------------------------------------------------------------- #

    def submit(self, request):
        """Forward to the engine (QueueFull propagates to the router's
        placement loop); only valid while routable."""
        if self.state != UP:
            raise QueueFull(f"replica {self.index} is {self.state}")
        return self.engine.submit(request)

    def step(self):
        """One engine scheduler iteration; returns the Results that
        retired.  Draws one chaos decision first (role-scoped,
        inline): a kill dumps the flight ring then kills THIS replica
        only; a wedge freezes it silently.  Any exception escaping the
        engine is a death too (the engine already dumped its own flight
        ring on the way out)."""
        if self.state != UP:
            return []
        fault = self._chaos()
        if fault == "kill":
            # the kill's black box, with the replica attributed — the
            # router-side analog of the transport seam's chaos_kill dump
            flight.RECORDER.dump("replica_chaos_kill",
                                 replica=self.index, step=self.steps)
            self.die(rc=-9, error="chaos kill")
            return []
        if fault == "wedge":
            # silent: a wedged replica does not announce itself — the
            # router's stale-heartbeat check is the detection path
            self.state = WEDGED
            return []
        try:
            done = self.engine.step()
        except QueueFull:
            raise
        except Exception as e:  # noqa: BLE001 — a crash IS the event
            self.die(rc=1, error=f"{type(e).__name__}: {e}")
            return []
        self.steps += 1
        self.last_beat = time.perf_counter()
        return done

    def _chaos(self):
        """One decision from the env chaos plan at this replica's step
        seam; returns "kill"/"wedge"/None."""
        plan = faults.plan_from_env()
        if plan is None:
            return None
        f = plan.draw(method=f"{self.role}.step",
                      kinds=("kill", "wedge"), role=self.role,
                      inline=True)
        return f.kind if f.kind in ("kill", "wedge") else None

    # ------------------------------------------------------------- #
    # signals the router reads
    # ------------------------------------------------------------- #

    def health(self):
        """The engine's SLO health while up; the state name otherwise."""
        return self.engine.health() if self.state == UP else self.state

    @property
    def queue_depth(self):
        return self.engine.queue_depth if self.state == UP else 0

    @property
    def live(self):
        """Sequences currently holding slots."""
        return len(self.engine.kv.live()) if self.state == UP else 0

    @property
    def occupancy(self):
        if self.state != UP:
            return 0.0
        return self.live / max(self.engine.kv.n_slots, 1)

    def stale(self, stale_s, now=None):
        """True when the heartbeat is older than ``stale_s`` (the
        wedged-replica detection the router runs; a wedged replica
        stopped beating but still reads as alive)."""
        if not self.alive or self.last_beat is None:
            return False
        now = time.perf_counter() if now is None else now
        return (now - self.last_beat) > stale_s

    def snapshot(self):
        """JSON-able row for router snapshots / hetu_top --fleet."""
        return {
            "replica": self.index,
            "state": self.state,
            "lifecycle": self.lifecycle,
            "role": self.kind,
            "health": self.health(),
            "restarts": self.restarts,
            "steps": self.steps,
            "queue_depth": self.queue_depth,
            "live": self.live,
            "occupancy": round(self.occupancy, 4),
            "exit_code": self.exit_code,
            "weight_version": (getattr(self.engine, "weight_version",
                                       None)
                               if self.engine is not None else None),
        }
