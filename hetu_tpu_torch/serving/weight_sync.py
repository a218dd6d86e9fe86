"""Live weight sync: zero-downtime rolling weight swaps over the fleet.

``WeightSyncCoordinator`` takes a new version-stamped param pytree
(pulled from the sharded PS via ``begin_from_ps`` or handed in
directly) and rolls it across a ``ServingRouter``'s replicas ONE AT A
TIME with zero request loss.  Per replica the cycle is

    quiesce -> drain -> swap -> probe -> readmit

- **quiesce**: the router stops routing to the replica (the same
  exclusion model as an open circuit breaker — ``_candidates`` skips
  it; in-flight work keeps stepping).
- **drain**: every request the router assigned to the replica retires
  (or requeues off it if it dies) and the engine's own queue empties.
  Draining is bounded by ``HETU_SWAP_DRAIN_STEPS`` router steps.
- **swap**: ``engine.swap_params`` replaces the param dict between
  steps — no recompile (the jitted step takes params as arguments),
  and the spec-decode truncated-layer draft inherits the swap for free
  because it shares the target's param dict.
- **probe**: a version-tagged greedy decode (``HETU_SWAP_PROBE_TOKENS``
  tokens) must retire on the NEW version before the replica serves
  traffic again — the half-open readmission check of the breaker,
  applied to weights.
- **readmit**: the hold lifts; the rollout advances to the next
  replica.  When the last replica readmits, the new pytree+version
  become COMMITTED.

Failure is a first-class path, not an afterthought.  Chaos seams
(``HETU_CHAOS`` with ``role=swap``) cover the swap lifecycle: a kill
drawn mid-drain or mid-swap (after the buffers moved, before the
probe) kills the target replica, and a ``drop``/``reset`` drawn at the
version-push seam models a corrupt/stale version read.  Every failure
degrades cleanly: the dead replica respawns on the LAST COMMITTED
version (the coordinator wraps the replica factories), the coordinator
marks the rollout failed, auto-rolls any already-swapped replicas back
(``HETU_SWAP_ROLLBACK``), and the flight recorder dumps the swap
timeline.  A stale push (incoming version <= committed) never touches
an engine.

Versions are stamped end to end: ``engine.metrics.tags`` carries
``weight_version`` so EVERY serve event is stamped, retired ``Result``s
carry the admission version, and ``hetu_trace --check`` enforces the
version-coherence rule (no retirement mixes versions; a request only
changes version across a ``router_hop`` requeue).
"""

from __future__ import annotations

import time

from .. import envvars
from ..ps import faults
from ..telemetry import flight
from .request import Request
from .replica import RETIRED, UP

__all__ = ["WeightSyncCoordinator"]

_DEFAULT_PROBE_PROMPT = (1, 2, 3)


class WeightSyncCoordinator:
    """Rolls version-stamped weight swaps across a router's fleet.

    Construct with the fleet's CURRENT params and version — that pair
    is the committed baseline every respawn and rollback returns to::

        coord = WeightSyncCoordinator(router, params, version=1)
        coord.begin(new_params, version=2)   # or begin_from_ps(ps, keys)
        out = router.run(trace)              # swap rolls mid-trace
        coord.drain()                        # finish a quiet-fleet tail
        assert coord.state == "done" and coord.committed_version == 2

    The coordinator attaches itself as ``router.weight_sync``; the
    router calls ``tick()`` once per ``step()``, so a rollout advances
    exactly as fast as the fleet serves — there is no second thread
    and no lock.
    """

    def __init__(self, router, params, version, *, probe_tokens=None,
                 drain_steps=None, rollback=None, probe_prompt=None,
                 probe_factory=None):
        self.router = router
        self.committed_params = dict(params)
        self.committed_version = int(version)
        self.probe_tokens = int(
            probe_tokens if probe_tokens is not None
            else envvars.get_int("HETU_SWAP_PROBE_TOKENS"))
        self.drain_steps = int(
            drain_steps if drain_steps is not None
            else envvars.get_int("HETU_SWAP_DRAIN_STEPS"))
        self.rollback = bool(
            rollback if rollback is not None
            else envvars.get_bool("HETU_SWAP_ROLLBACK"))
        self.probe_prompt = list(probe_prompt or _DEFAULT_PROBE_PROMPT)
        # fn(replica_index, version) -> Request/EmbedRequest: overrides
        # the default greedy-GPT probe (an embed fleet's probe payload
        # is model-shaped, so the caller supplies it; without one an
        # embed replica readmits on the version stamp alone)
        self.probe_factory = probe_factory
        self.active = None     # in-flight rollout dict
        self.last = None       # most recent terminal rollout status
        self.rollouts = 0      # begun (incl. rejected)
        router.weight_sync = self
        # respawns come back on the LAST COMMITTED version, whatever
        # params the user's factory bakes in — and every incarnation
        # (re-)stamps its version so the serve stream never goes
        # unversioned after a death
        for rep in router.replicas:
            rep.factory = self._committed_factory(rep.factory)
            if rep.engine is not None:
                rep.engine.set_weight_version(self.committed_version)

    def adopt(self, rep):
        """Version-pin a replica that JOINED the fleet live (elastic
        scale-up): wrap its factory so every incarnation respawns on
        the committed version, stamp the live engine onto the committed
        params/version NOW — admission on the committed version is the
        bring-up contract — and, when a rollout is in flight, extend
        the rollout order to cover it so the fleet still converges on
        the new version after the commit."""
        rep.factory = self._committed_factory(rep.factory)
        if rep.engine is not None:
            rep.engine.swap_params(self.committed_params,
                                   version=self.committed_version)
        ro = self.active
        if ro is not None and rep.index not in ro["order"]:
            ro["order"].append(rep.index)
            self._mark("rollout_adopt", replica=rep.index,
                       version=ro["version"])

    # ------------------------------------------------------------- #
    # entry points
    # ------------------------------------------------------------- #

    def begin(self, params, version, *, _phase="rollout", _order=None):
        """Start rolling ``params`` (stamped ``version``) across the
        fleet.  Monotonicity is enforced: a stale push (version <=
        committed) is rejected without touching any engine.  Returns
        True when the rollout is admitted."""
        if self.active is not None:
            raise RuntimeError(
                f"rollout to v{self.active['version']} still in flight")
        self.rollouts += 1
        version = int(version)
        plan = faults.plan_from_env()
        corrupt = False
        if plan is not None and _phase == "rollout":
            f = plan.draw(method="swap.version_push",
                          kinds=("drop", "reset"), role="swap",
                          inline=True)
            corrupt = f.kind in ("drop", "reset")
        if _phase == "rollout" and \
                (corrupt or version <= self.committed_version):
            self.router._fail_event(
                "swap_rejected_stale", version=version,
                committed=self.committed_version,
                reason="chaos corrupt" if corrupt else "stale")
            self.last = {"version": version, "phase": _phase,
                         "state": "rejected_stale", "swapped": []}
            return False
        order = (list(_order) if _order is not None
                 else [r.index for r in self.router.replicas
                       if r.state != RETIRED])
        self.active = {
            "version": version, "params": dict(params), "phase": _phase,
            "order": order, "i": 0, "state": "quiesce",
            "swapped": [], "drain_ticks": 0, "restarts0": None,
            "timeline": [], "t0": time.perf_counter(),
        }
        self.router._event("rollout_start", version=version,
                           replicas=len(order), phase=_phase)
        self._mark("rollout_start", replicas=len(order))
        return True

    def begin_from_ps(self, ps, keys):
        """Pull ``keys`` (torn-read-guarded) plus the fleet version
        stamp from a ``ShardedPSClient`` and start that rollout."""
        params, version = ps.pull_versioned(keys)
        if version is None:
            raise ValueError(
                "PS holds no __weights_version__ stamp; "
                "set_weights_version() must accompany the weight push")
        return self.begin(params, version)

    # ------------------------------------------------------------- #
    # the state machine (driven from router.step)
    # ------------------------------------------------------------- #

    def tick(self, now=None):
        """Advance the rollout by at most one replica-state transition.
        Called by ``router.step()`` before the death-drain pass, so a
        chaos kill fired here requeues the victim's requests within the
        SAME router iteration (zero loss)."""
        ro = self.active
        if ro is None:
            return
        rep = self.router.replicas[ro["order"][ro["i"]]]
        st = ro["state"]
        if st == "quiesce":
            self._quiesce(ro, rep)
        elif st == "drain":
            self._drain(ro, rep)
        elif st == "swap":
            self._swap_and_probe(ro, rep)

    def drain(self, max_steps=10_000):
        """Step the router until the in-flight rollout (and any
        rollback it triggers) reaches a terminal state.  Returns True
        when nothing is left in flight."""
        steps = 0
        while self.active is not None and steps < max_steps:
            self.router.step()
            steps += 1
        return self.active is None

    # -- per-state handlers ---------------------------------------- #

    def _quiesce(self, ro, rep):
        idx = rep.index
        self.router._swap_hold.add(idx)
        ro["restarts0"] = rep.restarts
        ro["drain_ticks"] = 0
        ro["state"] = "drain"
        self.router._event("swap_quiesce", replica=idx,
                           version=ro["version"])
        self._mark("swap_quiesce", replica=idx)
        if self._chaos_kill(ro, rep, seam="swap.drain",
                            reason="mid_drain_kill"):
            return

    def _drain(self, ro, rep):
        idx = rep.index
        if rep.state != UP or rep.restarts != ro["restarts0"]:
            self._fail(ro, f"replica {idx} died while draining")
            return
        held = any(not self.router._routed[rid].done
                   for rid in self.router._assigned[idx])
        if held or rep.engine.pending:
            ro["drain_ticks"] += 1
            if ro["drain_ticks"] > self.drain_steps:
                self._fail(ro, f"replica {idx} failed to drain within "
                               f"{self.drain_steps} steps")
            return
        ro["state"] = "swap"
        self.router._event("swap_drained", replica=idx,
                           version=ro["version"],
                           ticks=ro["drain_ticks"])
        self._mark("swap_drained", replica=idx)

    def _swap_and_probe(self, ro, rep):
        idx = rep.index
        if rep.state != UP or rep.restarts != ro["restarts0"]:
            self._fail(ro, f"replica {idx} died before the swap")
            return
        eng = rep.engine
        try:
            eng.swap_params(ro["params"], version=ro["version"])
        except Exception as e:  # noqa: BLE001 — corrupt pytree path
            self._fail(ro, f"swap on replica {idx} rejected: {e}")
            return
        self._mark("swap_applied", replica=idx)
        # the mid-swap black box: buffers already moved, probe not run
        if self._chaos_kill(ro, rep, seam="swap.apply",
                            reason="mid_swap_kill", swapped=True):
            return
        ok = self._probe(ro, rep)
        self.router._event("swap_probe", replica=idx,
                           version=ro["version"], ok=ok)
        self._mark("swap_probe", replica=idx, ok=ok)
        if not ok:
            ro["swapped"].append(idx)   # new weights ARE live: roll back
            self._fail(ro, f"probe decode failed on replica {idx}")
            return
        ro["swapped"].append(idx)
        self.router._swap_hold.discard(idx)
        self.router._event("swap_readmit", replica=idx,
                           version=ro["version"])
        self._mark("swap_readmit", replica=idx)
        ro["i"] += 1
        self.router._event("rollout_advance", version=ro["version"],
                           done=ro["i"], replicas=len(ro["order"]))
        if ro["i"] >= len(ro["order"]):
            self._commit(ro)
        else:
            ro["state"] = "quiesce"

    def _probe(self, ro, rep):
        """One greedy decode on the quiesced, freshly swapped engine:
        it must retire, and its Result must carry the new version."""
        eng = rep.engine
        if self.probe_factory is not None:
            probe = self.probe_factory(rep.index, ro["version"])
        elif hasattr(eng, "tables"):
            # embed engine, no caller-supplied probe payload: the
            # version stamp swap_params just applied is the check
            return eng.weight_version == ro["version"]
        else:
            rid = f"swap-probe-r{rep.index}-v{ro['version']}"
            probe = Request(prompt=list(self.probe_prompt),
                            max_new_tokens=max(self.probe_tokens, 1),
                            temperature=0.0, request_id=rid, seed=0)
        try:
            res = eng.run([probe]).get(probe.request_id)
        except Exception:  # noqa: BLE001 — a crashing probe is a veto
            res = None
        rep.last_beat = time.perf_counter()
        produced = getattr(res, "n_generated", None) or \
            getattr(res, "n_pairs", 0)
        return (res is not None and produced >= 1
                and res.weight_version == ro["version"])

    # -- terminal transitions -------------------------------------- #

    def _commit(self, ro):
        if ro["phase"] == "rollout":
            self.committed_params = ro["params"]
            self.committed_version = ro["version"]
        self.router._event("rollout_done", version=ro["version"],
                           swapped=len(ro["swapped"]),
                           phase=ro["phase"])
        self._mark("rollout_done")
        state = "done" if ro["phase"] == "rollout" else "rolled_back"
        self.last = {"version": ro["version"], "phase": ro["phase"],
                     "state": state, "swapped": list(ro["swapped"])}
        self.active = None

    def _fail(self, ro, reason):
        idx = ro["order"][ro["i"]]
        self.router._swap_hold.discard(idx)
        self._mark("rollout_failed", reason=reason)
        flight.RECORDER.dump(
            "swap_rollout_failed", version=ro["version"],
            phase=ro["phase"], why=reason,
            swapped=list(ro["swapped"]), timeline=list(ro["timeline"]))
        self.router._fail_event(
            "rollout_failed", version=ro["version"], reason=reason,
            phase=ro["phase"], swapped=len(ro["swapped"]))
        self.last = {"version": ro["version"], "phase": ro["phase"],
                     "state": "failed", "reason": reason,
                     "swapped": list(ro["swapped"])}
        self.active = None
        if ro["phase"] != "rollout":
            return  # a failing rollback does not recurse; respawns
            # (committed-version factories) still converge the fleet
        # roll already-swapped, still-alive replicas back to committed
        # (a dead one respawns on committed by itself)
        back = [i for i in ro["swapped"]
                if self.router.replicas[i].state == UP
                and self.router.replicas[i].engine.weight_version
                == ro["version"]]
        if self.rollback and back:
            self.router._event("rollout_rollback",
                               version=self.committed_version,
                               replicas=len(back))
            self.begin(self.committed_params, self.committed_version,
                       _phase="rollback", _order=back)
        elif not back:
            # nothing swapped stayed up: the fleet is already entirely
            # on the committed version — a clean rollback by vacuity
            self.last["state"] = "rolled_back"

    # -- chaos + bookkeeping --------------------------------------- #

    def _chaos_kill(self, ro, rep, *, seam, reason, swapped=False):
        """Draw the role=swap kill seam; on a hit the TARGET replica
        dies (the router requeues its work this same step) and the
        rollout fails over to rollback."""
        if ro["phase"] != "rollout":
            return False   # rollback is the recovery path: no seams
        plan = faults.plan_from_env()
        if plan is None:
            return False
        f = plan.draw(method=seam, kinds=("kill",), role="swap",
                      inline=True)
        if f.kind != "kill":
            return False
        if swapped:
            ro["swapped"].append(rep.index)
        flight.RECORDER.dump("swap_chaos_kill", replica=rep.index,
                             seam=seam, version=ro["version"])
        rep.die(rc=-9, error=f"chaos swap kill ({seam})")
        self._fail(ro, reason)
        return True

    def _committed_factory(self, orig):
        def factory(index):
            eng = orig(index)
            if self.committed_version is not None:
                eng.swap_params(self.committed_params,
                                version=self.committed_version)
            return eng
        return factory

    def _mark(self, event, **fields):
        if self.active is not None:
            self.active["timeline"].append(dict(
                t=round(time.perf_counter() - self.active["t0"], 6),
                event=event, **fields))

    # ------------------------------------------------------------- #
    # observability
    # ------------------------------------------------------------- #

    @property
    def state(self):
        """'rolling' / 'rolling_back' while in flight, else the last
        terminal state ('done'/'failed'/'rolled_back'/
        'rejected_stale'), or 'idle' before any rollout."""
        if self.active is not None:
            return ("rolling" if self.active["phase"] == "rollout"
                    else "rolling_back")
        return self.last["state"] if self.last else "idle"

    def fleet_versions(self):
        """{replica index -> weight_version} for UP replicas."""
        return {r.index: r.engine.weight_version
                for r in self.router.replicas if r.state == UP}

    def snapshot(self):
        """JSON-able rollout view (rides ``router.snapshot()``)."""
        out = {"committed_version": self.committed_version,
               "state": self.state, "rollouts": self.rollouts}
        if self.active is not None:
            out["rolling"] = {
                "version": self.active["version"],
                "phase": self.active["phase"],
                "done": self.active["i"],
                "replicas": len(self.active["order"]),
                "replica_state": self.active["state"],
            }
        if self.last is not None:
            out["last"] = {k: v for k, v in self.last.items()
                           if k != "params"}
        return out
