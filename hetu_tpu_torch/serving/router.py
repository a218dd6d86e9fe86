"""Multi-replica serving router: health-aware routing, dead-replica
drain + requeue, and SLO-class load shedding over N supervised engines.

One ServingEngine is a single scheduler loop; a fleet is N of them
behind this router, which owns everything a fleet adds to the problem:

- **Health-aware weighted routing.**  Each placement scores the
  routable replicas by their SLO health (``engine.health()`` —
  ok/degraded/breach, the SLO monitor's burn-rate signal) discounted by current
  load (queue depth + live slots) and picks the best, so a degraded
  replica sheds weight before it breaches and an empty replica absorbs
  bursts.  Deterministic: same fleet state, same pick.

- **Session affinity.**  ``Request.session_id`` hashes to a home
  replica (stable across the fleet's lifetime), so a returning user's
  shared-prefix KV blocks (the paged pool's refcounted prefix cache)
  stay hot on the replica that already holds them.  When the home replica is
  unroutable the session is remapped to the best peer and the
  ``affinity_prefix_misses`` counter records the cold start
  (``prefix_misses`` is kept as a back-compat snapshot key).

- **Fleet prefix-cache directory.**  Session affinity only guesses
  where warm KV lives; the :class:`PrefixDirectory` KNOWS — each
  replica's refcounted prefix table feeds it registration/eviction
  events, and placement consults it BEFORE the affinity hash: a
  request whose prompt prefix is resident on replica R routes to R (a
  *directory hit*) and attaches the blocks instead of recomputing
  them, falling back to affinity on miss.  Entries are hints: a stale
  hit degrades to a cold admission (the replica's token-verified
  ``match_prefix`` is the only thing that attaches KV), and killing
  the directory (``kill_directory()`` / chaos role "directory")
  degrades the fleet to exact affinity-only behavior —
  ``HETU_ROUTER_DIRECTORY=0`` pins that mode.

- **Prefill/decode disaggregation with KV handoff.**  With
  ``HETU_ROUTER_ROLES`` marking replicas prefill-heavy or
  decode-heavy, a long prompt with no resident prefix anywhere first
  runs as a one-token prefill clone on a prefill-heavy replica; at its
  retirement the router exports the slot's KV blocks
  (``PagedKVManager.export_blocks`` — an int8 pool ships its payload +
  scale planes natively, ~4x cheaper than f32, and
  ``HETU_HANDOFF_QUANT=int8`` forces that wire for exact pools), then
  places the real request on a decode-heavy replica and imports the
  blocks there (``import_blocks`` re-registers the prompt prefix, so
  admission attaches them refcounted).  ``kv_handoff_out``/
  ``kv_handoff_in`` events pair per handoff (a trace --check rule),
  the detour's wall time lands in the ``handoff_ms`` lifecycle
  component, and every failure mode — export short, import short, no
  decode replica up — degrades to a normal cold admission, never an
  error.

- **Supervised replicas with drain + requeue.**  Replicas die (chaos
  kill, scheduler exception) and wedge (alive, silent).  Death is
  detected by state, wedge by stale heartbeat (``HETU_ROUTER_STALE``,
  the serving analog of ``HETU_LIVENESS_STALE``) — either way the
  router DRAINS the corpse from its own assignment records (a dead
  process cannot be introspected) and requeues every unretired request
  onto peers: **no request is lost**, and because outputs are a pure
  function of the Request (seed-derived rng), a requeued request's
  tokens are identical to an undisturbed run.  The lost wall time is
  attributed: a ``router_hop`` event per re-placement plus the
  ``router_hop_ms`` lifecycle component in the peer engine's
  ``ServingMetrics.snapshot()``.  The replica respawns under the
  launcher's exponential-backoff budget (``HETU_RESTART_LIMIT`` /
  ``HETU_RESTART_BACKOFF``); a spent budget is terminal
  (``replica_failed`` + flight dump).

- **Per-replica circuit breaker.**  ``HETU_ROUTER_BREAKER`` consecutive
  failures eject the replica from routing (state "open"); after a
  cooldown one half-open PROBE request is let through — retiring it
  closes the breaker, another failure reopens it with a doubled
  cooldown.  A flapping replica stops eating traffic even while the
  supervisor keeps respawning it.

- **Bounded retry + deadlines.**  A request the router holds (requeued
  off a corpse, or unplaceable) retries with exponential backoff
  (``HETU_ROUTER_RETRY_BACKOFF``) up to ``HETU_ROUTER_RETRY_LIMIT``
  times; exhaustion is a router terminal failure (event + flight dump).
  ``Request.deadline_s`` bounds how long the router may hold it before
  expiring it (``router_deadline``) instead of serving uselessly late.

- **SLO-class load shedding + backpressure.**  Under pressure (fleet
  queue fill >= ``HETU_ROUTER_SHED_QUEUE``, or any replica's SLO state
  at breach with ``HETU_ROUTER_SHED_ON_SLO``) throughput-class
  submissions are shed (:class:`RouterShed`) while latency-class
  requests keep admitting until the fleet is hard-full — keeping
  latency-class TTFT inside budget by sacrificing the traffic that
  only cares about aggregate tokens.  When every routable replica's
  queue is at capacity, ``submit`` raises plain QueueFull: the
  replicas' backpressure propagates up through the router unchanged.

- **Dynamic fleet membership (elastic fleet).**  ``add_replica()``
  grows the fleet live: the new replica spawns under the same
  supervised respawn budget, admits on the COMMITTED weight version
  (the weight-sync coordinator adopts it), prefix-warms from its peers
  through the directory-led ``export_prefix``/``import_blocks``
  handoff — only prefixes the directory can actually route — and must
  pass a half-open greedy probe decode (the breaker's readmission
  model, via the same ``_swap_hold`` quiesce set) before taking
  traffic.  ``retire_replica()`` shrinks it: the victim quiesces,
  exports its hottest prefixes to the best peer (int8-capable codec),
  then every request it held requeues onto peers via the death-drain
  path — ZERO loss, no breaker penalty (retirement is intent, not
  failure) — and its directory entries drop.  A
  :class:`~hetu_tpu_torch.serving.autoscaler.FleetAutoscaler` attached as
  ``router.autoscaler`` gets one tick per ``step()`` and drives both
  ends from SLO burn + queue pressure; chaos seams (``HETU_CHAOS``
  ``role=autoscale``) kill the busiest peer mid-bring-up
  (``autoscale.scale_up``) or the retiring replica mid-drain
  (``autoscale.drain``).

Single-threaded by design: ``step()`` advances supervision, placement,
and every live replica exactly once, which makes chaos runs
seed-deterministic (the integration tests replay a kill and assert
zero loss).  On chip, replicas would live on separate hosts; this
in-process harness is the semantics testbed, the same way the launcher
tests supervise local processes.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

from .. import envvars, telemetry
from ..ps import faults
from ..telemetry import flight
from .engine import QueueFull, _STORM_REJECTS
from .kv_tiers import TieredKVStore
from .prefix_directory import PrefixDirectory
from .replica import (  # noqa: F401
    BACKOFF, DEAD, RETIRED, UP, WEDGED, Replica,
)
from .request import Request

# health-state weights for the routing score (breach still gets a
# trickle: it may be the only replica, and starving it entirely would
# turn a soft breach into a hard outage)
_HEALTH_W = {"ok": 1.0, "degraded": 0.5, "breach": 0.25}
_LEVEL = {"ok": 0, "degraded": 1, "breach": 2}

# role-fit rank per placement phase (stable sort: score order is kept
# within a rank) — a prefill-phase placement prefers prefill-heavy
# replicas, the real (decode) placement prefers decode-heavy ones,
# mixed replicas serve both
_ROLE_RANK = {
    "prefill": {"prefill": 0, "mixed": 1, "decode": 2},
    "decode": {"decode": 0, "mixed": 1, "prefill": 2},
}

_ROLES = ("prefill", "decode", "mixed")


class RouterShed(QueueFull):
    """SLO-class load shed: the fleet is under pressure and this
    request's class is the one provisioned to lose.  Subclasses
    QueueFull so a caller's backpressure handling needs no new case."""


class _Routed:
    """Router-side record of one submitted request."""

    __slots__ = ("request", "t_submit", "t_assigned", "replica",
                 "prev_replica", "hops", "retries", "next_at", "done",
                 "lost", "result", "phase", "prefill_req", "handoff",
                 "handoff_src", "t_phase")

    def __init__(self, request, t_submit):
        self.request = request
        self.t_submit = t_submit     # router clock (perf_counter)
        self.t_assigned = None       # last successful placement
        self.replica = None          # current replica index
        self.prev_replica = None     # where the last hop came from
        self.hops = 0                # requeues off dead replicas
        self.retries = 0             # failed placement attempts
        self.next_at = 0.0           # retry-backoff deadline
        self.done = False
        self.lost = False            # retry budget exhausted
        self.result = None
        # prefill/decode disaggregation: "decode" is the normal
        # lifecycle; "prefill" means a one-token clone is running (or
        # queued) on a prefill-heavy replica and the real request
        # places only after its KV blocks are exported
        self.phase = "decode"
        self.prefill_req = None      # the max_new_tokens=1 clone
        self.handoff = None          # exported KV payload in transit
        self.handoff_src = None      # replica the payload came from
        self.t_phase = None          # prefill-detour start (handoff_ms)


def _session_hash(session_id, n):
    """Stable home-replica index for a session (blake2, not python's
    salted hash(), so affinity survives process restarts)."""
    h = hashlib.blake2b(str(session_id).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % n


class ServingRouter:
    """Load-balance requests across N supervised ServingEngine
    replicas (see module docstring for the robustness contract).

    ``factory(index)`` builds one replica's engine — every incarnation,
    including post-death respawns, comes from it.  All engines must
    share one config (the router pre-validates prompt lengths against
    the first incarnation's ``s_max``).  Knobs default to the
    ``HETU_ROUTER_*`` / launcher env registry entries; constructor
    arguments override.
    """

    def __init__(self, factory, replicas=None, *, session_affinity=None,
                 stale=None, breaker_threshold=None,
                 breaker_cooldown=None, retry_limit=None,
                 retry_backoff=None, shed_queue=None, shed_on_slo=None,
                 restart_limit=None, restart_backoff=None,
                 directory=None, directory_ttl=None, roles=None,
                 handoff_quant=None, kv_tiers=None, log_path=None):
        n = int(replicas if replicas is not None
                else envvars.get_int("HETU_REPLICAS"))
        if n < 1:
            raise ValueError(f"a fleet needs >= 1 replica, got {n}")
        self.session_affinity = (
            session_affinity if session_affinity is not None
            else envvars.get_bool("HETU_ROUTER_AFFINITY"))
        self.stale = float(stale if stale is not None
                           else envvars.get_float("HETU_ROUTER_STALE"))
        self.breaker_threshold = int(
            breaker_threshold if breaker_threshold is not None
            else envvars.get_int("HETU_ROUTER_BREAKER"))
        self.breaker_cooldown = float(
            breaker_cooldown if breaker_cooldown is not None
            else envvars.get_float("HETU_ROUTER_BREAKER_COOLDOWN"))
        self.retry_limit = int(
            retry_limit if retry_limit is not None
            else envvars.get_int("HETU_ROUTER_RETRY_LIMIT"))
        self.retry_backoff = float(
            retry_backoff if retry_backoff is not None
            else envvars.get_float("HETU_ROUTER_RETRY_BACKOFF"))
        self.shed_queue = float(
            shed_queue if shed_queue is not None
            else envvars.get_float("HETU_ROUTER_SHED_QUEUE"))
        self.shed_on_slo = (
            shed_on_slo if shed_on_slo is not None
            else envvars.get_bool("HETU_ROUTER_SHED_ON_SLO"))
        self.log_path = log_path
        # fleet prefix-cache directory (must exist before the replicas:
        # each incarnation wires itself in via _wire_replica)
        use_dir = (directory if directory is not None
                   else envvars.get_bool("HETU_ROUTER_DIRECTORY"))
        self.directory = (PrefixDirectory(ttl=directory_ttl)
                          if use_dir else None)
        self.directory_killed = False
        # tiered KV: one fleet-shared spill/fetch ladder
        # behind every replica's pool — evicted prefix blocks tier to
        # the host ring / PS cold store instead of dropping.  None =
        # today's drop-on-evict, byte-identical (no hooks wired).
        # Must exist before the replicas: _wire_replica attaches each
        # incarnation's pool
        self.kv_tiers = (kv_tiers if kv_tiers is not None
                         else TieredKVStore.from_env())
        if self.kv_tiers is not None:
            self.kv_tiers.directory = self.directory
            if self.directory is not None:
                self.directory.tiered = True
        # prefill/decode roles, one per replica index; unlisted = mixed
        raw = roles if roles is not None \
            else envvars.get_str("HETU_ROUTER_ROLES")
        parsed = [s.strip().lower()
                  for s in str(raw or "").split(",") if s.strip()]
        for s in parsed:
            if s not in _ROLES:
                raise ValueError(
                    f"unknown replica role {s!r} (expected one of "
                    f"{_ROLES})")
        self.roles = (parsed + ["mixed"] * n)[:n]
        # handoffs need both phases represented somewhere in the fleet
        self._roles_active = ("prefill" in self.roles
                              and "decode" in self.roles)
        self.handoff_quant = handoff_quant
        # dynamic membership (add_replica) builds later replicas from
        # the same factory/budget the constructor fleet got
        self._factory = factory
        self._restart_limit = restart_limit
        self._restart_backoff = restart_backoff
        self.replicas = [
            Replica(i, factory, restart_limit=restart_limit,
                    restart_backoff=restart_backoff,
                    emit_fn=self._fail_event, kind=self.roles[i],
                    on_start=self._wire_replica)
            for i in range(n)]
        self.s_max = self.replicas[0].engine.kv.s_max
        self._routed = {}                      # rid -> _Routed
        self._assigned = {i: {} for i in range(n)}  # idx -> ordered rids
        self._pending = collections.deque()    # router-held, to place
        self._breaker = [
            {"state": "closed", "failures": 0, "open_until": 0.0,
             "probe": None, "opens": 0} for _ in range(n)]
        # live weight sync: replicas quiesced for a rolling swap are
        # excluded from placement exactly like an open breaker; the
        # WeightSyncCoordinator (router.weight_sync) owns the set and
        # gets a tick per step to advance its rollout
        self._swap_hold = set()
        self.weight_sync = None
        # elastic fleet: a FleetAutoscaler attaches itself here and
        # gets one tick per step; None = today's static behavior
        self.autoscaler = None
        self._scale_seq = 0       # unique bring-up probe request ids
        self._reject_streak = [0] * n
        self._session_last = {}                # session_id -> replica
        # counters (snapshot surface)
        self.submitted = 0
        self.finished = 0
        self.shed = 0
        self.shed_by_class = {"latency": 0, "throughput": 0}
        self.requeued = 0
        self.expired = 0
        self.lost = 0
        self.duplicates = 0
        self.affinity_prefix_misses = 0
        self.handoffs = 0
        self.handoff_failed = 0
        self.handoffs_skipped = 0
        self.handoff_bytes = 0
        self._placed = [0] * n
        self._rejects = [0] * n
        self._lat = []                         # fleet e2e latency (s)
        self._ttft = []                        # fleet submit->token1 (s)
        self._ttft_by_class = {"latency": [], "throughput": []}

    @property
    def prefix_misses(self):
        """Back-compat alias: before the directory split this counter
        (affinity remaps only) was named ``prefix_misses``."""
        return self.affinity_prefix_misses

    # ------------------------------------------------------------- #
    # directory + handoff wiring
    # ------------------------------------------------------------- #

    def _wire_replica(self, rep):
        """Per-incarnation wiring (fires from ``Replica._start``, so
        respawns rewire themselves): feed the fresh engine's prefix
        registrations into the directory and install the retire hook
        that exports a prefill-phase slot's KV before release."""
        eng = rep.engine
        if eng is None:
            return
        if self.directory is not None:
            self.directory.attach(rep.index, eng.kv)
        if self.kv_tiers is not None:
            # evictions on this incarnation's pool spill to the fleet
            # ladder; its admission path fetches back through it
            self.kv_tiers.attach(rep.index, eng.kv)
        eng.retire_hook = \
            lambda req, slot, _rep=rep: self._on_retire(_rep, req, slot)

    def _on_retire(self, rep, req, slot):
        """Engine retire hook: a prefill-phase clone is retiring with
        its slot still live — export the KV blocks now (release frees
        them a moment later)."""
        routed = self._routed.get(req.request_id)
        if routed is None or routed.phase != "prefill":
            return
        try:
            routed.handoff = rep.engine.kv.export_blocks(
                slot, self.handoff_quant)
            routed.handoff_src = rep.index
        except ValueError:
            # can't serialize (already released?): the real request
            # admits cold — degradation, not failure
            routed.handoff = None

    def kill_directory(self, reason="killed"):
        """Drop the directory: the fleet degrades to exact
        session-affinity routing (and, roles aside, no new handoffs
        start — in-flight payloads still land).  The chaos gate drives
        this mid-trace and asserts zero token loss."""
        if self.directory is None:
            return
        self.directory = None
        self.directory_killed = True
        if self.kv_tiers is not None:
            # the tier ladder survives a directory kill (engine-level
            # fetches consult the store's own index) — it just stops
            # stamping tier columns on a corpse
            self.kv_tiers.directory = None
        self._fail_event("directory_killed", reason=reason)
        flight.RECORDER.dump("directory_killed")

    def _directory_lookup(self, req, now):
        """One routing consult; returns (hint, outcome) — see
        ``PrefixDirectory.lookup``.  The chaos seam lives here: a drawn
        kill (role "directory") drops the directory mid-lookup."""
        if self.directory is None or \
                getattr(req, "prompt", None) is None:
            # payloads without a token prompt (embedding requests)
            # have no prefix to look up
            return None, None
        plan = faults.plan_from_env()
        if plan is not None:
            f = plan.draw(method="router.directory_lookup",
                          kinds=("kill",), role="directory", inline=True)
            if f is not None and f.kind == "kill":
                self.kill_directory(reason="chaos")
                return None, None
        return self.directory.lookup(req.prompt, now)

    def _handoff_applies(self, req):
        """A prefill->decode handoff is worth starting only when both
        roles exist in the fleet, the engines run the paged
        prefix-sharing layout, and the prompt spans at least one full
        block (``match_prefix`` caps sharing below the last prompt
        position, so a sub-block prompt hands off nothing)."""
        if not self._roles_active or \
                getattr(req, "prompt", None) is None:
            return False
        for r in self.replicas:
            if r.engine is not None:
                kv = r.engine.kv
                block = getattr(kv, "block", None)
                return (getattr(kv, "prefix_share", False)
                        and block is not None
                        and len(req.prompt) > block)
        return False

    def _import_handoff(self, routed, rep, now):
        """The real request just placed on ``rep``: land its prefilled
        KV there.  Emits the paired ``kv_handoff_out``/``kv_handoff_in``
        records only when the blocks actually move — an import the pool
        cannot hold degrades to a cold admission (counted, flight-
        visible, never an error)."""
        payload, src = routed.handoff, routed.handoff_src
        routed.handoff = None
        req = routed.request
        rid = req.request_id
        if rep.index == src:
            # placement landed back on the prefill replica: the clone
            # already registered the prefix there — nothing to move
            self.handoffs_skipped += 1
            return
        kv = rep.engine.kv
        slot = None
        if (getattr(kv, "prefix_share", False)
                and payload.get("layout") == "paged"
                and payload.get("block") == getattr(kv, "block", None)):
            try:
                slot = kv.import_blocks(payload, f"{rid}~handoff",
                                        prompt=req.prompt)
            except ValueError:
                slot = None
        if slot is None:
            self.handoff_failed += 1
            self._event("kv_handoff_drop", request=rid,
                        replica=rep.index, from_replica=src)
            return
        # the import slot was only a write vehicle: release it — the
        # re-registered prefix keeps the blocks alive (refcounted), and
        # this request's admission attaches them
        kv.release(slot)
        self.handoffs += 1
        nbytes = int(payload["nbytes"])
        self.handoff_bytes += nbytes
        blocks = -(-int(payload["length"]) // int(payload["block"]))
        hand_ms = (now - (routed.t_phase
                          if routed.t_phase is not None
                          else routed.t_submit)) * 1e3
        rep.engine.metrics.lc_handoff(rid, hand_ms)
        telemetry.inc("router.handoffs")
        self._event("kv_handoff_out", request=rid, replica=src,
                    to_replica=rep.index, bytes=nbytes, blocks=blocks,
                    quant=payload["quant"] or "off")
        self._event("kv_handoff_in", request=rid, replica=rep.index,
                    from_replica=src, bytes=nbytes,
                    handoff_ms=round(hand_ms, 3))

    # ------------------------------------------------------------- #
    # events
    # ------------------------------------------------------------- #

    def _event(self, kind, **fields):
        """Router request-path events ride the serve stream, next to
        the engines' records."""
        return telemetry.emit(kind, _stream="serve", _path=self.log_path,
                              **fields)

    def _fail_event(self, kind, **fields):
        """Supervision events ride the failure stream, in the
        launcher's record shape."""
        return telemetry.emit(kind, _stream="failure", **fields)

    # ------------------------------------------------------------- #
    # fleet signals
    # ------------------------------------------------------------- #

    def health(self):
        """Worst SLO health across serving replicas ("breach" when
        nothing is up: a fleet with no capacity is past degraded)."""
        states = [r.health() for r in self.replicas if r.state == UP]
        if not states:
            return "breach"
        return max(states, key=lambda s: _LEVEL.get(s, 2))

    def queue_pressure(self):
        """Aggregate queue fill fraction across serving replicas
        (1.0 with nothing up — no capacity IS full)."""
        depth = cap = 0
        for r in self.replicas:
            if r.state == UP:
                depth += r.queue_depth
                cap += r.engine.queue_limit
        return (depth / cap) if cap else 1.0

    @property
    def pending(self):
        """Submitted requests not yet retired (router-held + on
        replicas)."""
        return sum(1 for rt in self._routed.values() if not rt.done)

    def _all_terminal(self):
        return all(r.terminal for r in self.replicas)

    # ------------------------------------------------------------- #
    # circuit breaker
    # ------------------------------------------------------------- #

    def _breaker_allows(self, idx, now):
        b = self._breaker[idx]
        if b["state"] == "closed":
            return True
        if b["state"] == "open":
            if now >= b["open_until"]:
                b["state"] = "half_open"
                b["probe"] = None
                self._event("router_breaker", replica=idx,
                            state="half_open")
                return True
            return False
        # half_open: exactly one outstanding probe
        return b["probe"] is None

    def _breaker_failure(self, idx, now):
        b = self._breaker[idx]
        b["failures"] += 1
        b["probe"] = None
        if b["failures"] >= self.breaker_threshold:
            # exponential cooldown in the number of EXTRA failures: a
            # replica that keeps dying backs out of rotation for longer
            cool = self.breaker_cooldown * 2 ** (
                b["failures"] - self.breaker_threshold)
            b["open_until"] = now + cool
            if b["state"] != "open":
                b["opens"] += 1
            b["state"] = "open"
            self._event("router_breaker", replica=idx, state="open",
                        failures=b["failures"],
                        cooldown_s=round(cool, 3))

    def _breaker_success(self, idx, rid):
        b = self._breaker[idx]
        if b["state"] == "half_open" and b["probe"] == rid:
            b["state"] = "closed"
            b["failures"] = 0
            b["probe"] = None
            self._event("router_breaker", replica=idx, state="closed")
        elif b["state"] == "closed":
            b["failures"] = 0   # consecutive-failure semantics

    # ------------------------------------------------------------- #
    # placement
    # ------------------------------------------------------------- #

    def _score(self, r):
        """Health-weighted inverse-load score (higher = better)."""
        w = _HEALTH_W.get(r.health(), 0.25)
        return w / (1.0 + r.queue_depth + r.live)

    def _candidates(self, routed, now):
        """Routable replicas, best first.  With roles active the
        placement phase partitions first (prefill-phase -> prefill-
        heavy replicas lead; decode -> decode-heavy; stable, so score
        order holds within a role rank).  The session's home replica
        (stable hash) leads a decode-phase placement when affinity
        applies and it is routable — a prefill clone has no warmth to
        return to, so affinity skips it, and so does a request
        carrying an exported KV payload (the handoff brings its own
        warmth wherever it lands; the role rank should pick a
        decode-heavy home, not the session hash)."""
        cands = [r for r in self.replicas
                 if r.state == UP and r.index not in self._swap_hold
                 and self._breaker_allows(r.index, now)]
        cands.sort(key=lambda r: (-self._score(r), r.index))
        if self._roles_active:
            rank = _ROLE_RANK[routed.phase]
            cands.sort(key=lambda r: rank.get(r.kind, 1))
        sid = routed.request.session_id
        if self.session_affinity and sid is not None and cands \
                and routed.phase == "decode" and routed.handoff is None:
            home = _session_hash(sid, len(self.replicas))
            for i, r in enumerate(cands):
                if r.index == home:
                    cands.insert(0, cands.pop(i))
                    break
        return cands

    def _place(self, routed, now):
        """Try to put the request on a replica; returns True on
        success.  Placement order: directory hint first (the replica
        that HOLDS the prompt's prefix), then role fit, then session
        affinity, then health-weighted score.  A long prompt no
        replica holds, in a role-split fleet, flips the record into
        its prefill phase here (a one-token clone places instead; the
        real request follows the exported KV).  Emits router_route
        (first placement) or router_hop (requeue) and credits the
        hop's wall time to the peer engine's lifecycle tracker."""
        req = routed.request
        rid = req.request_id
        hint = outcome = None
        if routed.phase == "decode" and routed.handoff is None:
            # prefill-phase placements CREATE a prefix (nothing to look
            # up), and a request carrying a handoff payload already
            # knows where its KV is going
            hint, outcome = self._directory_lookup(req, now)
            if outcome == "tier":
                # warm somewhere, but in the tier ladder, not a pool:
                # no replica to prefer and no hit/steal to stamp — the
                # landing replica's admission fetch re-imports the span
                # (and a prefill-phase split would only recompute what
                # the fetch lands for free, so don't flip phases)
                hint = None
            elif (hint is None and routed.hops == 0
                    and routed.retries == 0
                    and self._handoff_applies(req)):
                routed.phase = "prefill"
                routed.prefill_req = dataclasses.replace(
                    req, max_new_tokens=1, stream_cb=None)
                routed.t_phase = now
        wire_req = (routed.prefill_req if routed.phase == "prefill"
                    else req)
        cands = self._candidates(routed, now)
        if hint is not None:
            for i, r in enumerate(cands):
                if r.index == hint[0]:
                    cands.insert(0, cands.pop(i))
                    break
        for r in cands:
            try:
                r.submit(wire_req)
            except QueueFull:
                self._note_reject(r.index)
                continue
            self._reject_streak[r.index] = 0
            self._placed[r.index] += 1
            b = self._breaker[r.index]
            if b["state"] == "half_open" and b["probe"] is None:
                b["probe"] = rid
            sid = req.session_id
            affinity = None
            if self.session_affinity and sid is not None \
                    and routed.phase == "decode":
                last = self._session_last.get(sid)
                affinity = "hit" if last in (None, r.index) else "miss"
                if affinity == "miss" and routed.handoff is None:
                    # the session's warm prefix blocks live elsewhere:
                    # this placement pays the cold prefill (a handoff
                    # payload is exempt — it ships the warmth along)
                    self.affinity_prefix_misses += 1
                    telemetry.inc("router.prefix_miss")
                self._session_last[sid] = r.index
            if hint is not None:
                if r.index == hint[0]:
                    outcome = "hit"
                    if self.directory is not None:
                        self.directory.hits += 1
                else:
                    # the directory knew a holder but placement landed
                    # elsewhere: the prefix gets recomputed (and
                    # re-registered) at the new home — "stolen"
                    outcome = "steal"
                    if self.directory is not None:
                        self.directory.steals += 1
            self._assigned[r.index][rid] = None
            if routed.hops:
                hop_ms = (now - (routed.t_assigned
                                 if routed.t_assigned is not None
                                 else routed.t_submit)) * 1e3
                r.engine.metrics.lc_hop(rid, hop_ms)
                self._event("router_hop", request=rid,
                            to_replica=r.index,
                            from_replica=routed.prev_replica,
                            hop=routed.hops, hop_ms=round(hop_ms, 3))
            else:
                self._event("router_route", request=rid,
                            replica=r.index, slo_class=req.slo_class,
                            phase=routed.phase,
                            **({"affinity": affinity}
                               if affinity else {}),
                            **({"directory": outcome}
                               if outcome else {}))
            routed.replica = r.index
            routed.t_assigned = now
            if routed.handoff is not None:
                self._import_handoff(routed, r, now)
            return True
        return False

    def _note_reject(self, idx):
        """Per-replica QueueFull streak -> one flight dump per storm
        (the engine-global storm detector cannot tell WHICH replica is
        drowning in a fleet)."""
        self._rejects[idx] += 1
        self._reject_streak[idx] += 1
        if self._reject_streak[idx] == _STORM_REJECTS:
            flight.RECORDER.dump(
                "replica_queue_storm", replica=idx,
                rejects=self._reject_streak[idx],
                pressure=round(self.queue_pressure(), 4))

    # ------------------------------------------------------------- #
    # shedding
    # ------------------------------------------------------------- #

    def _should_shed(self, slo_class):
        """Throughput-class traffic sheds first: under queue pressure
        or an SLO breach anywhere in the fleet, rejecting the traffic
        that only cares about aggregate tokens is what keeps
        latency-class TTFT inside budget.  Latency-class requests are
        only ever refused by hard QueueFull."""
        if slo_class == "latency":
            return False
        if self.queue_pressure() >= self.shed_queue:
            return True
        return self.shed_on_slo and self.health() == "breach"

    # ------------------------------------------------------------- #
    # the public surface (mirrors ServingEngine)
    # ------------------------------------------------------------- #

    def submit(self, request):
        """Route one Request into the fleet.  Raises :class:`RouterShed`
        (a QueueFull) when its SLO class is being shed, plain QueueFull
        when every routable replica's queue is at capacity
        (backpressure propagated up), ValueError when it can never fit,
        RuntimeError when the whole fleet is terminally dead."""
        req = request
        # capacity pre-check through the model-agnostic hook: GPT
        # requests bound prompt+budget against the fleet's S_max;
        # workloads with no sequence bound (embedding waves) return
        # None on either side and skip it
        total = req.capacity_tokens()
        if total is not None and self.s_max is not None \
                and total > self.s_max:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"fleet's S_max {self.s_max}")
        if self._all_terminal():
            raise RuntimeError(
                "fleet terminal: every replica's restart budget is "
                "spent")
        now = time.perf_counter()
        if self._should_shed(req.slo_class):
            self.shed += 1
            self.shed_by_class[req.slo_class] += 1
            self._event("router_shed", request=req.request_id,
                        slo_class=req.slo_class,
                        pressure=round(self.queue_pressure(), 4),
                        health=self.health())
            raise RouterShed(
                f"shedding {req.slo_class}-class traffic "
                f"(pressure {self.queue_pressure():.2f}, "
                f"health {self.health()})")
        routed = _Routed(req, now)
        if not self._place(routed, now):
            raise QueueFull(
                "every routable replica's queue is at capacity")
        self._routed[req.request_id] = routed
        self.submitted += 1
        return req

    def step(self):
        """One fleet iteration: respawn due replicas, detect wedges by
        stale heartbeat, drain + requeue corpses, place router-held
        requests, then advance every serving replica one scheduler
        step.  Returns the Results that retired this iteration."""
        now = time.perf_counter()
        for r in self.replicas:
            r.maybe_respawn(now)
        if self.stale > 0:
            for r in self.replicas:
                if r.alive and r.stale(self.stale, now):
                    # wedged: alive but silent — the mid-run hang.  Kill
                    # it so the death path (drain/requeue/respawn) takes
                    # over, like the launcher's HETU_LIVENESS_STALE.
                    self._fail_event(
                        "replica_wedged_kill", replica=r.index,
                        age_s=round(now - r.last_beat, 3))
                    r.die(rc=-9, error="stale heartbeat")
        if self.weight_sync is not None:
            # advance a rolling weight swap BEFORE the death drain: a
            # chaos kill the coordinator fires here requeues the
            # victim's requests within this same iteration (zero loss)
            self.weight_sync.tick(now)
        if self.autoscaler is not None:
            # the elasticity control loop rides the same single-threaded
            # step as the rollout: a scale-up's chaos kill or a retire's
            # requeue lands BEFORE this iteration's death drain + flush,
            # so displaced requests re-place with zero extra latency
            self.autoscaler.tick(now)
        for r in self.replicas:
            if r.state == DEAD and not r.drained:
                self._on_death(r, now)
        self._flush_pending(now)
        results = []
        for r in self.replicas:
            if r.state != UP:
                continue
            for res in r.step():
                out = self._finish(res, r.index)
                if out is not None:
                    results.append(out)
            if r.state == DEAD and not r.drained:
                # died mid-step: drain NOW so its requests can requeue
                # within this same router iteration
                self._on_death(r, time.perf_counter())
        telemetry.set_gauge("router.pressure",
                            round(self.queue_pressure(), 4))
        return results

    def run(self, requests=()):
        """Submit ``requests`` (stepping through backpressure) then
        step until everything retires; returns {request_id: Result}.
        Shed requests are recorded and dropped — the caller reads
        ``snapshot()['shed']`` — and never appear in the output."""
        out = {}
        for req in requests:
            while True:
                try:
                    self.submit(req)
                    break
                except RouterShed:
                    break
                except QueueFull:
                    for res in self.step():
                        out[res.request_id] = res
        while self.pending:
            for res in self.step():
                out[res.request_id] = res
        return out

    # ------------------------------------------------------------- #
    # elastic fleet membership (live add / retire)
    # ------------------------------------------------------------- #

    def add_replica(self, kind="mixed", *, warm_prefixes=None,
                    probe=True):
        """Grow the fleet live: spawn a fresh supervised replica under
        the same factory/respawn budget the constructor fleet got, at
        the next index (indexes are never reused — a retired slot's
        index stays burned, so the event stream pairs uniquely).

        Bring-up is gated before the replica takes any traffic:

        1. **committed-version admission** — the weight-sync coordinator
           (when wired) adopts it: factory wrapped so every incarnation
           respawns on the committed version, live engine stamped NOW,
           and an in-flight rollout extends its order to cover it;
        2. **prefix warming** — peers' hottest directory-known prefixes
           land via the export/import handoff codec while the replica
           is quiesced (``_swap_hold``), so its first requests hit warm
           blocks instead of cold prefill;
        3. **half-open probe** — one greedy decode must retire on the
           quiesced engine (the breaker's readmission model); a failed
           probe kills the incarnation and hands it to the supervisor
           instead of admitting a replica that cannot serve.

        The ``autoscale.scale_up`` chaos seam (role ``autoscale``)
        draws here: a drawn kill takes out the BUSIEST PEER mid-
        bring-up — the hard case, because the joining replica must
        absorb the victim's requeued load the moment it is ready.
        Returns the new replica's index."""
        if kind not in _ROLES:
            raise ValueError(f"unknown replica kind {kind!r}")
        idx = len(self.replicas)
        self.roles.append(kind)
        self._assigned[idx] = {}
        self._breaker.append({"state": "closed", "failures": 0,
                              "open_until": 0.0, "probe": None,
                              "opens": 0})
        self._reject_streak.append(0)
        self._placed.append(0)
        self._rejects.append(0)
        rep = Replica(idx, self._factory,
                      restart_limit=self._restart_limit,
                      restart_backoff=self._restart_backoff,
                      emit_fn=self._fail_event, kind=kind,
                      on_start=self._wire_replica)
        self.replicas.append(rep)
        self._roles_active = ("prefill" in self.roles
                              and "decode" in self.roles)
        if self.weight_sync is not None:
            self.weight_sync.adopt(rep)
        rep.lifecycle = "warming"
        self._swap_hold.add(idx)
        self._fail_event("replica_warming", replica=idx, role=kind)
        self._chaos_scale_kill(exclude=idx)
        warmed = self._warm_replica(rep, warm_prefixes)
        ok = self._probe_replica(rep) if probe else True
        self._swap_hold.discard(idx)
        if ok:
            rep.lifecycle = "serving"
            self._fail_event("replica_ready", replica=idx,
                             warmed_prefixes=warmed)
        else:
            # bring-up probe failed: never admit — treat it as a death
            # and let the supervisor own the respawn (which re-wires
            # and re-stamps the committed weights via the adopted
            # factory), leaving the scale_up unpaired in the stream:
            # exactly the incident the trace checker flags
            rep.die(rc=1, error="bring-up probe failed")
        return idx

    def retire_replica(self, idx, reason="manual"):
        """Shrink the fleet live, with zero request loss: quiesce the
        victim (``_swap_hold`` — no new placements), export its hottest
        directory-known prefixes to the best UP peer (its warmth must
        not die with it), requeue every request it still held through
        the death-drain records — WITHOUT a breaker penalty or a
        respawn: retirement is intent, not failure — then drop its
        directory entries and close the supervisor slot for good.

        The ``autoscale.drain`` chaos seam draws here: a drawn kill
        takes out the DRAINING replica itself mid-drain.  Zero loss
        must hold anyway — the requeue below reads the router's own
        assignment records, never the corpse (prefix export is skipped:
        the pool died with the engine; honest degradation).

        Returns the number of requeued requests."""
        rep = self.replicas[idx]
        if rep.state == RETIRED:
            return 0
        peers = [r for r in self.replicas
                 if r.index != idx and r.state == UP]
        if not peers:
            raise ValueError(
                f"cannot retire replica {idx}: no UP peer to absorb "
                f"its traffic")
        rep.lifecycle = "draining"
        self._swap_hold.add(idx)
        self._fail_event("replica_draining", replica=idx, reason=reason)
        killed = self._chaos_drain_kill(rep)
        exported, spilled = ((0, 0) if killed
                             else self._export_hot_prefixes(rep))
        assigned = self._assigned[idx]
        rids = [rid for rid in assigned if not self._routed[rid].done]
        self._assigned[idx] = {}
        for rid in rids:
            routed = self._routed[rid]
            routed.hops += 1
            routed.prev_replica = idx
            routed.replica = None
            routed.next_at = 0.0
            self.requeued += 1
            telemetry.inc("router.requeues")
            self._pending.append(routed)
        if self.directory is not None:
            self.directory.drop_replica(idx)
        rep.retire()
        self._swap_hold.discard(idx)
        self._fail_event("replica_retired", replica=idx,
                         requeued=len(rids), exported_prefixes=exported,
                         spilled_prefixes=spilled,
                         reason=reason, rids=list(rids))
        return len(rids)

    def _chaos_scale_kill(self, *, exclude):
        """``autoscale.scale_up`` seam: kill the busiest UP peer while
        the new replica (``exclude``) is mid-bring-up."""
        plan = faults.plan_from_env()
        if plan is None:
            return False
        f = plan.draw(method="autoscale.scale_up", kinds=("kill",),
                      role="autoscale", inline=True)
        if f is None or f.kind != "kill":
            return False
        peers = [r for r in self.replicas
                 if r.state == UP and r.index != exclude]
        if not peers:
            return False
        victim = max(peers,
                     key=lambda r: (r.queue_depth + r.live, -r.index))
        flight.RECORDER.dump("autoscale_chaos_kill",
                             replica=victim.index,
                             seam="autoscale.scale_up")
        victim.die(rc=-9, error="chaos autoscale kill (scale_up)")
        return True

    def _chaos_drain_kill(self, rep):
        """``autoscale.drain`` seam: kill the draining replica itself
        mid-drain (a retire that loses its subject half-way)."""
        plan = faults.plan_from_env()
        if plan is None or rep.state != UP:
            return False
        f = plan.draw(method="autoscale.drain", kinds=("kill",),
                      role="autoscale", inline=True)
        if f is None or f.kind != "kill":
            return False
        flight.RECORDER.dump("autoscale_chaos_kill", replica=rep.index,
                             seam="autoscale.drain")
        rep.die(rc=-9, error="chaos autoscale kill (drain)")
        return True

    def _ship_prefix(self, src, dst, toks, rid):
        """Move one registered prefix ``src`` replica -> ``dst``
        replica through the export/import handoff codec (int8 wire
        when ``HETU_HANDOFF_QUANT`` says so); True when the blocks
        landed.  Emits the paired ``kv_handoff_out``/``kv_handoff_in``
        records under a synthetic warm/retire rid — no request finish
        ever pairs with them, which the trace checker's handoff rule
        already tolerates (0-finish rids are exempt)."""
        try:
            payload = src.engine.kv.export_prefix(
                toks, self.handoff_quant)
        except ValueError:
            payload = None
        if payload is None:
            return False
        kv = dst.engine.kv
        try:
            slot = kv.import_blocks(payload, rid, prompt=list(toks))
        except ValueError:
            slot = None
        if slot is None:
            return False
        # the slot was only a write vehicle: the re-registered prefix
        # keeps the blocks alive (refcounted)
        kv.release(slot)
        self.handoffs += 1
        nbytes = int(payload["nbytes"])
        self.handoff_bytes += nbytes
        blocks = -(-int(payload["length"]) // int(payload["block"]))
        self._event("kv_handoff_out", request=rid, replica=src.index,
                    to_replica=dst.index, bytes=nbytes, blocks=blocks,
                    quant=payload["quant"] or "off")
        self._event("kv_handoff_in", request=rid, replica=dst.index,
                    from_replica=src.index, bytes=nbytes)
        return True

    def _warm_prefix_ok(self, rep):
        """Can this replica's engine take part in a prefix move?"""
        eng = rep.engine
        kv = getattr(eng, "kv", None) if eng is not None else None
        return kv is not None and getattr(kv, "prefix_share", False)

    def _warm_replica(self, rep, budget=None):
        """Prefix-warm a joining replica BEFORE it takes traffic:
        import its peers' hottest DIRECTORY-KNOWN prefixes (a prefix no
        directory entry names attracts no routed traffic — not worth
        the wire bytes).  Returns how many prefixes landed."""
        if budget is None:
            budget = envvars.get_int("HETU_AUTOSCALE_WARM_PREFIXES")
        if budget <= 0 or not self._warm_prefix_ok(rep):
            return 0
        block = rep.engine.kv.block
        cands = []
        for peer in self.replicas:
            if peer.index == rep.index or peer.state != UP \
                    or not self._warm_prefix_ok(peer) \
                    or peer.engine.kv.block != block:
                continue
            for toks, e in peer.engine.kv._prefix.items():
                if self.directory is not None \
                        and not self.directory.known(toks):
                    continue
                cands.append((-e.used, peer.index, toks))
        cands.sort()
        warmed = 0
        seen = set()
        for _hot, pidx, toks in cands:
            if warmed >= budget:
                break
            if toks in seen:
                continue
            seen.add(toks)
            peer = self.replicas[pidx]
            if peer.state != UP:
                continue
            rid = f"warm-r{rep.index}-{warmed}"
            if self._ship_prefix(peer, rep, toks, rid):
                warmed += 1
        return warmed

    def _export_hot_prefixes(self, rep, budget=None):
        """A retiring replica's warmth must not die with it: export its
        hottest directory-known prefixes to the best-scoring UP peer
        through the same codec warming uses.  Runs BEFORE the directory
        drop, so the peer registers as a holder while the entries that
        made these prefixes routable still exist.  A prefix no peer can
        take — no peer at all, or the best peer's pool has no room —
        SPILLS to the tier ladder instead of dying with the pool
        (pre-tier behavior dropped it outright).  Returns
        ``(exported, spilled)``."""
        if budget is None:
            budget = envvars.get_int("HETU_AUTOSCALE_WARM_PREFIXES")
        if budget <= 0 or not self._warm_prefix_ok(rep):
            return 0, 0
        kv = rep.engine.kv
        peers = [r for r in self.replicas
                 if r.index != rep.index and r.state == UP
                 and self._warm_prefix_ok(r)
                 and r.engine.kv.block == kv.block]
        hot = sorted(kv._prefix.items(), key=lambda kvp: -kvp[1].used)
        exported = spilled = 0
        for toks, _e in hot:
            if exported + spilled >= budget:
                break
            if self.directory is not None \
                    and not self.directory.known(toks):
                continue
            if peers:
                peer = max(peers,
                           key=lambda r: (self._score(r), -r.index))
                if toks in peer.engine.kv._prefix:
                    continue   # the best peer already holds it
                rid = f"retire-r{rep.index}-{exported}"
                if self._ship_prefix(rep, peer, toks, rid):
                    exported += 1
                    continue
            if self._spill_prefix(rep, toks):
                spilled += 1
        return exported, spilled

    def _spill_prefix(self, rep, toks):
        """Retire-path fallback: no peer could absorb this prefix —
        tier it (host ring / PS cold store) instead of letting it die
        with the retiring pool.  False when tiering is off or the
        ladder declined (today's drop)."""
        if self.kv_tiers is None:
            return False
        try:
            payload = rep.engine.kv.export_prefix(toks, count=False)
        except ValueError:
            payload = None
        if payload is None:
            return False
        return self.kv_tiers.spill(toks, payload, replica=rep.index)

    def _probe_replica(self, rep):
        """Half-open bring-up probe: one greedy decode must retire on
        the quiesced engine — on the committed weight version, when a
        coordinator is wired — before the replica takes fleet traffic.
        Embedding engines (no decode loop) admit on the version stamp
        alone."""
        eng = rep.engine
        if eng is None:
            return False
        if hasattr(eng, "tables"):
            return True
        self._scale_seq += 1
        rid = f"scale-probe-r{rep.index}-{self._scale_seq}"
        req = Request(prompt=[1, 2, 3], max_new_tokens=1,
                      temperature=0.0, request_id=rid, seed=0)
        try:
            res = eng.run([req]).get(rid)
        except Exception:  # noqa: BLE001 — a probe crash IS a failure
            res = None
        if res is None or res.n_generated < 1:
            return False
        if self.weight_sync is not None \
                and res.weight_version != self.weight_sync.committed_version:
            return False
        rep.last_beat = time.perf_counter()
        return True

    # ------------------------------------------------------------- #
    # failure handling
    # ------------------------------------------------------------- #

    def _on_death(self, r, now):
        """Drain a dead replica from the router's own records: every
        request it had not retired requeues onto peers (no loss), the
        breaker notes the failure, and the supervisor schedules the
        respawn (or goes terminal)."""
        self._breaker_failure(r.index, now)
        if self.directory is not None:
            # its pool died with it: every hint naming it is now a lie
            self.directory.drop_replica(r.index)
        assigned = self._assigned[r.index]
        lost = [rid for rid in assigned
                if not self._routed[rid].done]
        self._assigned[r.index] = {}
        for rid in lost:
            routed = self._routed[rid]
            routed.hops += 1
            routed.prev_replica = r.index
            routed.replica = None
            routed.next_at = 0.0
            self.requeued += 1
            telemetry.inc("router.requeues")
            self._pending.append(routed)
        r.drained = True
        self._fail_event("replica_drain", replica=r.index,
                         requeued=len(lost), rc=r.exit_code)
        r.schedule_restart(now)

    def _flush_pending(self, now):
        """Place router-held requests (requeued off corpses or backed
        off): deadline-expire, honor retry backoff, and give up —
        terminally, with a flight dump — only past the retry budget."""
        still = collections.deque()
        while self._pending:
            routed = self._pending.popleft()
            if routed.done:
                continue
            req = routed.request
            waited = now - routed.t_submit
            if req.deadline_s is not None and waited > req.deadline_s:
                routed.done = True
                self.expired += 1
                self._event("router_deadline", request=req.request_id,
                            waited_s=round(waited, 3),
                            deadline_s=req.deadline_s,
                            slo_class=req.slo_class)
                continue
            if now < routed.next_at:
                still.append(routed)
                continue
            if self._place(routed, now):
                continue
            routed.retries += 1
            if routed.retries > self.retry_limit:
                # router terminal failure for this request: budget
                # spent with nowhere to put it.  Record loudly.
                routed.done = True
                routed.lost = True
                self.lost += 1
                self._event("router_retry_exhausted",
                            request=req.request_id,
                            retries=routed.retries, hops=routed.hops)
                flight.RECORDER.dump("router_retry_exhausted",
                                     request=req.request_id,
                                     retries=routed.retries)
                continue
            routed.next_at = now + self.retry_backoff * 2 ** (
                routed.retries - 1)
            still.append(routed)
        self._pending = still

    def _finish(self, res, idx):
        """Bookkeeping for one retired Result; returns it, or None for
        a duplicate (a request must retire exactly once fleet-wide)."""
        routed = self._routed.get(res.request_id)
        if routed is None:
            return res           # not router-managed (direct submit)
        if routed.done:
            self.duplicates += 1
            return None
        if routed.phase == "prefill":
            # the one-token prefill clone retired (its KV export rode
            # the retire hook): the request is NOT finished — place the
            # real request, payload in hand, on a decode-heavy replica
            self._assigned[idx].pop(res.request_id, None)
            self._breaker_success(idx, res.request_id)
            routed.phase = "decode"
            now = time.perf_counter()
            if not self._place(routed, now):
                # decode side full right now: the retry loop owns it
                self._pending.append(routed)
            return None
        routed.done = True
        routed.result = res
        self._assigned[idx].pop(res.request_id, None)
        self.finished += 1
        now = time.perf_counter()
        self._lat.append(now - routed.t_submit)
        req = routed.request
        if req.first_token_at is not None:
            # fleet-clock TTFT: router submit -> first token, hops and
            # requeues included (the engine's ttft_s restarts per hop)
            ttft = req.first_token_at - routed.t_submit
            self._ttft.append(ttft)
            self._ttft_by_class[req.slo_class].append(ttft)
        self._breaker_success(idx, res.request_id)
        return res

    # ------------------------------------------------------------- #

    def snapshot(self):
        """JSON-able fleet view: routing/shedding/requeue counters,
        fleet-clock latency percentiles (per SLO class too), and a row
        per replica (state, health, load, breaker, restarts)."""
        pct = telemetry.percentile

        def _p(xs, q):
            v = pct(list(xs), q) if xs else None
            return round(v, 6) if v is not None else None

        classes = {}
        for cls, xs in self._ttft_by_class.items():
            classes[cls] = {
                "finished": len(xs),
                "shed": self.shed_by_class[cls],
                "ttft_p50_s": _p(xs, 50),
                "ttft_p95_s": _p(xs, 95),
                "ttft_p99_s": _p(xs, 99),
            }
        rows = []
        for r in self.replicas:
            row = r.snapshot()
            b = self._breaker[r.index]
            row["breaker"] = b["state"]
            row["breaker_opens"] = b["opens"]
            row["routed"] = self._placed[r.index]
            row["rejects"] = self._rejects[r.index]
            row["swap_hold"] = r.index in self._swap_hold
            rows.append(row)
        return {
            "replicas": rows,
            "health": self.health(),
            "queue_pressure": round(self.queue_pressure(), 4),
            "submitted": self.submitted,
            "finished": self.finished,
            "pending": self.pending,
            "shed": self.shed,
            "requeued": self.requeued,
            "expired": self.expired,
            "lost": self.lost,
            "duplicates": self.duplicates,
            # back-compat key: pre-directory dashboards read the
            # affinity remap count under this name
            "prefix_misses": self.affinity_prefix_misses,
            "affinity_prefix_misses": self.affinity_prefix_misses,
            "roles": list(self.roles),
            "directory": (self.directory.snapshot()
                          if self.directory is not None else None),
            "directory_killed": self.directory_killed,
            "directory_hit_rate": (
                round(self.directory.hit_rate, 4)
                if self.directory is not None else None),
            "handoffs": self.handoffs,
            "handoff_failed": self.handoff_failed,
            "handoffs_skipped": self.handoffs_skipped,
            "handoff_bytes": self.handoff_bytes,
            "kv_tiers": (self.kv_tiers.stats()
                         if self.kv_tiers is not None else None),
            "weight_sync": (self.weight_sync.snapshot()
                            if self.weight_sync is not None else None),
            "autoscaler": (self.autoscaler.snapshot()
                           if self.autoscaler is not None else None),
            "latency_p50_s": _p(self._lat, 50),
            "latency_p95_s": _p(self._lat, 95),
            "latency_p99_s": _p(self._lat, 99),
            "ttft_p50_s": _p(self._ttft, 50),
            "ttft_p95_s": _p(self._ttft, 95),
            "ttft_p99_s": _p(self._ttft, 99),
            "classes": classes,
        }
