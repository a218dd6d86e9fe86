"""Deterministic fault injection for the PS transports (chaos harness).

Every PS tier (PSClient, ShardedPSClient, CacheSparseTable, the van
fallback path) funnels its python-wire RPCs through ``_TCPTransport.call``
or ``_LocalTransport.call`` (ps/client.py), so injecting at that seam
faults the whole stack with zero call-site changes.  Activation is via
the ``HETU_CHAOS`` env var so launcher-spawned server and worker
processes inherit the plan; ``HETU_CHAOS_ROLE`` scopes a plan to one
role (the launcher stamps ``server:<idx>`` / ``worker:<rank>``).

Spec grammar (comma-separated ``k=v``)::

    seed=<int>        decision-stream seed (default 0)
    drop=<p>          P[request lost BEFORE the server sees it]
    dup=<p>           P[response lost AFTER the server applied it] — the
                      client retries, so the server receives a DUPLICATE;
                      the replay cache must suppress re-application
    reorder=<p>       alias of dup (a delayed-then-retransmitted request
                      arrives behind its successor; same observable:
                      a duplicate seq at the server)
    reset=<p>         P[connection reset before the call]
    delay=<p>:<s>     P[<s> seconds of extra latency before the call]
    slow=<p>:<s>      P[<s> seconds of server slowness after applying]
    kill=<n>          one-shot SIGKILL of THIS process at the n-th
                      evaluated event (1-based; the chaos test's
                      mid-training shard kill).  A seam drawing with
                      ``inline=True`` (the serving replica harness)
                      gets ``Fault("kill")`` back instead of the
                      process-wide SIGKILL and handles the death itself
    wedge=<n>         one-shot WEDGE at the n-th evaluated event: the
                      victim stays alive but stops making progress (and
                      stops heartbeating) — the mid-run hang class of
                      failure.  Only fires at seams that opt in via
                      ``kinds`` containing "wedge" (the serving replica
                      step seam); transports never draw it
    role=<name>       plan active only when HETU_CHAOS_ROLE == name
                      (prefix match: role=server matches server:0).
                      Seams hosting several roles in ONE process (the
                      router's replica fleet) pass their role to
                      ``draw(role=...)`` explicitly, overriding the env.
                      ``role=swap`` scopes a plan to the live-weight-
                      sync seams (serving/weight_sync.py): the
                      coordinator draws at ``swap.version_push``
                      (kinds drop/reset = a corrupt/stale version read,
                      rejecting the rollout), then per replica at
                      ``swap.drain`` (kill mid-drain) and
                      ``swap.apply`` (kill after the buffers moved,
                      before the probe) — ``kill=<n>`` picks the seam
                      by draw position.
                      ``role=autoscale`` scopes a plan to the elastic-
                      fleet seams (serving/router.py): the router draws
                      at ``autoscale.scale_up`` (kill the busiest PEER
                      while a new replica is mid-bring-up) and
                      ``autoscale.drain`` (kill the RETIRING replica
                      itself mid-drain) — both must lose zero requests;
                      ``kill=<n>`` picks the seam by draw position, as
                      with role=swap

Determinism: decision ``i`` is a pure function of ``(seed, i)`` (a
blake2 hash, not an RNG object), so a spec replays the identical fault
sequence for a serial caller regardless of wall clock or prior library
RNG use.  The event counter is per-plan (per-process); concurrent
callers interleave counter draws nondeterministically, so equivalence
tests drive a single thread.

Example::

    HETU_CHAOS="seed=7,drop=0.1,dup=0.1,delay=0.05:0.02" python train.py
"""

from __future__ import annotations

import hashlib
import os
import signal
import struct
import threading


def _restart_count():
    """Supervisor incarnation index (0 = first run of this process)."""
    from .. import envvars
    return envvars.get_int("HETU_RESTART_COUNT")


class InjectedFault(ConnectionError):
    """A chaos-injected transport failure (subclass of ConnectionError so
    the client's existing retry machinery treats it like the real
    thing)."""


class Fault:
    """One drawn event: ``kind`` in {none, drop, dup, reset, delay, slow,
    kill, wedge} plus the latency for the timed kinds."""

    __slots__ = ("kind", "seconds")

    def __init__(self, kind, seconds=0.0):
        self.kind = kind
        self.seconds = seconds

    def __repr__(self):
        return (f"Fault({self.kind!r}"
                + (f", {self.seconds}s" if self.seconds else "") + ")")


def _u01(seed, n):
    """Deterministic uniform in [0, 1): hash of (seed, n) — stable across
    processes, platforms, and interpreter restarts."""
    h = hashlib.blake2b(b"%d:%d" % (seed, n), digest_size=8).digest()
    return struct.unpack("<Q", h)[0] / 2.0 ** 64


class FaultPlan:
    def __init__(self, seed=0, drop=0.0, dup=0.0, reset=0.0,
                 delay=(0.0, 0.0), slow=(0.0, 0.0), kill=None, wedge=None,
                 role=None):
        self.seed = int(seed)
        self.drop = float(drop)
        self.dup = float(dup)
        self.reset = float(reset)
        self.delay = (float(delay[0]), float(delay[1]))
        self.slow = (float(slow[0]), float(slow[1]))
        self.kill = None if kill is None else int(kill)
        self.wedge = None if wedge is None else int(wedge)
        self.role = role
        self._n = 0
        from .. import locks
        self._mu = locks.TracedLock("chaos.plan")
        # observability: how often each kind actually fired
        self.fired = {k: 0 for k in
                      ("drop", "dup", "reset", "delay", "slow", "kill",
                       "wedge")}

    # ---------------- spec parsing ---------------- #

    @classmethod
    def from_spec(cls, spec):
        """Parse the HETU_CHAOS grammar (see module docstring)."""
        kw = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"chaos spec item {part!r} is not k=v")
            k, v = part.split("=", 1)
            k = k.strip()
            v = v.strip()
            if k in ("seed", "kill", "wedge"):
                kw[k] = int(v)
            elif k in ("drop", "dup", "reorder", "reset"):
                key = "dup" if k == "reorder" else k
                kw[key] = kw.get(key, 0.0) + float(v)
            elif k in ("delay", "slow"):
                p, _, s = v.partition(":")
                kw[k] = (float(p), float(s or "0.01"))
            elif k == "role":
                kw[k] = v
            else:
                raise ValueError(f"unknown chaos spec key {k!r}")
        return cls(**kw)

    def active(self, role=None):
        """Role gate: a role-scoped plan only fires in matching
        processes (HETU_CHAOS_ROLE, prefix match).  ``role`` overrides
        the env lookup for seams hosting several roles in one process
        (the router's replica fleet stamps ``replica<k>``)."""
        if self.role is None:
            return True
        if role is not None:
            return str(role).startswith(self.role)
        from .. import envvars
        return envvars.get_str("HETU_CHAOS_ROLE").startswith(self.role)

    # ---------------- the decision stream ---------------- #

    def draw(self, method=None, kinds=None, role=None, inline=False):
        """Consume one decision and return the Fault for it.  ``kinds``
        restricts which kinds may fire at this seam (the counter always
        advances, so restricted and unrestricted callers share one
        deterministic stream).  A ``kill`` event SIGKILLs this process
        and does not return — unless ``inline`` is set, in which case
        ``Fault("kill")`` is returned and the caller owns the death
        (the serving replica harness, where a fleet of roles shares one
        process and a SIGKILL would take out the survivors too).
        ``role`` overrides the env role for the gate (see ``active``);
        a non-matching role never advances the counter, so each
        replica's step stream is independently deterministic."""
        if not self.active(role):
            return Fault("none")
        with self._mu:
            self._n += 1
            n = self._n
        if self.kill is not None and n == self.kill and \
                (kinds is None or "kill" in kinds) and \
                _restart_count() == 0:
            # one-shot across RESTARTS too: a supervisor-respawned
            # incarnation (HETU_RESTART_COUNT > 0) must not re-fire the
            # kill, or recovery could never be observed
            self.fired["kill"] += 1
            if inline:
                return Fault("kill")
            try:
                # the kill's black box: dump the flight ring BEFORE the
                # SIGKILL (the process gets no other chance) — a failed
                # dump must never save the victim
                from ..telemetry.flight import RECORDER
                RECORDER.dump("chaos_kill", chaos_event=n,
                              method=str(method))
            except Exception:  # noqa: BLE001
                pass
            os.kill(os.getpid(), signal.SIGKILL)
        if self.wedge is not None and n == self.wedge and \
                kinds is not None and "wedge" in kinds:
            # wedges only fire at seams that can act them out (the
            # replica step loop); transports draw without "wedge" and
            # simply consume the position
            self.fired["wedge"] += 1
            return Fault("wedge")
        u = _u01(self.seed, n)
        edge = 0.0
        for kind, p, secs in (("drop", self.drop, 0.0),
                              ("dup", self.dup, 0.0),
                              ("reset", self.reset, 0.0),
                              ("delay", self.delay[0], self.delay[1]),
                              ("slow", self.slow[0], self.slow[1])):
            edge += p
            if u < edge:
                if kinds is not None and kind not in kinds:
                    return Fault("none")
                self.fired[kind] += 1
                return Fault(kind, secs)
        return Fault("none")


# ---------------- env activation ---------------- #

_plans = {}


def _make_plans_mu():
    from .. import locks
    return locks.TracedLock("chaos.plans")


_plans_mu = _make_plans_mu()


def plan_from_env():
    """The process-wide FaultPlan for the current HETU_CHAOS value, or
    None when chaos is off.  Cached per spec string so the decision
    counter persists across transports/calls; re-reading the env every
    call keeps test toggling cheap and race-free."""
    from .. import envvars
    spec = envvars.get_str("HETU_CHAOS")
    if not spec:
        return None
    with _plans_mu:
        plan = _plans.get(spec)
        if plan is None:
            plan = _plans[spec] = FaultPlan.from_spec(spec)
    return plan


def reset_plans():
    """Forget cached plans (test isolation: a reused spec string starts
    a fresh decision stream)."""
    with _plans_mu:
        _plans.clear()
