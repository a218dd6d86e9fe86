"""Instrumented locks: the repo's one place threads may synchronize.

Every ``threading.Lock``/``RLock``/``Condition`` in the tree is
constructed HERE (lint rule ``raw-lock`` keeps it that way, the same
way ``env-registry`` keeps the env registry authoritative) as a
``TracedLock``/``TracedRLock``/``TracedCondition`` — API-compatible
wrappers that are plain pass-throughs by default and grow two
sanitizer personalities on demand:

- **Lockdep** (``HETU_LOCKDEP=1``): every acquisition records the
  per-thread held-lock stack into a global lock-ORDER graph keyed by
  lock class name (the string given at construction: ``ps.server``,
  ``cstable``, ...).  A cycle in that graph is a potential deadlock
  even if this run never interleaved into it — reported the moment the
  second edge lands, naming both lock classes and BOTH acquisition
  stacks, appended to :func:`lockdep_violations` and emitted as a
  contract-valid ``lockdep_violation`` telemetry event.  Lockdep also
  flags *blocking work under a lock* — call sites that may stall
  (PS RPC, big ``wire.dumps``) declare themselves via
  :func:`note_blocking` and are flagged when any traced lock is held —
  and feeds a per-lock-class hold-time histogram
  (``lock.hold_ms.<name>``) into the metrics registry;
  ``HETU_LOCKDEP_HOLD_MS > 0`` additionally reports any single hold
  longer than that many milliseconds.  Reentrant ``TracedRLock``
  re-acquires insert no self-edges.

- **Deterministic interleaving fuzz** (``HETU_SCHED_FUZZ=<seed>`` via
  ``analysis/concurrency.run_interleaved``): a seeded cooperative
  scheduler (:class:`InterleaveScheduler`) owns a single run token;
  only threads explicitly REGISTERED with it participate, and at every
  traced acquire/release (plus explicit ``sched_point()`` calls) the
  token holder lets a seeded ``random.Random`` pick the next runnable
  thread.  A blocking acquire under fuzz is a try-acquire loop that
  hands the token away on failure, so the schedule — and therefore any
  race it exposes — is a pure function of the seed: a race found on
  seed N reproduces on seed N, the ``HETU_CHAOS`` determinism model
  applied to thread schedules.  Unregistered threads and runs with the
  scheduler uninstalled take one ``is None`` check and nothing else.

Cost model when both are off (the default): one module-global ``None``
check for the fuzzer plus one env-registry read for lockdep per
acquire — the same guard discipline as ``telemetry.enabled()``, bounded
by the same kind of smoke-tier overhead test.
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from dataclasses import dataclass, field

from . import envvars

__all__ = [
    "TracedLock", "TracedRLock", "TracedCondition",
    "InterleaveScheduler", "install_scheduler", "current_scheduler",
    "sched_point", "note_blocking",
    "lockdep_enabled", "lockdep_reset", "lockdep_violations",
    "lockdep_edges", "format_violation",
]

# --------------------------------------------------------------------- #
# thread-local state
# --------------------------------------------------------------------- #

_TL = threading.local()


def _held():
    h = getattr(_TL, "held", None)
    if h is None:
        h = _TL.held = []
    return h


def _dep_on() -> bool:
    return envvars.get_bool("HETU_LOCKDEP")


def lockdep_enabled() -> bool:
    """True when ``HETU_LOCKDEP`` is set truthy (read per call — tests
    toggle it at runtime)."""
    return _dep_on()


# --------------------------------------------------------------------- #
# lockdep: global lock-order graph + violations
# --------------------------------------------------------------------- #

# raw internals: this module is the ONE place raw threading primitives
# are legal (lint rule raw-lock), and the sanitizer's own bookkeeping
# must not recurse into itself
_graph_mu = threading.Lock()
_EDGES: dict = {}        # (a_name, b_name) -> edge info (sites + stacks)
_ADJ: dict = {}          # a_name -> set of b_names
_REPORTED: set = set()   # dedupe keys for emitted violations
_VIOLATIONS: list = []   # violation dicts, append-only
_MAX_VIOLATIONS = 256


@dataclass
class _Held:
    """One live acquisition on some thread's held stack."""
    name: str
    site: str
    stack: str
    t0: float = field(default_factory=time.perf_counter)


def _capture(skip_hint="locks.py"):
    """(site, stack): innermost non-locks.py frame + formatted stack."""
    frames = traceback.extract_stack(limit=24)
    site = "<unknown>"
    for fr in reversed(frames):
        if skip_hint not in fr.filename:
            site = f"{fr.filename}:{fr.lineno} in {fr.name}"
            break
    text = "".join(traceback.format_list(
        [fr for fr in frames if skip_hint not in fr.filename][-8:]))
    return site, text


def _find_path(src, dst):
    """DFS: a list of lock names src -> ... -> dst, or None."""
    stack, seen = [(src, [src])], {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _ADJ.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def format_violation(v) -> str:
    """GraphVerifyError-style multi-line diagnostic for one violation."""
    lines = [f"lockdep [{v['kind']}] lock {v['lock']!r}"
             + (f" vs {v['other']!r}" if v.get("other") else "")
             + f": {v['msg']}"]
    for label, stk in v.get("stacks", ()):
        lines.append(f"  {label}:")
        lines.extend("    " + ln for ln in stk.rstrip().splitlines())
    return "\n".join(lines)


def _report(kind, lock, other=None, msg="", stacks=(), site=""):
    """Record one violation + emit the contract event.  Runs with the
    thread-local ``busy`` flag set so the sink/metrics locks it touches
    behave as plain locks (no sanitizer recursion)."""
    if len(_VIOLATIONS) >= _MAX_VIOLATIONS:
        return
    v = {"kind": kind, "lock": lock, "other": other, "msg": msg,
         "stacks": tuple(stacks), "site": site}
    _VIOLATIONS.append(v)
    prev, _TL.busy = getattr(_TL, "busy", False), True
    try:
        from .telemetry import events as _events
        _events.emit("lockdep_violation", _stream="validate",
                     kind=kind, lock=lock, other=other, site=site,
                     msg=msg)
    except Exception:
        pass
    finally:
        _TL.busy = prev


def _edge(held_rec, name, site, stack):
    """Insert the order edge held_rec.name -> name; report a cycle."""
    key = (held_rec.name, name)
    viol = None
    with _graph_mu:
        if key not in _EDGES:
            _EDGES[key] = {"a_site": held_rec.site, "b_site": site,
                           "a_stack": held_rec.stack, "b_stack": stack}
            _ADJ.setdefault(held_rec.name, set()).add(name)
            path = _find_path(name, held_rec.name)
            if path:
                cyc = tuple(sorted((held_rec.name, name)))
                if cyc not in _REPORTED:
                    _REPORTED.add(cyc)
                    rev = _EDGES.get((path[0], path[1]), {})
                    viol = {
                        "other": name,
                        "msg": (f"lock-order inversion: "
                                f"{held_rec.name!r} -> {name!r} here, "
                                f"but {' -> '.join(repr(p) for p in path)}"
                                f" was established earlier — the two "
                                f"orders can deadlock"),
                        "stacks": (
                            (f"{held_rec.name!r} acquired at "
                             f"{held_rec.site}", held_rec.stack),
                            (f"{name!r} acquired at {site}", stack),
                            (f"reverse edge {path[0]!r} -> {path[1]!r} "
                             f"acquired at {rev.get('b_site', '?')}",
                             rev.get("b_stack", "")),
                        ),
                        "site": site,
                    }
    if viol is not None:
        _report("order", held_rec.name, **viol)


def _on_acquired(name):
    """First (non-reentrant) acquisition bookkeeping; returns the
    held-stack record, or None when the sanitizer is busy/off."""
    if getattr(_TL, "busy", False):
        return None
    site, stack = _capture()
    rec = _Held(name, site, stack)
    for h in _held():
        if h.name != name:
            _edge(h, name, site, stack)
    _held().append(rec)
    return rec


def _drop_held(rec):
    try:
        _held().remove(rec)
    except ValueError:
        pass


def _hold_metrics(rec):
    """Post-release hold-time accounting (lock already released)."""
    dt_ms = (time.perf_counter() - rec.t0) * 1e3
    prev, _TL.busy = getattr(_TL, "busy", False), True
    try:
        from .telemetry.metrics import REGISTRY
        REGISTRY.histogram("lock.hold_ms." + rec.name).observe(dt_ms)
    except Exception:
        pass
    finally:
        _TL.busy = prev
    thresh = envvars.get_float("HETU_LOCKDEP_HOLD_MS")
    if thresh and dt_ms > thresh:
        _report("long_hold", rec.name, site=rec.site,
                msg=f"held {dt_ms:.2f} ms (> HETU_LOCKDEP_HOLD_MS="
                    f"{thresh:g})",
                stacks=((f"{rec.name!r} acquired at {rec.site}",
                         rec.stack),))


def note_blocking(op, **info):
    """Declare that the caller is about to do work that can BLOCK
    (a PS RPC, a big wire encode, a jit dispatch, a sleep).  Under
    lockdep, doing so while holding any traced lock is a
    ``held_across`` violation naming the lock's acquisition stack and
    the blocking site — the latency/deadlock smell the hold-time
    histogram only shows after the fact."""
    if not _dep_on() or getattr(_TL, "busy", False):
        return
    held = getattr(_TL, "held", None)
    if not held:
        return
    h = held[-1]
    site, stack = _capture()
    key = ("held_across", op, h.name, h.site)
    with _graph_mu:
        if key in _REPORTED:
            return
        _REPORTED.add(key)
    extra = ", ".join(f"{k}={v}" for k, v in info.items())
    _report("held_across", h.name, other=op, site=site,
            msg=f"blocking op {op!r}{' (' + extra + ')' if extra else ''}"
                f" while holding {h.name!r} — the lock's critical "
                f"section now includes an unbounded wait",
            stacks=((f"{h.name!r} acquired at {h.site}", h.stack),
                    (f"blocking {op!r} at {site}", stack)))


def lockdep_violations() -> list:
    """All violations recorded since the last :func:`lockdep_reset`."""
    return list(_VIOLATIONS)


def lockdep_edges() -> dict:
    """Snapshot of the lock-order graph {(a, b): {a_site, b_site}}."""
    with _graph_mu:
        return {k: {"a_site": v["a_site"], "b_site": v["b_site"]}
                for k, v in _EDGES.items()}


def lockdep_reset():
    """Clear the order graph + violations (test isolation)."""
    global _VIOLATIONS
    with _graph_mu:
        _EDGES.clear()
        _ADJ.clear()
        _REPORTED.clear()
        _VIOLATIONS = []


# --------------------------------------------------------------------- #
# deterministic interleaving scheduler (HETU_SCHED_FUZZ)
# --------------------------------------------------------------------- #

class InterleaveScheduler:
    """Seeded cooperative scheduler: one run token, rng-picked handoff.

    Threads participate only after :meth:`register` (done by
    ``analysis/concurrency.run_interleaved``'s thread wrapper, keyed by
    a deterministic per-thread index — NOT the OS ident, so the
    schedule is a pure function of the seed).  All registrants rally at
    a start barrier (``expect(n)``) before the first pick, which makes
    thread start-order irrelevant.  ``yield_point()`` offers the token
    to an rng-picked runnable thread (possibly self); ``yield_to_other``
    is the blocked-acquire variant that must hand it away;
    ``detach``/``reattach`` bracket real blocking waits (condvars) so a
    waiter never wedges the token.  Lock/condvar waits in HERE are raw
    by design — the sanitizer's machinery cannot run under itself."""

    def __init__(self, seed, expected=0, max_wait=30.0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._cv = threading.Condition(threading.Lock())
        self._expected = int(expected)
        self._threads = {}     # OS ident -> index
        self._runnable = {}    # index -> ident
        self._current = None
        self._started = False
        self._max_wait = float(max_wait)

    # -- internals (call with self._cv held) ------------------------- #

    def _pick(self, exclude=None):
        """rng-pick among runnable threads (minus ``exclude``); the
        caller decides whether self is a legal choice by excluding."""
        choices = sorted(i for i in self._runnable if i != exclude)
        if not choices:
            return None
        return self._rng.choice(choices)

    def _wait_for_token(self, index):
        deadline = time.monotonic() + self._max_wait
        while self._current != index:
            if index not in self._runnable:
                return      # detached/unregistered concurrently
            self._cv.wait(0.5)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"interleave fuzz seed={self.seed}: thread "
                    f"{index} starved {self._max_wait}s waiting for "
                    f"the token (deadlock in the code under test?)")

    # -- registration ------------------------------------------------ #

    def expect(self, n):
        with self._cv:
            self._expected = int(n)

    def register(self, index):
        me = threading.get_ident()
        with self._cv:
            self._threads[me] = index
            self._runnable[index] = me
            if not self._started \
                    and len(self._runnable) >= self._expected:
                self._started = True
                self._current = self._pick()
                self._cv.notify_all()
            deadline = time.monotonic() + self._max_wait
            while not self._started or self._current != index:
                self._cv.wait(0.5)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"interleave fuzz seed={self.seed}: start "
                        f"barrier starved (expected="
                        f"{self._expected}, registered="
                        f"{len(self._runnable)})")
        _TL.fuzz = self

    def unregister(self):
        me = threading.get_ident()
        with self._cv:
            idx = self._threads.pop(me, None)
            self._runnable.pop(idx, None)
            if self._current == idx:
                self._current = self._pick()
                self._cv.notify_all()
        _TL.fuzz = None

    # -- scheduling points ------------------------------------------- #

    def _my_index(self):
        return self._threads.get(threading.get_ident())

    def yield_point(self):
        """Offer the token to an rng-picked runnable thread."""
        with self._cv:
            idx = self._my_index()
            if idx is None or self._current != idx:
                return
            nxt = self._pick()
            if nxt != idx:
                self._current = nxt
                self._cv.notify_all()
                self._wait_for_token(idx)

    def yield_to_other(self) -> bool:
        """Hand the token to some OTHER runnable thread; False when
        this thread is the only runnable one."""
        with self._cv:
            idx = self._my_index()
            if idx is None or self._current != idx:
                return False
            nxt = self._pick(exclude=idx)
            if nxt is None or nxt == idx:
                return False
            self._current = nxt
            self._cv.notify_all()
            self._wait_for_token(idx)
            return True

    def detach(self):
        """Leave the runnable set before a REAL blocking wait."""
        with self._cv:
            idx = self._my_index()
            if idx is None:
                return
            self._runnable.pop(idx, None)
            if self._current == idx:
                self._current = self._pick()
                self._cv.notify_all()

    def reattach(self):
        """Rejoin the runnable set after a real wait; blocks until the
        token comes around."""
        with self._cv:
            idx = self._my_index()
            if idx is None:
                return
            self._runnable[idx] = threading.get_ident()
            if self._current is None:
                self._current = idx
            self._cv.notify_all()
            self._wait_for_token(idx)


_SCHED: InterleaveScheduler | None = None


def install_scheduler(sched):
    """Install (or, with None, remove) the process-wide fuzz
    scheduler.  ``analysis/concurrency.run_interleaved`` owns this."""
    global _SCHED
    _SCHED = sched


def current_scheduler():
    return _SCHED


def _sched():
    """The scheduler IF this thread is registered with it, else None —
    the one check unregistered threads pay under fuzz."""
    s = _SCHED
    if s is None:
        return None
    return s if getattr(_TL, "fuzz", None) is s else None


def sched_point():
    """Explicit preemption point for fuzzed code paths (FakeComm seams,
    hammer-test bodies).  No-op unless this thread is registered with
    an installed scheduler."""
    s = _sched()
    if s is not None:
        s.yield_point()


def _fuzz_acquire(inner, sched, blocking, timeout):
    """Token-safe acquire: never block the OS thread while holding the
    token — try, hand the token away on failure, retry."""
    sched.yield_point()
    if inner.acquire(False):
        return True
    if not blocking:
        return False
    deadline = None if timeout is None or timeout < 0 \
        else time.monotonic() + timeout
    spins = 0
    while True:
        if not sched.yield_to_other():
            # lock held by an unregistered thread (or a bug): spin
            # politely off-token rather than wedging the schedule
            time.sleep(0.0005)
            spins += 1
            if spins > 20000:
                raise RuntimeError(
                    f"interleave fuzz seed={sched.seed}: acquire "
                    f"starved with no other runnable thread")
        if inner.acquire(False):
            return True
        if deadline is not None and time.monotonic() >= deadline:
            return False


# --------------------------------------------------------------------- #
# the wrappers
# --------------------------------------------------------------------- #

def _inner_acquire(inner, blocking, timeout):
    if timeout is None or timeout < 0:
        return inner.acquire(blocking)
    return inner.acquire(blocking, timeout)


class TracedLock:
    """Drop-in ``threading.Lock`` with the lockdep/fuzz personalities.

    ``name`` is the LOCK CLASS (shared by every instance guarding the
    same kind of state — all ``_Param`` locks are ``"ps.param"``): the
    lock-order graph, hold histograms, and diagnostics are keyed by it.
    """

    __slots__ = ("_inner", "_name", "_rec")

    def __init__(self, name="lock"):
        self._inner = threading.Lock()
        self._name = str(name)
        self._rec = None

    @property
    def name(self):
        return self._name

    def acquire(self, blocking=True, timeout=-1):
        s = _sched()
        if s is not None:
            ok = _fuzz_acquire(self._inner, s, blocking, timeout)
        else:
            ok = _inner_acquire(self._inner, blocking, timeout)
        if ok and _dep_on():
            self._rec = _on_acquired(self._name)
        return ok

    def release(self):
        rec, self._rec = self._rec, None
        if rec is not None:
            _drop_held(rec)
        self._inner.release()
        if rec is not None:
            _hold_metrics(rec)
        s = _sched()
        if s is not None:
            s.yield_point()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self):
        return f"<TracedLock {self._name!r} at {id(self):#x}>"

    # condvar-wait plumbing (TracedCondition suspends the holder's
    # bookkeeping around the real wait)
    def _suspend(self):
        rec, self._rec = self._rec, None
        if rec is not None:
            _drop_held(rec)
        return rec

    def _resume(self, rec):
        if rec is not None:
            rec.t0 = time.perf_counter()
            _held().append(rec)
            self._rec = rec


def _rl_recs():
    r = getattr(_TL, "rl_recs", None)
    if r is None:
        r = _TL.rl_recs = {}
    return r


class TracedRLock:
    """Drop-in ``threading.RLock``: reentrant re-acquires are counted
    per thread and insert NO order edges (a lock class never conflicts
    with itself through recursion)."""

    __slots__ = ("_inner", "_name")

    def __init__(self, name="rlock"):
        self._inner = threading.RLock()
        self._name = str(name)

    @property
    def name(self):
        return self._name

    def acquire(self, blocking=True, timeout=-1):
        s = _sched()
        if s is not None:
            ok = _fuzz_acquire(self._inner, s, blocking, timeout)
        else:
            ok = _inner_acquire(self._inner, blocking, timeout)
        if ok and _dep_on():
            recs = _rl_recs()
            ent = recs.get(id(self))
            if ent is None:
                rec = _on_acquired(self._name)
                if rec is not None:
                    recs[id(self)] = [rec, 1]
            else:
                ent[1] += 1
        return ok

    def release(self):
        recs = getattr(_TL, "rl_recs", None)
        ent = recs.get(id(self)) if recs else None
        rec = None
        if ent is not None:
            ent[1] -= 1
            if ent[1] <= 0:
                rec = ent[0]
                del recs[id(self)]
                _drop_held(rec)
        self._inner.release()
        if rec is not None:
            _hold_metrics(rec)
        s = _sched()
        if s is not None:
            s.yield_point()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self):
        return f"<TracedRLock {self._name!r} at {id(self):#x}>"

    def _is_owned(self):
        return self._inner._is_owned()

    def _suspend(self):
        recs = getattr(_TL, "rl_recs", None)
        ent = recs.pop(id(self), None) if recs else None
        if ent is not None:
            _drop_held(ent[0])
        return ent

    def _resume(self, ent):
        if ent is not None:
            ent[0].t0 = time.perf_counter()
            _held().append(ent[0])
            _rl_recs()[id(self)] = ent


class TracedCondition:
    """Drop-in ``threading.Condition`` over a traced lock.

    The inner ``threading.Condition`` is built on the traced lock's RAW
    lock, so wait/notify semantics (including RLock ``_release_save``)
    are stdlib-exact; the wrapper keeps the sanitizer's held-stack and
    hold-window honest across the wait, and detaches from the fuzz
    token while really blocked so a waiter never wedges the schedule.
    """

    __slots__ = ("_tlock", "_cv", "_name")

    def __init__(self, lock=None, name="cv"):
        if lock is None:
            lock = TracedRLock(name=str(name))
        self._tlock = lock
        self._name = str(name)
        self._cv = threading.Condition(lock._inner)

    @property
    def name(self):
        return self._name

    @property
    def lock(self):
        return self._tlock

    def acquire(self, *args, **kw):
        return self._tlock.acquire(*args, **kw)

    def release(self):
        self._tlock.release()

    def __enter__(self):
        self._tlock.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tlock.release()
        return False

    def wait(self, timeout=None):
        state = self._tlock._suspend()
        s = _sched()
        if s is not None:
            s.detach()
        try:
            return self._cv.wait(timeout)
        finally:
            if s is not None:
                s.reattach()
            self._tlock._resume(state)

    def wait_for(self, predicate, timeout=None):
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n=1):
        self._cv.notify(n)

    def notify_all(self):
        self._cv.notify_all()

    def __repr__(self):
        return f"<TracedCondition {self._name!r} at {id(self):#x}>"
