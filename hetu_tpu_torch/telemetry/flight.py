"""Chaos flight recorder: the last N telemetry records, always.

Post-mortem debugging of a killed or wedged process needs the records
*leading up to* the fault, but the merged JSONL log is opt-in
(``$HETU_TELEMETRY_LOG``) and a SIGKILL'd process never gets to flush a
buffering writer.  The flight recorder closes that gap the way an
aircraft FDR does: every record that flows through the one event
pipeline (``events.TelemetrySink.emit``) is ALSO appended to a bounded
in-memory ring — one locked deque append, always on, cheap even under
``HETU_TELEMETRY=0`` (explicit failure/serve/validate events still flow
through ``emit()`` with telemetry off; only spans/metrics go quiet) —
and ``dump()`` writes the ring to ``$HETU_FLIGHT_LOG`` as contract-shaped
JSONL the moment something goes wrong.

Dump triggers wired across the repo:

- serving engine: an exception escaping ``ServingEngine.step`` and a
  QueueFull storm (sustained admission rejection);
- chaos harness: ``ps/faults.py`` dumps synchronously BEFORE a
  ``kill=`` event SIGKILLs the process (the dump is the kill's black
  box);
- PS client: retry exhaustion (``PSConnectionError`` — the reset/drop
  storm surface);
- launcher: terminal supervisor events (worker budget spent, PS server
  dead).

The dump file is append-mode JSONL: a ``flight_dump`` header record
(``reason`` + record count) followed by the ring's records, oldest
first — so repeated dumps into one file read as consecutive incidents
and ``bin/hetu_trace.py`` can merge/validate the file like any other
stream.  With ``$HETU_FLIGHT_LOG`` unset, ``dump()`` is a no-op
returning None: recording is always on, persistence is opt-in.
"""

from __future__ import annotations

import collections
import json
import os
import time

from .. import envvars, locks


class FlightRecorder:
    """Bounded ring of recent contract-shaped records + dump-to-JSONL.

    ``record()`` is the hot path — one lock acquire + one deque append,
    no env read.  The lock is NOT optional: ``list(deque)`` raises
    ``RuntimeError: deque mutated during iteration`` when another
    thread appends mid-snapshot, so the old lock-free append could
    break ``dump()`` at exactly the moment it matters (a dying process
    snapshotting its black box under emit load) and lose the in-flight
    record.  Under the lock, a dump is an exact point-in-time snapshot.
    ``dump()`` is the cold path: snapshot under the lock, then write
    header + records with an fsync OUTSIDE it, because the usual caller
    is about to die (chaos kill) or raise."""

    def __init__(self, depth=None):
        self._lock = locks.TracedLock("telemetry.flight")
        self._ring = collections.deque(
            maxlen=max(1, depth or envvars.get_int("HETU_FLIGHT_DEPTH")))
        self.dumps = 0

    def record(self, rec):
        with self._lock:
            self._ring.append(rec)

    def extend(self, recs):
        with self._lock:
            self._ring.extend(recs)

    def recent(self):
        with self._lock:
            return list(self._ring)

    def __len__(self):
        return len(self._ring)

    def dump(self, reason, path=None, **fields):
        """Write a ``flight_dump`` header + the ring to ``path`` (or
        ``$HETU_FLIGHT_LOG``); returns the path, or None when no sink is
        configured or the write fails (a dying process must never die
        HARDER because its black box was unwritable)."""
        path = path or envvars.get_path("HETU_FLIGHT_LOG")
        if not path:
            return None
        recs = self.recent()
        header = {"t": round(time.time(), 3), "event": "flight_dump",
                  "reason": str(reason), "records": len(recs),
                  "pid": os.getpid(), **fields}
        try:
            with open(path, "a") as f:
                f.write(json.dumps(header, default=str) + "\n")
                for rec in recs:
                    f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())   # SIGKILL may follow immediately
        except (OSError, ValueError):
            return None
        self.dumps += 1
        return path

    def reset(self):
        """Re-create the ring at the current env depth (test isolation)."""
        with self._lock:
            self._ring = collections.deque(
                maxlen=max(1, envvars.get_int("HETU_FLIGHT_DEPTH")))
            self.dumps = 0


# the process-wide recorder events.TelemetrySink feeds
RECORDER = FlightRecorder()


def dump(reason, path=None, **fields):
    """Module-level dump of the process-wide ring."""
    return RECORDER.dump(reason, path=path, **fields)
