"""Process-wide metrics registry: thread-safe counters/gauges/histograms.

The reference ships per-subsystem counters (HetuProfiler per-op tables,
cstable perf counters, NCCLProfiler) that each invent their own storage
and read path; here every layer records into ONE registry that
``telemetry.snapshot()`` serializes for tests, the suite's trace stage,
and the bench artifacts.  Metrics are named with dotted paths
(``ps.rpc.retries``, ``cache.hits``) plus an optional ``[tag]`` suffix
for low-cardinality breakdowns (``ps.rpc.calls[host:port]``).

Cost model: one ``locks.TracedLock`` per metric (plain pass-through
unless the lockdep sanitizer is on), plain python arithmetic
under it — ~1 µs per record, invisible next to a training step.  The
hot-path guard lives one level up (``telemetry.enabled()``): when
``HETU_TELEMETRY=0`` the instrumented call sites skip the registry
entirely, which is what keeps the disabled overhead near zero.

Histograms keep running count/sum/min/max plus a bounded reservoir of
the most recent samples (default 512) for percentiles — enough for the
p50/p99 the serving and PS layers report without unbounded memory on a
million-step run.
"""

from __future__ import annotations

import collections

from .. import locks

_RESERVOIR = 512


def percentile(xs, q):
    """THE repo percentile: linear interpolation between closest ranks
    (numpy's default method), pure python, None on empty input.

    Before this helper the repo had two disagreeing implementations —
    nearest-rank here in ``Histogram`` and ``np.percentile`` in
    ``serving/metrics.py`` — whose p99s diverged visibly on the small
    reservoirs serving actually has.  Both now call this one; accepts
    any sequence (sorts a copy, so pre-sorted callers pay one no-op
    pass)."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    pos = float(q) / 100.0 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Counter:
    """Monotonic int counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._lock = locks.TracedLock("metrics.counter")

    def inc(self, n=1):
        with self._lock:
            self.value += n
        return self

    def get(self):
        return self.value


class Gauge:
    """Last-write-wins scalar (queue depth, ring fill, live slots)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = None
        self._lock = locks.TracedLock("metrics.gauge")

    def set(self, v):
        with self._lock:
            self.value = v
        return self

    def get(self):
        return self.value


class Histogram:
    """Running stats + bounded reservoir of recent samples."""

    __slots__ = ("name", "count", "total", "min", "max", "_recent",
                 "_lock")

    def __init__(self, name, reservoir=_RESERVOIR):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._recent = collections.deque(maxlen=reservoir)
        self._lock = locks.TracedLock("metrics.hist")

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._recent.append(v)
        return self

    def summary(self):
        with self._lock:
            recent = sorted(self._recent)
            count, total = self.count, self.total
            mn, mx = self.min, self.max
        return {
            "count": count,
            "sum": round(total, 6),
            "min": mn,
            "max": mx,
            "mean": round(total / count, 6) if count else None,
            "p50": percentile(recent, 50),
            "p95": percentile(recent, 95),
            "p99": percentile(recent, 99),
        }


class MetricsRegistry:
    """Name -> metric, created on first touch (prometheus-client style:
    call sites never pre-register, a typo makes a new metric rather than
    a crash on the hot path)."""

    def __init__(self):
        self._lock = locks.TracedLock("metrics.registry")
        self._metrics = {}

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name))
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, asked for {cls.__name__}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self):
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.get()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.get()
            else:
                out["histograms"][name] = m.summary()
        return out

    def reset(self):
        with self._lock:
            self._metrics.clear()


# the process-wide registry every layer records into
REGISTRY = MetricsRegistry()
