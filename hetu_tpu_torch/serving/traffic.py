"""Seeded fleet traffic generator: diurnal load, zipf sessions, flash
crowds, mixed SLO classes — the "millions of users" trace the elastic
fleet is sized against.

A production fleet is never offered a flat request rate.  The shape
that matters for autoscaling is the DIURNAL curve (a daily peak/trough
swing, here one raised cosine per ``cycle_s``), punctuated by FLASH
CROWDS (a multiplier window landing with no warning) and skewed by
session popularity (a zipf over session ids: a few hot tenants produce
most of the traffic, so their shared system-prompt prefixes dominate
the prefix-cache economy).  :class:`TrafficGenerator` renders that
shape into a replayable list of :class:`TrafficSpec` rows — every draw
comes from one ``numpy.random.RandomState(seed)``, so the same seed
always yields byte-identical traces (the determinism contract the
chaos gates and the autoscale A/B bench both lean on).

Workload mix (``mix=`` weights, defaults below):

- ``chat``     latency-class short prompt / short decode — the
               interactive GPT turn; rides a zipf-popular session id so
               returning sessions re-hit their prefix blocks;
- ``longctx``  throughput-class prefill-heavy — a long prompt decoding
               only a few tokens (summarize-the-document shape);
- ``ctr``      throughput-class tiny prompt / one-to-two token decode —
               the CTR embed-wave stand-in, GPT-shaped so one fleet
               serves the whole trace (the real recommendation wave
               runs on the JAX package's EmbedServingEngine fleet).

Virtual time: ``trace()`` stamps each spec with an arrival offset ``t``
in virtual seconds; :func:`replay` submits specs into a ``ServingRouter``
against a virtual clock advanced ``step_s`` per ``router.step()`` —
wall-clock independent, so a trace replays identically on a loaded CI
box and a quiet workstation.  Shed/rejected submissions are returned,
never retried silently: the caller owns the zero-loss accounting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from .engine import QueueFull
from .request import Request
from .router import RouterShed

__all__ = ["TrafficSpec", "TrafficGenerator", "replay"]

# class name -> (slo_class, prompt-span range, decode range); spans are
# fractions of the generator's prompt budget so one mix serves any s_max
_CLASSES = {
    "chat": ("latency", (0.10, 0.30), (0.20, 0.50)),
    "longctx": ("throughput", (0.55, 0.85), (0.05, 0.15)),
    "ctr": ("throughput", (0.05, 0.12), (0.02, 0.06)),
}
_DEFAULT_MIX = (("chat", 0.6), ("longctx", 0.25), ("ctr", 0.15))


@dataclasses.dataclass
class TrafficSpec:
    """One arrival: everything needed to build its Request, plus the
    virtual arrival time.  Greedy (temperature 0) by construction so a
    replay's outputs are token-identical to an offline decode of the
    same specs — the chaos gates compare exactly that."""

    t: float
    workload: str
    prompt: List[int]
    max_new_tokens: int
    slo_class: str
    session_id: Optional[str]
    seed: int
    request_id: str

    def to_request(self, **overrides):
        kw = dict(prompt=list(self.prompt),
                  max_new_tokens=self.max_new_tokens,
                  temperature=0.0, seed=self.seed,
                  slo_class=self.slo_class, session_id=self.session_id,
                  request_id=self.request_id)
        kw.update(overrides)
        return Request(**kw)


class TrafficGenerator:
    """Render a seeded diurnal/zipf/flash traffic shape into specs.

    ``flash`` is a tuple of ``(t0, duration_s, multiplier)`` windows —
    inside one, the instantaneous rate is multiplied (the flash crowd
    the scale-down chaos gate lands mid-drain).  ``prefix_len`` > 0
    gives every session a deterministic shared prompt head of that many
    tokens, so popular sessions exercise the prefix cache + directory
    the way real multi-tenant system prompts do."""

    def __init__(self, *, seed=0, vocab=61, s_max=32, horizon_s=8.0,
                 base_rps=2.0, peak_rps=10.0, cycle_s=None,
                 n_sessions=32, zipf_a=1.4, flash=(), mix=None,
                 prefix_len=0):
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.s_max = int(s_max)
        self.horizon_s = float(horizon_s)
        self.base_rps = float(base_rps)
        self.peak_rps = float(peak_rps)
        # one full trough->peak->trough swing across the horizon unless
        # the caller wants several "days"
        self.cycle_s = float(cycle_s if cycle_s is not None
                             else horizon_s)
        self.n_sessions = int(n_sessions)
        self.zipf_a = float(zipf_a)
        self.flash = tuple((float(t0), float(d), float(m))
                           for t0, d, m in flash)
        self.mix = tuple(mix) if mix is not None else _DEFAULT_MIX
        for name, _w in self.mix:
            if name not in _CLASSES:
                raise ValueError(
                    f"unknown traffic class {name!r} "
                    f"(expected one of {sorted(_CLASSES)})")
        self.prefix_len = int(prefix_len)
        if self.prefix_len >= self.s_max:
            raise ValueError(
                f"prefix_len {self.prefix_len} leaves no prompt room "
                f"under s_max {self.s_max}")

    # ------------------------------------------------------------- #

    def rate(self, t):
        """Instantaneous arrival rate (req/s) at virtual second ``t``:
        the raised-cosine diurnal curve times any flash window."""
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.cycle_s))
        r = self.base_rps + (self.peak_rps - self.base_rps) * swing
        for t0, dur, mult in self.flash:
            if t0 <= t < t0 + dur:
                r *= mult
        return r

    def _session_prefix(self, sess):
        """Deterministic shared prompt head per session (its "system
        prompt") — same session, same head, every trace."""
        if self.prefix_len <= 0:
            return []
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + sess) % (2 ** 31 - 1))
        return [int(x) for x in
                rng.randint(1, self.vocab, size=self.prefix_len)]

    def trace(self, dt=0.1):
        """The full replayable trace: Poisson arrivals in ``dt``-second
        bins against :meth:`rate`, each assigned a zipf-drawn session,
        a mix-drawn workload class, and a seeded prompt.  Pure function
        of the constructor arguments + ``dt``."""
        rng = np.random.RandomState(self.seed)
        names = [m[0] for m in self.mix]
        weights = np.asarray([m[1] for m in self.mix], np.float64)
        weights = weights / weights.sum()
        specs = []
        i = 0
        t = 0.0
        while t < self.horizon_s:
            n = int(rng.poisson(max(self.rate(t), 0.0) * dt))
            for _ in range(n):
                cls = names[int(rng.choice(len(names), p=weights))]
                slo_class, p_span, d_span = _CLASSES[cls]
                sess = int(rng.zipf(self.zipf_a) - 1) % self.n_sessions
                head = self._session_prefix(sess)
                budget = self.s_max - len(head)
                p_lo, p_hi = p_span
                lo = max(2, int(budget * p_lo))
                hi = max(lo + 1, int(budget * p_hi))
                n_prompt = int(rng.randint(lo, hi))
                d_lo, d_hi = d_span
                lo = max(1, int(budget * d_lo))
                hi = max(lo + 1, int(budget * d_hi))
                n_new = int(rng.randint(lo, hi))
                # clamp the pair into the sequence budget (prompt wins:
                # a longctx request is DEFINED by its prompt)
                n_prompt = min(n_prompt, budget - 1)
                n_new = min(n_new, budget - n_prompt)
                body = [int(x) for x in
                        rng.randint(1, self.vocab, size=n_prompt)]
                specs.append(TrafficSpec(
                    t=round(t + float(rng.uniform(0.0, dt)), 6),
                    workload=cls, prompt=head + body,
                    max_new_tokens=max(n_new, 1), slo_class=slo_class,
                    session_id=f"s{sess}",
                    seed=self.seed * 100_000 + i,
                    request_id=f"tg{self.seed}-{i}"))
                i += 1
            t += dt
        specs.sort(key=lambda s: (s.t, s.request_id))
        return specs

    def describe(self):
        """JSON-able provenance block for bench artifacts."""
        return {
            "seed": self.seed, "horizon_s": self.horizon_s,
            "base_rps": self.base_rps, "peak_rps": self.peak_rps,
            "cycle_s": self.cycle_s, "n_sessions": self.n_sessions,
            "zipf_a": self.zipf_a, "flash": list(self.flash),
            "mix": {k: v for k, v in self.mix},
            "prefix_len": self.prefix_len,
        }


def replay(router, specs, *, step_s=0.02, tail_s=0.0):
    """Play a trace into a router against a VIRTUAL clock: all specs
    due by the clock are submitted, then one ``router.step()`` advances
    the clock ``step_s``.  Runs until every submitted request retires
    (plus ``tail_s`` more virtual seconds of idle stepping — long
    enough for a scale-down to show, when an autoscaler rides the
    router).  Returns ``(results, report)``: results by request id and
    ``{"shed": [rids], "rejected": [rids], "steps": n}``.  A hard
    QueueFull submit is retried once after a step; a second refusal is
    recorded as rejected (never admitted — not a loss)."""
    specs = sorted(specs, key=lambda s: (s.t, s.request_id))
    out = {}
    shed, rejected = [], []
    vt = 0.0
    steps = 0
    i = 0
    horizon = (specs[-1].t if specs else 0.0) + float(tail_s)
    while i < len(specs) or router.pending or vt <= horizon:
        while i < len(specs) and specs[i].t <= vt:
            sp = specs[i]
            i += 1
            try:
                router.submit(sp.to_request())
                continue
            except RouterShed:
                shed.append(sp.request_id)
                continue
            except QueueFull:
                pass
            for res in router.step():
                out[res.request_id] = res
            steps += 1
            try:
                router.submit(sp.to_request())
            except QueueFull:   # RouterShed included: still full
                rejected.append(sp.request_id)
        for res in router.step():
            out[res.request_id] = res
        steps += 1
        vt += step_s
    return out, {"shed": shed, "rejected": rejected, "steps": steps}
