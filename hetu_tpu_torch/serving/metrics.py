"""Serving telemetry: per-request lifecycle tracing + latency
aggregates + engine gauges.

Structured events flow through the ONE telemetry sink
(telemetry/events.py): ``{"t": <epoch>, "event": <kind>, **fields}``
records kept in memory and appended as JSONL to the ``serve`` stream —
``$HETU_SERVE_LOG`` (legacy path, one tail/jq pipeline with the failure
log) plus the merged ``$HETU_TELEMETRY_LOG``.

Request lifecycle: every request is tracked through
submit -> queue -> kv_alloc -> prefill (per chunk) -> decode -> retire.
At retirement the tracker emits one ``req_span`` record per phase
(``t`` = the phase's START epoch, ``ms`` its length — the exact shape
``span`` records use, so ``hetu_trace --export`` renders each request
as its own Perfetto track) plus a ``req_retire`` record carrying the
full component breakdown:

    queue_ms        submit -> first admission attempt
    requeue_ms      head-of-queue wait while blocked (paged pool
                    exhaustion / prefix deferral); 0 when never blocked
    router_hop_ms   wall time lost to a FAILED placement before this
                    engine saw the request (the fleet router requeued
                    it off a dead/wedged replica — serving/router.py
                    credits the hop at re-submission); 0 un-routed
    handoff_ms      prefill->decode disaggregation detour before this
                    engine saw the request: clone prefill on the
                    prefill-heavy replica + KV export/import (the
                    router credits it when the imported blocks land);
                    0 without a handoff
    kv_alloc_ms     slot + block-table claim
    prefill_ms      prompt compute actually dispatched for this request
    chunk_stall_ms  prefill-phase wall not spent computing (chunked
                    prefill interleaving with decode waves)
    decode_ms       first token -> retirement

``snapshot()`` aggregates each component at p50/p95/p99 and
``explain_tail()`` names the component that dominates the p99-TTFT
tail — the "why was this request 40x the median" answer.

Memory: ``events`` is the full history only when a log path is
configured (the run is being deliberately observed and the JSONL has
it anyway); otherwise it is a bounded ring (``HETU_TELEMETRY_BUFFER``)
— a long-running engine no longer leaks one dict per record.
"""

from __future__ import annotations

import collections
import time

from .. import envvars, telemetry
from ..telemetry.metrics import percentile

import numpy as np

COMPONENTS = ("queue_ms", "requeue_ms", "router_hop_ms", "handoff_ms",
              "kv_alloc_ms", "prefill_ms", "chunk_stall_ms", "decode_ms")


def _pct(xs, q):
    """Seconds-valued percentile via THE shared interpolating helper
    (telemetry.metrics.percentile) — serving and the metrics registry
    now agree on what a p99 is."""
    xs = list(xs)
    return percentile(xs, q) if xs else None


class _Lifecycle:
    """Perf-counter timeline of one request, engine-side."""

    __slots__ = ("t_submit", "t_blocked", "t_claim", "kv_alloc_ms",
                 "prefill_ms", "t_first", "n_prefills", "hop_ms",
                 "handoff_ms", "away_ms")

    def __init__(self, t_submit):
        self.t_submit = t_submit
        self.t_blocked = None     # first blocked admission attempt
        self.t_claim = None       # slot + KV claimed
        self.kv_alloc_ms = 0.0
        self.prefill_ms = 0.0     # dispatched prompt compute
        self.n_prefills = 0       # dispatches (chunks) it rode in
        self.t_first = None       # first token landed
        self.hop_ms = 0.0         # router requeue hops before us
        self.handoff_ms = 0.0     # prefill->decode handoff detour
        self.away_ms = 0.0        # mid-prefill, between engine steps


class MetricsCore:
    """Model-agnostic serving-telemetry base: the event pipeline,
    clock plumbing, and the submit/reject lifecycle every engine kind
    shares.  :class:`ServingMetrics` (GPT decode) and
    :class:`EmbedServingMetrics` (recommendation scoring) both build
    on this, so the fleet router / hetu_top / span-balance tooling
    read one event vocabulary regardless of workload."""

    def __init__(self, log_path=None, tags=None):
        self.log_path = (log_path if log_path is not None
                         else envvars.get_path("HETU_SERVE_LOG"))
        # fields stamped onto EVERY event this engine emits (the fleet
        # router tags each replica's engine with replica=<k>, which is
        # what lets hetu_top --fleet and the per-replica span-balance
        # rule tell N same-process engines apart in one merged stream)
        self.tags = dict(tags or {})
        cap = max(1, envvars.get_int("HETU_TELEMETRY_BUFFER"))
        # full in-memory history only when the run keeps a JSONL log
        # (deliberate observation); ring-buffered otherwise so a
        # long-running engine's memory stays bounded
        self.events = ([] if self.log_path
                       else collections.deque(maxlen=cap))
        self.submitted = 0
        self.rejected = 0
        self.finished = 0
        self._lc = {}              # request_id -> lifecycle record
        self._t0 = None
        self._t_last = None

    # ------------------------------------------------------------- #

    def event(self, kind, **fields):
        # a "t" field overrides the record's timestamp (req_span records
        # are START-stamped like `span` records)
        rec = telemetry.emit(kind, _stream="serve", _path=self.log_path,
                             _t=fields.pop("t", None),
                             **{**self.tags, **fields})
        self.events.append(rec)
        return rec

    def _mark(self):
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._t_last = now

    # ONE epoch<->perf_counter offset for the whole process: deriving
    # it per call (time.time() - perf_counter() read back to back) let
    # scheduler preemption between the two clock reads skew req_span
    # stamps against serve_step stamps by milliseconds, which pushed
    # flow-arrow bindings outside their wave spans on loaded boxes —
    # a shared offset makes every exported timestamp mutually
    # consistent by construction (long-run clock drift is irrelevant
    # at trace granularity)
    _PERF_TO_EPOCH = time.time() - time.perf_counter()

    @classmethod
    def _epoch(cls, perf_t):
        """Map a perf_counter stamp onto the epoch clock the telemetry
        stream uses (so req_span tracks align with span tracks)."""
        return cls._PERF_TO_EPOCH + perf_t

    def _make_lc(self, t_submit):
        """Workload-specific lifecycle record for one request."""
        raise NotImplementedError

    def record_submit(self, request_id, queue_depth):
        self.submitted += 1
        self._lc[request_id] = self._make_lc(time.perf_counter())
        self.event("serve_submit", request=request_id,
                   queue_depth=queue_depth)

    def record_reject(self, request_id, queue_depth):
        self.rejected += 1
        self.event("serve_queue_reject", request=request_id,
                   queue_depth=queue_depth)

    def lc_hop(self, request_id, hop_ms):
        """Credit wall time the fleet router lost placing this request
        on a replica that died/wedged before it could retire (called by
        the router right after the re-submission; accumulates across
        hops)."""
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.hop_ms += float(hop_ms)


class ServingMetrics(MetricsCore):
    def __init__(self, log_path=None, tags=None):
        super().__init__(log_path=log_path, tags=tags)
        self.tokens_generated = 0
        self.ttfts = []            # seconds, submit -> first token
        self.latencies = []        # seconds, submit -> finish
        self.tpots = []            # per-request decode s/token means
        self.step_live = []        # live slots per fused step
        self.step_queue = []       # queue depth per fused step
        self.step_dt = []          # seconds per fused decode step
        self.step_tokens = []      # tokens EMITTED per fused step (==
        # live without speculation; 1..(k+1)*live with it — the TPOT
        # percentiles are computed from these real per-step counts)
        self.step_prefill = []     # prefill seconds folded into a step
        self.prefill_dt = []       # seconds per prefill dispatch
        self.prefill_reqs = 0      # requests prefilled
        self.prefill_batched = 0   # batched (fast-path) dispatches
        self.components = {c: [] for c in COMPONENTS}
        # mixed-mode ragged dispatch ($HETU_SERVE_RAGGED): the engine
        # sets this when every step is ONE unified wave — prefill
        # attribution then covers the whole ragged dispatch, so the
        # chunk_stall component is asserted near-zero at retirement and
        # folded to exactly 0 (kept in COMPONENTS for back-compat:
        # dashboards and the tail report keep their schema)
        self.mixed_mode = False
        # per-request breakdowns explain_tail() slices (ring: the tail
        # report is about RECENT behavior, same cap as the event ring)
        cap = max(1, envvars.get_int("HETU_TELEMETRY_BUFFER"))
        self.breakdowns = collections.deque(maxlen=cap)
        self._slots = None

    def _make_lc(self, t_submit):
        return _Lifecycle(t_submit)

    # ------------------------------------------------------------- #
    # lifecycle marks (the engine calls these at phase boundaries)
    # ------------------------------------------------------------- #

    def lc_blocked(self, request_id):
        """The head-of-queue request could not admit this attempt
        (pool/slot exhaustion or prefix deferral): starts its requeue
        clock.  Idempotent — only the FIRST block mark counts."""
        lc = self._lc.get(request_id)
        if lc is not None and lc.t_blocked is None:
            lc.t_blocked = time.perf_counter()

    def lc_claimed(self, request_id, kv_alloc_ms):
        """Slot + KV claimed (queue/requeue phases end here)."""
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.t_claim = time.perf_counter()
            lc.kv_alloc_ms = float(kv_alloc_ms)

    def lc_prefill(self, request_id, dt_s, count=True):
        """Attribute one prefill dispatch's wall time to this request
        (a chunked prompt accumulates across chunks).  ``count=False``
        adds wall without counting a dispatch — the mixed-mode engine
        uses it to top a rider up to the full wave elapsed after the
        wave's unpack completes."""
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.prefill_ms += dt_s * 1e3
            if count:
                lc.n_prefills += 1

    def lc_away(self, request_id, dt_s):
        """Credit wall time that passed between two steps of the engine
        while this request was mid-prefill: time the engine was not
        stepping at all (a fleet router stepping its peers, a weight
        swap's probe), which no wave can be credited with."""
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.away_ms += dt_s * 1e3

    def lc_handoff(self, request_id, handoff_ms):
        """Credit the prefill->decode disaggregation detour: wall time
        between the router flipping this request into its prefill
        phase and the exported KV blocks landing on THIS engine's pool
        (called by the router right after the import)."""
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.handoff_ms += float(handoff_ms)

    # ------------------------------------------------------------- #

    def record_admit(self, request_id, slot, queue_wait_s, ttft_s):
        self._mark()
        self.ttfts.append(ttft_s)
        self.tokens_generated += 1          # prefill emits token #1
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.t_first = time.perf_counter()
        self.event("serve_admit", request=request_id, slot=slot,
                   queue_wait_s=round(queue_wait_s, 6),
                   ttft_s=round(ttft_s, 6))

    def record_prefill(self, n, bucket, dt_s, batched=False):
        """One prefill dispatch: ``n`` requests admitted in one jitted
        call (n > 1 only on the batched fast path) at prompt bucket
        ``bucket``."""
        self._mark()
        self.prefill_dt.append(dt_s)
        self.prefill_reqs += n
        if batched:
            self.prefill_batched += 1
        self.event("serve_prefill", n=n, bucket=bucket,
                   prefill_ms=round(dt_s * 1e3, 3), batched=bool(batched))

    def record_step(self, live, slots, queue_depth, dt_s, new_tokens,
                    prefill_s=0.0, step=None, requests=None,
                    end_perf=None, spec=None, mix=None, moe=None):
        """One fused decode step; ``prefill_s`` is the prefill wall time
        this scheduler iteration paid before decoding, so the per-step
        JSONL event attributes the phases separately (the masked vs
        ragged A/B reads these).  ``step``/``requests`` identify the
        wave and its participants — the trace exporter draws flow
        arrows from each request's lifecycle track into the wave.
        ``end_perf`` is the decode's end perf-stamp: the event's ``t``
        then marks the true phase end (the exporter backdates the wave
        start by ``decode_ms``) instead of the emission time, which
        trails it by the retire loop.

        ``new_tokens`` is the step's REAL emitted-token count (a
        speculative wave emits up to k+1 per slot): it lands in the
        event, in ``step_tokens``, and in the ``serve.tokens_per_step``
        histogram — TPOT is computed from these, never from a
        one-token-per-step assumption.  ``spec`` (a
        {k, proposed, accepted} dict) stamps a speculative wave's
        draft accounting onto the event.

        ``mix`` (a {q_prefill, q_verify, q_decode} dict, mixed-mode
        engines only) stamps the wave's per-mode q-token split onto the
        event — how many of the ragged dispatch's query rows were
        prompt prefill, spec-verify, and plain decode (hetu_top's
        mixed-wave columns and the tail report read these).

        ``moe`` (a {tokens, routed, dropped, k, layers, imb,
        drop_rate} dict, MoE engines only) stamps the step's expert
        routing outcome — ``routed + dropped == tokens * k * layers``
        is the invariant hetu_trace --check enforces, ``imb`` and
        ``drop_rate`` feed hetu_top's expert columns.  Dense steps
        carry no moe_* fields and the checker exempts them."""
        self._mark()
        self._slots = slots
        self.step_live.append(live)
        self.step_queue.append(queue_depth)
        self.step_dt.append(dt_s)
        self.step_prefill.append(prefill_s)
        self.step_tokens.append(int(new_tokens))
        self.tokens_generated += new_tokens
        telemetry.observe("serve.tokens_per_step", int(new_tokens))
        fields = {}
        if step is not None:
            fields["step"] = step
        if requests is not None:
            fields["requests"] = list(requests)
        if end_perf is not None:
            fields["t"] = self._epoch(end_perf)
        if spec is not None:
            fields["spec_k"] = int(spec.get("k", 0))
            fields["spec_proposed"] = int(spec.get("proposed", 0))
            fields["spec_accepted"] = int(spec.get("accepted", 0))
        if mix is not None:
            fields["q_prefill"] = int(mix.get("q_prefill", 0))
            fields["q_verify"] = int(mix.get("q_verify", 0))
            fields["q_decode"] = int(mix.get("q_decode", 0))
        if moe is not None:
            fields["moe_tokens"] = int(moe.get("tokens", 0))
            fields["moe_routed"] = int(moe.get("routed", 0))
            fields["moe_dropped"] = int(moe.get("dropped", 0))
            fields["moe_k"] = int(moe.get("k", 0))
            fields["moe_layers"] = int(moe.get("layers", 0))
            fields["moe_imb"] = round(float(moe.get("imb", 0.0)), 4)
            fields["moe_drop_rate"] = round(
                float(moe.get("drop_rate", 0.0)), 6)
        self.event("serve_step", live=live, queue_depth=queue_depth,
                   slots=slots, new_tokens=int(new_tokens),
                   prefill_ms=round(prefill_s * 1e3, 3),
                   decode_ms=round(dt_s * 1e3, 3), **fields)

    def record_finish(self, request_id, reason, n_generated, latency_s,
                      spec=None):
        """``spec`` ({accepted, proposed, bonus}, speculative engines
        only) rides into the req_retire record so hetu_trace --check
        can assert accepted + bonus + 1 == n_generated per request."""
        self._mark()
        self.finished += 1
        self.latencies.append(latency_s)
        self.event("serve_finish", request=request_id, reason=reason,
                   n_generated=n_generated, latency_s=round(latency_s, 6))
        return self._retire(request_id, n_generated, spec=spec)

    # ------------------------------------------------------------- #
    # retirement: component breakdown + per-phase req_span records
    # ------------------------------------------------------------- #

    def _retire(self, request_id, n_generated, spec=None):
        lc = self._lc.pop(request_id, None)
        if lc is None or lc.t_claim is None or lc.t_first is None:
            return None
        now = time.perf_counter()
        claim_end = lc.t_claim
        claim_start = claim_end - lc.kv_alloc_ms / 1e3
        queue_end = lc.t_blocked if lc.t_blocked is not None \
            else claim_start
        queue_ms = max(queue_end - lc.t_submit, 0.0) * 1e3
        requeue_ms = (max(claim_start - lc.t_blocked, 0.0) * 1e3
                      if lc.t_blocked is not None else 0.0)
        prefill_wall_ms = max(lc.t_first - claim_end, 0.0) * 1e3
        prefill_ms = min(lc.prefill_ms, prefill_wall_ms)
        chunk_stall_ms = max(prefill_wall_ms - prefill_ms, 0.0)
        if self.mixed_mode:
            # unified wave: the whole ragged dispatch IS this request's
            # prefill compute — any residue past the time the engine
            # spent between steps (``away_ms``: a fleet's router
            # stepping the peers) is host bookkeeping between claim and
            # dispatch, noise-scale by construction.  Assert that (an
            # accounting regression shows up HERE, not as a quietly
            # wrong dashboard); the stall that remains is the away time.
            residue = chunk_stall_ms - lc.away_ms
            assert residue <= max(50.0, 0.5 * prefill_wall_ms), (
                f"mixed-mode chunk_stall residue {residue:.1f}ms "
                f"of {prefill_wall_ms:.1f}ms prefill wall for "
                f"{request_id}: wave attribution is broken")
            chunk_stall_ms = min(chunk_stall_ms, lc.away_ms)
        decode_ms = max(now - lc.t_first, 0.0) * 1e3 \
            if n_generated > 1 else 0.0
        ttft_ms = max(lc.t_first - lc.t_submit, 0.0) * 1e3
        comp = {"queue_ms": queue_ms, "requeue_ms": requeue_ms,
                "router_hop_ms": lc.hop_ms, "handoff_ms": lc.handoff_ms,
                "kv_alloc_ms": lc.kv_alloc_ms, "prefill_ms": prefill_ms,
                "chunk_stall_ms": chunk_stall_ms, "decode_ms": decode_ms}
        for k, v in comp.items():
            self.components[k].append(v)
        if n_generated > 1 and decode_ms > 0:
            # per-request decode MEAN (wall over tokens) — a valid
            # average either way, but NOT the TPOT percentile source:
            # snapshot() builds that from real per-step token counts
            self.tpots.append(decode_ms / 1e3 / (n_generated - 1))
        breakdown = {"request": request_id, "ttft_ms": ttft_ms,
                     **{k: round(v, 3) for k, v in comp.items()}}
        self.breakdowns.append(breakdown)
        # one span per phase, start-stamped like `span` records so the
        # exporter lays the request out as its own track
        phases = [("queue", lc.t_submit, queue_ms, {}),
                  ("kv_alloc", claim_start, lc.kv_alloc_ms, {})]
        if lc.t_blocked is not None:
            phases.insert(1, ("requeue", lc.t_blocked, requeue_ms, {}))
        if lc.handoff_ms > 0:
            # like the hop: the detour ended at this engine's submit —
            # backdate so the track reads handoff -> queue -> ...
            phases.insert(0, ("handoff",
                              lc.t_submit - lc.handoff_ms / 1e3,
                              lc.handoff_ms, {}))
        if lc.hop_ms > 0:
            # the hop happened BEFORE this engine's submit: backdate
            # its span so the request's track reads hop -> queue -> ...
            phases.insert(0, ("router_hop",
                              lc.t_submit - lc.hop_ms / 1e3,
                              lc.hop_ms, {}))
        phases.append(("prefill", claim_end, prefill_wall_ms,
                       {"compute_ms": round(prefill_ms, 3),
                        "stall_ms": round(chunk_stall_ms, 3),
                        "dispatches": lc.n_prefills}))
        if decode_ms > 0:
            phases.append(("decode", lc.t_first, decode_ms,
                           {"n_tokens": n_generated - 1}))
        for phase, t_start, ms, extra in phases:
            self.event("req_span", request=request_id, phase=phase,
                       ms=round(ms, 3), t=self._epoch(t_start), **extra)
        spec_fields = {}
        if spec is not None:
            spec_fields = {"spec_accepted": int(spec.get("accepted", 0)),
                           "spec_proposed": int(spec.get("proposed", 0)),
                           "spec_bonus": int(spec.get("bonus", 0))}
        self.event("req_retire", request=request_id,
                   ttft_ms=round(ttft_ms, 3),
                   n_generated=n_generated, **spec_fields,
                   **breakdown_fields(comp))
        return breakdown

    # ------------------------------------------------------------- #

    def snapshot(self):
        """Aggregate view (JSON-able): throughput, TTFT/TPOT
        percentiles, mean batch occupancy over fused steps, queue
        stats, and the per-component tail decomposition."""
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last > self._t0
                else None)
        occ = ([l / self._slots for l in self.step_live]
               if self._slots else [])
        # TPOT from REAL per-step emitted-token counts: a step emitting
        # n tokens contributes n samples of dt/n — correct with and
        # without speculation (the old per-request decode_ms/(n-1)
        # assumed one token per wave and skewed the percentiles the
        # moment waves emitted more)
        tpot = []
        for dt, n in zip(self.step_dt, self.step_tokens):
            if n > 0:
                tpot.extend([dt / n] * n)
        comps = {}
        for name, xs in self.components.items():
            if xs:
                comps[name] = {
                    "p50_ms": round(_pct(xs, 50), 3),
                    "p95_ms": round(_pct(xs, 95), 3),
                    "p99_ms": round(_pct(xs, 99), 3),
                    "mean_ms": round(float(np.mean(xs)), 3),
                }
        return {
            "requests_submitted": self.submitted,
            "requests_rejected": self.rejected,
            "requests_finished": self.finished,
            "tokens_generated": self.tokens_generated,
            "wall_s": round(wall, 6) if wall else None,
            "tokens_per_sec": (round(self.tokens_generated / wall, 2)
                               if wall else None),
            "ttft_p50_s": _pct(self.ttfts, 50),
            "ttft_p95_s": _pct(self.ttfts, 95),
            "ttft_p99_s": _pct(self.ttfts, 99),
            "ttft_mean_s": (float(np.mean(self.ttfts))
                            if self.ttfts else None),
            "tpot_p50_s": _pct(tpot, 50),
            "tpot_p99_s": _pct(tpot, 99),
            "tpot_req_mean_p50_s": _pct(self.tpots, 50),
            "tokens_per_step_mean": (float(np.mean(self.step_tokens))
                                     if self.step_tokens else None),
            "step_p50_s": _pct(self.step_dt, 50),
            "step_p99_s": _pct(self.step_dt, 99),
            "decode_ms_p50": (round(_pct(self.step_dt, 50) * 1e3, 3)
                              if self.step_dt else None),
            "prefill_ms_p50": (round(_pct(self.prefill_dt, 50) * 1e3, 3)
                               if self.prefill_dt else None),
            "prefill_total_s": (round(float(np.sum(self.prefill_dt)), 6)
                                if self.prefill_dt else None),
            "decode_total_s": (round(float(np.sum(self.step_dt)), 6)
                               if self.step_dt else None),
            "prefill_dispatches": len(self.prefill_dt),
            "prefill_batched_dispatches": self.prefill_batched,
            "steps": len(self.step_live),
            "mean_batch_occupancy": (float(np.mean(occ)) if occ else None),
            "mean_queue_depth": (float(np.mean(self.step_queue))
                                 if self.step_queue else None),
            "components": comps,
        }

    def explain_tail(self, q=99):
        """Name the component that dominates the TTFT tail: slice the
        requests at or above the q-th TTFT percentile and average their
        breakdowns.  The dominant component is the report's headline —
        "p99 TTFT is queue-bound" is an actionable statement (admission
        control) where "p99 TTFT is 40x p50" is not.  Returns None with
        no finished requests."""
        rows = [b for b in self.breakdowns if b.get("ttft_ms") is not None]
        if not rows:
            return None
        ttfts = [b["ttft_ms"] for b in rows]
        cut = _pct(ttfts, q)
        tail = [b for b in rows if b["ttft_ms"] >= cut]
        means = {c: float(np.mean([b[c] for b in tail]))
                 for c in COMPONENTS}
        # decode is not part of TTFT — the tail is decomposed over the
        # submit->first-token phases only
        ttft_parts = {c: v for c, v in means.items() if c != "decode_ms"}
        dominant = max(ttft_parts, key=ttft_parts.get)
        total = sum(ttft_parts.values()) or 1.0
        share = ttft_parts[dominant] / total
        report = {
            "q": q,
            "ttft_p_ms": round(cut, 3),
            "ttft_p50_ms": round(_pct(ttfts, 50), 3),
            "n_requests": len(rows),
            "n_tail": len(tail),
            "dominant_component": dominant,
            "dominant_ms": round(ttft_parts[dominant], 3),
            "dominant_share": round(share, 4),
            "components_mean_ms": {c: round(v, 3)
                                   for c, v in means.items()},
            "tail_requests": [b["request"] for b in tail[:8]],
            "mixed_mode": self.mixed_mode,
        }
        report["summary"] = (
            f"p{q} TTFT {cut:.1f}ms ({len(tail)}/{len(rows)} requests): "
            f"dominated by {dominant.replace('_ms', '')} "
            f"({ttft_parts[dominant]:.1f}ms, {share:.0%} of the "
            f"pre-token wall)")
        if self.mixed_mode:
            # the unified wave carries all modes: prefill_ms here means
            # "ragged dispatches this prompt rode in" and chunk_stall
            # is 0 by construction (folded at retirement)
            report["summary"] += (
                " [mixed-mode: prefill attributed to unified ragged "
                "waves; chunk_stall folded to 0]")
        return report


EMBED_COMPONENTS = ("queue_ms", "router_hop_ms", "gather_ms",
                    "forward_ms")


class _EmbedLifecycle:
    """Perf-counter timeline of one scoring request: submit -> wave
    claim -> gather (embedding fetch) -> forward (tower) -> retire."""

    __slots__ = ("t_submit", "t_claim", "gather_ms", "t_first",
                 "hop_ms")

    def __init__(self, t_submit):
        self.t_submit = t_submit
        self.t_claim = None       # wave claimed the request
        self.gather_ms = 0.0      # embedding gather attributed to it
        self.t_first = None       # scores landed
        self.hop_ms = 0.0         # router requeue hops before us


class EmbedServingMetrics(MetricsCore):
    """Embedding-engine telemetry: the GPT lifecycle with the KV
    phases replaced by ``gather_ms`` (CacheSparseTable fetch) and
    ``forward_ms`` (the jitted tower).  Emits the SAME event kinds the
    GPT engine does — serve_submit/serve_admit/serve_step/serve_finish
    plus per-phase req_span and req_retire — so hetu_trace --check's
    span-balance rule, hetu_top, and the SLO monitor work unmodified;
    the one new kind is the per-wave ``serve_gather`` record.  Every
    event carries ``workload="embed"`` (hetu_top's workload column)."""

    def __init__(self, log_path=None, tags=None):
        super().__init__(log_path=log_path, tags=tags)
        self.tags.setdefault("workload", "embed")
        self.pairs_scored = 0
        self.ttfts = []            # seconds, submit -> scores landed
        self.latencies = []        # == ttfts shape-wise; kept separate
        # so snapshot() reads like the GPT one
        self.step_live = []        # requests per wave
        self.step_queue = []       # queue depth per wave
        self.step_dt = []          # seconds per wave (gather+forward)
        self.step_rows = []        # pairs scored per wave
        self.gather_dt = []        # seconds per wave gather
        self.hit_rates = []        # cache hit-rate per wave gather
        self.components = {c: [] for c in EMBED_COMPONENTS}
        cap = max(1, envvars.get_int("HETU_TELEMETRY_BUFFER"))
        self.breakdowns = collections.deque(maxlen=cap)
        self._slots = None

    def _make_lc(self, t_submit):
        return _EmbedLifecycle(t_submit)

    # ------------------------------------------------------------- #

    def lc_claimed(self, request_id):
        """The wave claimed this request off the queue (queue phase
        ends here; gather starts)."""
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.t_claim = time.perf_counter()

    def record_gather(self, n, rows, gather_s, hit_rate, requests=()):
        """One wave's embedding gather: ``n`` requests, ``rows`` total
        pairs fetched through the cache in ``gather_s`` seconds at
        ``hit_rate``.  Attributes the wall to every participant."""
        self._mark()
        self.gather_dt.append(gather_s)
        self.hit_rates.append(float(hit_rate))
        for rid in requests:
            lc = self._lc.get(rid)
            if lc is not None:
                lc.gather_ms += gather_s * 1e3
        self.event("serve_gather", n=n, rows=rows,
                   gather_ms=round(gather_s * 1e3, 3),
                   hit_rate=round(float(hit_rate), 4))

    def record_admit(self, request_id, slot, queue_wait_s, ttft_s):
        """Scores landed for this request (embed waves emit the whole
        result at once, so admit == first-result)."""
        self._mark()
        self.ttfts.append(ttft_s)
        lc = self._lc.get(request_id)
        if lc is not None:
            lc.t_first = time.perf_counter()
        self.event("serve_admit", request=request_id, slot=slot,
                   queue_wait_s=round(queue_wait_s, 6),
                   ttft_s=round(ttft_s, 6))

    def record_step(self, live, slots, queue_depth, dt_s, rows,
                    gather_s=0.0, step=None, requests=None):
        """One scoring wave: ``dt_s`` is the wave wall (gather +
        forward), ``rows`` the pairs it scored.  Shapes the serve_step
        event like a GPT decode wave (decode_ms = the forward wall) so
        hetu_top and the trace exporter render waves unmodified."""
        self._mark()
        self._slots = slots
        self.step_live.append(live)
        self.step_queue.append(queue_depth)
        self.step_dt.append(dt_s)
        self.step_rows.append(int(rows))
        self.pairs_scored += int(rows)
        telemetry.observe("serve.pairs_per_wave", int(rows))
        fields = {}
        if step is not None:
            fields["step"] = step
        if requests is not None:
            fields["requests"] = list(requests)
        self.event("serve_step", live=live, queue_depth=queue_depth,
                   slots=slots, rows=int(rows),
                   gather_ms=round(gather_s * 1e3, 3),
                   decode_ms=round(max(dt_s - gather_s, 0.0) * 1e3, 3),
                   **fields)

    def record_finish(self, request_id, reason, n_pairs, latency_s):
        self._mark()
        self.finished += 1
        self.latencies.append(latency_s)
        self.event("serve_finish", request=request_id, reason=reason,
                   n_generated=n_pairs, latency_s=round(latency_s, 6))
        return self._retire(request_id)

    def _retire(self, request_id):
        lc = self._lc.pop(request_id, None)
        if lc is None or lc.t_claim is None or lc.t_first is None:
            return None
        queue_ms = max(lc.t_claim - lc.t_submit, 0.0) * 1e3
        wave_wall_ms = max(lc.t_first - lc.t_claim, 0.0) * 1e3
        gather_ms = min(lc.gather_ms, wave_wall_ms)
        forward_ms = max(wave_wall_ms - gather_ms, 0.0)
        ttft_ms = max(lc.t_first - lc.t_submit, 0.0) * 1e3
        comp = {"queue_ms": queue_ms, "router_hop_ms": lc.hop_ms,
                "gather_ms": gather_ms, "forward_ms": forward_ms}
        for k, v in comp.items():
            self.components[k].append(v)
        breakdown = {"request": request_id, "ttft_ms": ttft_ms,
                     **{k: round(v, 3) for k, v in comp.items()}}
        self.breakdowns.append(breakdown)
        phases = [("queue", lc.t_submit, queue_ms, {}),
                  ("gather", lc.t_claim, gather_ms, {}),
                  ("forward", lc.t_claim + gather_ms / 1e3,
                   forward_ms, {})]
        if lc.hop_ms > 0:
            # the hop happened BEFORE this engine's submit: backdate
            # its span so the request's track reads hop -> queue -> ...
            phases.insert(0, ("router_hop",
                              lc.t_submit - lc.hop_ms / 1e3,
                              lc.hop_ms, {}))
        for phase, t_start, ms, extra in phases:
            self.event("req_span", request=request_id, phase=phase,
                       ms=round(ms, 3), t=self._epoch(t_start), **extra)
        self.event("req_retire", request=request_id,
                   ttft_ms=round(ttft_ms, 3),
                   **breakdown_fields(comp))
        return breakdown

    # ------------------------------------------------------------- #

    def snapshot(self):
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last > self._t0
                else None)
        occ = ([l / self._slots for l in self.step_live]
               if self._slots else [])
        comps = {}
        for name, xs in self.components.items():
            if xs:
                comps[name] = {
                    "p50_ms": round(_pct(xs, 50), 3),
                    "p95_ms": round(_pct(xs, 95), 3),
                    "p99_ms": round(_pct(xs, 99), 3),
                    "mean_ms": round(float(np.mean(xs)), 3),
                }
        return {
            "requests_submitted": self.submitted,
            "requests_rejected": self.rejected,
            "requests_finished": self.finished,
            "pairs_scored": self.pairs_scored,
            "wall_s": round(wall, 6) if wall else None,
            "qps": (round(self.finished / wall, 2) if wall else None),
            "pairs_per_sec": (round(self.pairs_scored / wall, 2)
                              if wall else None),
            "latency_p50_s": _pct(self.latencies, 50),
            "latency_p95_s": _pct(self.latencies, 95),
            "latency_p99_s": _pct(self.latencies, 99),
            "latency_mean_s": (float(np.mean(self.latencies))
                               if self.latencies else None),
            "gather_ms_p50": (round(_pct(self.gather_dt, 50) * 1e3, 3)
                              if self.gather_dt else None),
            "wave_ms_p50": (round(_pct(self.step_dt, 50) * 1e3, 3)
                            if self.step_dt else None),
            "cache_hit_rate_mean": (float(np.mean(self.hit_rates))
                                    if self.hit_rates else None),
            "steps": len(self.step_live),
            "rows_per_wave_mean": (float(np.mean(self.step_rows))
                                   if self.step_rows else None),
            "mean_batch_occupancy": (float(np.mean(occ)) if occ else None),
            "mean_queue_depth": (float(np.mean(self.step_queue))
                                 if self.step_queue else None),
            "components": comps,
        }

    def explain_tail(self, q=99):
        """Name the component dominating the latency tail (the embed
        twin of ServingMetrics.explain_tail — same report shape, over
        queue/hop/gather/forward instead of the KV phases)."""
        rows = [b for b in self.breakdowns if b.get("ttft_ms") is not None]
        if not rows:
            return None
        ttfts = [b["ttft_ms"] for b in rows]
        cut = _pct(ttfts, q)
        tail = [b for b in rows if b["ttft_ms"] >= cut]
        means = {c: float(np.mean([b[c] for b in tail]))
                 for c in EMBED_COMPONENTS}
        dominant = max(means, key=means.get)
        total = sum(means.values()) or 1.0
        share = means[dominant] / total
        return {
            "q": q,
            "ttft_p_ms": round(cut, 3),
            "ttft_p50_ms": round(_pct(ttfts, 50), 3),
            "n_requests": len(rows),
            "n_tail": len(tail),
            "dominant_component": dominant,
            "dominant_ms": round(means[dominant], 3),
            "dominant_share": round(share, 4),
            "components_mean_ms": {c: round(v, 3)
                                   for c, v in means.items()},
            "tail_requests": [b["request"] for b in tail[:8]],
            "summary": (
                f"p{q} latency {cut:.1f}ms ({len(tail)}/{len(rows)} "
                f"requests): dominated by {dominant.replace('_ms', '')} "
                f"({means[dominant]:.1f}ms, {share:.0%} of the wall)"),
        }


def breakdown_fields(comp):
    """Flatten a component dict for the req_retire record (scalar
    fields survive the trace exporter's args filter; a nested dict
    would be dropped)."""
    return {k: round(v, 3) for k, v in comp.items()}
