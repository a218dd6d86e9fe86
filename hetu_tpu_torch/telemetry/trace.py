"""Merge/tail the JSONL telemetry streams; export a Perfetto trace.

``python -m hetu_tpu_torch.telemetry.trace`` is the CLI (``hetu_trace``
below).  Input is any number of
contract-shaped JSONL files (``{"t", "event", ...}`` — the merged
``$HETU_TELEMETRY_LOG`` or the per-stream legacy logs); with no paths
given, every stream log currently configured in the environment is
read.  Output:

- default: the merged, time-sorted stream as JSONL on stdout (the
  one ``tail | jq`` pipeline, now across all streams at once);
- ``--export trace.json``: a Chrome/Perfetto-loadable trace —
  duration-carrying records (``span``/``serve_step``/``serve_prefill``/
  ``req_span``) become ``"X"`` complete events laid out per pid/thread
  track, ``gauge`` records become ``"C"`` counter tracks (occupancy,
  queue depth, blocks_free render as time series; ``serve_step``
  records contribute ``serve.queue_depth``/``serve.live`` counters
  too), everything else an ``"i"`` instant — plus a one-line summary
  on stdout.

Request-lifecycle tracks: ``req_span`` records (serving/metrics.py, one
per queue/kv_alloc/prefill/decode/requeue phase of each request) land
on a per-request track named ``req:<request_id>``, so one request's
whole lifecycle reads as a lane; flow arrows (``s``/``t``/``f`` events
keyed by the request id) connect its decode span into every engine
fused-step wave it participated in (``serve_step`` records carry the
per-wave request list).

Durations: a ``span``/``req_span`` record's ``t`` is its START epoch
and ``ms`` its length (events.py writes them that way); serving
step/prefill records timestamp the END of the phase, so the exporter
backdates their start by the duration field.

``--check`` validates every record against the event contract AND the
span-balance rule: every ``serve_admit`` must have a matching
``serve_finish`` (a request admitted but never retired is a leaked
slot or a crashed scheduler loop).  Fleet streams (``replica``-tagged
serve events from a ServingRouter) additionally pair admit/finish PER
REPLICA, with requests the router requeued off a dead replica
(``router_hop`` records) exempt — they must finish on *some* replica.
Balance is skipped when the input contains a ``flight_dump`` header —
a flight recording is by definition a mid-flight snapshot.

``--check`` also enforces the mixed-quantization rule: every
``bench_row`` in the stream must carry the same ``quant`` stamp
(the JAX package's ``quant.active_modes()``) — quantized and exact
measurements can never be compared silently.

``--check`` also enforces the speculative-attribution rule: a
``req_retire`` record carrying spec fields must satisfy
``spec_accepted + spec_bonus + 1 == n_generated`` — every retired
token is the prefill sample, an accepted draft, or a bonus sample.
Rejected drafts (``spec_proposed - spec_accepted``) are exempt: they
cost compute, never sequence length.

``--check`` also enforces the KV-handoff pairing rule:
every ``kv_handoff_out`` must pair with a ``kv_handoff_in`` for the
same request (blocks that left a replica must land on one), and a
handed-off request must retire exactly once per router admission —
two ``serve_finish`` records (prefill clone + real request), with
``router_hop``-carrying requests exempt the same way span-balance
exempts them.

``--check`` also enforces the version-coherence rule: all
of one request's ``weight_version``-stamped records must agree on a
single version — a rolling weight swap only lands on a drained
replica, so a request that spans two versions without a ``router_hop``
requeue (or a handoff pair) means a swap landed under a live request.

``--check`` also enforces the scale-balance rule: every
``scale_up`` must pair with a ``replica_ready`` on the same replica
(the bring-up probe admitted it) and every ``scale_down`` with a
``replica_retired`` there, and each rid the retirement names as
drained must retire exactly once AFTER the drain, on a peer — never
on the draining replica itself, never twice, never zero times
(deadline-expired rids excepted).

``--check`` also enforces the lockdep rule: any
``lockdep_violation`` record fails the gate outright — the sanitizer
(``locks.py`` under ``HETU_LOCKDEP=1``) only emits one after
proving a lock-order inversion, a blocking call under a held lock, or
a hold past ``HETU_LOCKDEP_HOLD_MS``, so presence is the finding.
"""

from __future__ import annotations

import argparse
import json
import os

from .. import envvars
from .events import STREAMS, validate_record

# kind -> (duration field in ms, track name); t marks the end for the
# serving kinds (their emitter stamps after the phase completes)
_DUR_FIELDS = {
    "span": ("ms", None),              # name comes from the record
    "req_span": ("ms", None),          # name = the lifecycle phase
    "serve_prefill": ("prefill_ms", "serve.prefill"),
    "serve_step": ("decode_ms", "serve.decode"),
}
_T_IS_END = ("serve_prefill", "serve_step")

# serve_step fields worth a counter track alongside the wave span
_STEP_COUNTERS = (("queue_depth", "serve.queue_depth"),
                  ("live", "serve.live"))


def configured_logs():
    """Every stream log path currently set in the environment."""
    paths = []
    for env in list(STREAMS.values()) + ["HETU_TELEMETRY_LOG"]:
        if env:
            p = envvars.get_path(env)
            if p and p not in paths:
                paths.append(p)
    return paths


def read_events(paths, strict=False):
    """Parse + merge JSONL files, time-sorted.  Bad lines are counted,
    not fatal (a crashed writer may leave a torn tail) unless
    ``strict``."""
    events, bad = [], 0
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                bad += 1
                if strict:
                    raise
                continue
            if isinstance(rec, dict) and "t" in rec and "event" in rec:
                rec["_src"] = os.path.basename(path)
                events.append(rec)
            else:
                bad += 1
    events.sort(key=lambda r: (r.get("t", 0.0)))
    return events, bad


def to_chrome_trace(events):
    """Chrome trace-event JSON (Perfetto-loadable): spans as complete
    ("X") events, gauges + serve_step depths as counter ("C") tracks,
    request lifecycles as per-request ``req:<id>`` tracks with flow
    arrows into the engine's fused-step wave spans, point events as
    instants ("i"), with thread-name metadata so tracks read as the
    emitting thread."""
    out = []
    tids = {}
    waves = []          # (start_us, end_us, pid, tid, request ids)
    decode_spans = {}   # request id -> (start_us, end_us, pid, tid)

    def tid_for(pid, name):
        key = (pid, name)
        if key not in tids:
            tids[key] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tids[key], "args": {"name": str(name)}})
        return tids[key]

    n_spans = 0
    for rec in events:
        kind = rec.get("event")
        pid = int(rec.get("pid", 0))
        if kind == "req_span":
            # lifecycle phases live on the request's own track
            track = f"req:{rec.get('request')}"
        else:
            track = rec.get("tid", rec.get("_src", "events"))
        tid = tid_for(pid, track)
        ts_us = float(rec.get("t", 0.0)) * 1e6
        args = {k: v for k, v in rec.items()
                if k not in ("t", "event", "pid", "tid", "_src")
                and isinstance(v, (int, float, str, bool))}
        if kind == "gauge":
            out.append({"name": str(rec.get("name")), "cat": "gauge",
                        "ph": "C", "ts": ts_us, "pid": pid,
                        "tid": tid_for(pid, "counters"),
                        "args": {"value": rec.get("value")}})
            continue
        dur_spec = _DUR_FIELDS.get(kind)
        dur_ms = (rec.get(dur_spec[0])
                  if dur_spec is not None else None)
        if isinstance(dur_ms, (int, float)):
            dur_us = float(dur_ms) * 1e3
            if kind in _T_IS_END:
                ts_us -= dur_us
            name = (rec.get("name") or rec.get("phase")
                    or dur_spec[1] or kind)
            out.append({"name": str(name), "cat": kind, "ph": "X",
                        "ts": ts_us, "dur": dur_us, "pid": pid,
                        "tid": tid, "args": args})
            n_spans += 1
            if kind == "serve_step":
                for field, cname in _STEP_COUNTERS:
                    if isinstance(rec.get(field), (int, float)):
                        out.append({
                            "name": cname, "cat": "gauge", "ph": "C",
                            "ts": ts_us, "pid": pid,
                            "tid": tid_for(pid, "counters"),
                            "args": {"value": rec[field]}})
                reqs = rec.get("requests")
                if isinstance(reqs, (list, tuple)):
                    waves.append((ts_us, ts_us + dur_us, pid, tid,
                                  [str(r) for r in reqs]))
            elif kind == "req_span" and rec.get("phase") == "decode":
                decode_spans[str(rec.get("request"))] = \
                    (ts_us, ts_us + dur_us, pid, tid)
        else:
            out.append({"name": str(kind), "cat": "event", "ph": "i",
                        "s": "t", "ts": ts_us, "pid": pid, "tid": tid,
                        "args": args})
    # flow arrows: each request's decode span -> the engine wave spans
    # it participated in (s on the request track, t bound inside each
    # wave slice, f back on the request track at retire)
    n_flows = 0
    for rid, (d0, d1, rpid, rtid) in sorted(decode_spans.items()):
        hits = [(w0, wpid, wtid) for w0, w1, wpid, wtid, reqs in waves
                if rid in reqs]
        if not hits:
            continue
        flow = {"name": "req_flow", "cat": "req", "id": rid}
        out.append({**flow, "ph": "s", "ts": d0, "pid": rpid,
                    "tid": rtid})
        for w0, wpid, wtid in sorted(hits):
            # clamp into the decode span: the wave's backdated start
            # can drift past the request's retire stamp by scheduler-
            # loop overhead (the two are stamped at different points of
            # the same iteration), and flow steps must stay s <= t <= f
            out.append({**flow, "ph": "t",
                        "ts": min(max(w0, d0), d1),
                        "pid": wpid, "tid": wtid})
        out.append({**flow, "ph": "f", "bp": "e", "ts": d1,
                    "pid": rpid, "tid": rtid})
        n_flows += 1
    return {"traceEvents": out, "displayTimeUnit": "ms"}, n_spans


def check_span_balance(events):
    """The request span-balance rule: every ``serve_admit`` must pair
    with a ``serve_finish`` for the same request id (and vice versa —
    a finish with no admit is a torn or miswired log).  Returns problem
    strings; empty on a balanced stream.  A stream containing a
    ``flight_dump`` header is a mid-flight snapshot and is exempt.

    Fleet streams (serve events tagged ``replica=<k>`` by the router's
    engines) are checked per replica too: an admit on replica k must
    finish ON replica k — a leaked slot on one replica is invisible to
    the set-based rule once a same-id request retires elsewhere —
    UNLESS a ``router_hop`` record shows the router requeued the
    request off a dead replica, in which case finishing on *some*
    replica is the contract (requeue hops are exempt from the
    per-replica pairing, like flight dumps are from the whole rule)."""
    if any(e.get("event") == "flight_dump" for e in events):
        return []
    admits, finishes = {}, {}     # request id -> set of replica tags
    hopped = set()                # requests the router requeued
    for e in events:
        kind = e.get("event")
        if kind == "serve_admit":
            admits.setdefault(e.get("request"), set()).add(
                e.get("replica"))
        elif kind == "serve_finish":
            finishes.setdefault(e.get("request"), set()).add(
                e.get("replica"))
        elif kind == "router_hop":
            hopped.add(e.get("request"))
    problems = []
    for rid in sorted(str(r) for r in set(admits) - set(finishes)):
        problems.append(f"span-balance: request {rid!r} admitted but "
                        f"never finished/retired")
    for rid in sorted(str(r) for r in set(finishes) - set(admits)):
        problems.append(f"span-balance: request {rid!r} finished "
                        f"without a matching admit")
    for rid in sorted(admits, key=str):
        if rid not in finishes or rid in hopped:
            continue
        for rep in sorted(admits[rid] - finishes[rid],
                          key=lambda x: str(x)):
            if rep is None:
                continue   # untagged single-engine stream: set rule
            problems.append(
                f"span-balance: request {rid!r} admitted on replica "
                f"{rep} but finished elsewhere with no router_hop "
                f"(leaked slot?)")
    return problems


def check_gather_balance(events):
    """The gather-phase rule (embedding serving): every ``req_retire``
    carrying a ``gather_ms`` component must pair with a ``req_span``
    record of phase "gather" for the same request — a retirement that
    billed gather time without tracing the phase is a torn lifecycle
    (and the reverse, a gather span with no retirement, a leaked
    request).  GPT retirements (no ``gather_ms`` field) are skipped;
    flight-dump streams are exempt (mid-flight snapshot)."""
    if any(e.get("event") == "flight_dump" for e in events):
        return []
    retired, spanned = set(), set()
    for e in events:
        kind = e.get("event")
        if kind == "req_retire" and e.get("gather_ms") is not None:
            retired.add(e.get("request"))
        elif kind == "req_span" and e.get("phase") == "gather":
            spanned.add(e.get("request"))
    problems = []
    for rid in sorted(str(r) for r in retired - spanned):
        problems.append(
            f"gather-balance: request {rid!r} retired with a "
            f"gather_ms component but no req_span phase=gather")
    for rid in sorted(str(r) for r in spanned - retired):
        problems.append(
            f"gather-balance: request {rid!r} traced a gather phase "
            f"but never retired with a gather_ms component")
    return problems


def check_handoff_balance(events):
    """The KV-handoff pairing rule: every ``kv_handoff_out``
    must pair with a ``kv_handoff_in`` for the same request — blocks
    that left a replica must land on one — and vice versa (an import
    with no export is a miswired log); the out/in counts must match
    (one landing per departure).  A handed-off request must also still
    retire exactly ONCE per router admission: the prefill clone and the
    real request each admit+finish on their engines, so its stream
    carries exactly two ``serve_finish`` records — more means a
    duplicate retirement leaked through, fewer a lost phase.  Requests
    with a ``router_hop`` are exempt from the finish count (a requeue
    legitimately re-runs a phase — the same exemption the per-replica
    span-balance rule grants), and flight-dump streams are exempt
    entirely (mid-flight snapshot)."""
    if any(e.get("event") == "flight_dump" for e in events):
        return []
    outs, ins, finishes = {}, {}, {}
    hopped = set()
    for e in events:
        kind = e.get("event")
        rid = e.get("request")
        if kind == "kv_handoff_out":
            outs[rid] = outs.get(rid, 0) + 1
        elif kind == "kv_handoff_in":
            ins[rid] = ins.get(rid, 0) + 1
        elif kind == "serve_finish":
            finishes[rid] = finishes.get(rid, 0) + 1
        elif kind == "router_hop":
            hopped.add(rid)
    problems = []
    for rid in sorted(str(r) for r in set(outs) - set(ins)):
        problems.append(f"handoff: request {rid!r} exported KV "
                        f"(kv_handoff_out) that never landed "
                        f"(no kv_handoff_in)")
    for rid in sorted(str(r) for r in set(ins) - set(outs)):
        problems.append(f"handoff: request {rid!r} imported KV "
                        f"(kv_handoff_in) that was never exported")
    for rid in sorted(set(outs) & set(ins), key=str):
        if outs[rid] != ins[rid]:
            problems.append(
                f"handoff: request {rid!r} has {outs[rid]} exports "
                f"but {ins[rid]} imports")
    for rid in sorted(set(outs) & set(ins), key=str):
        n = finishes.get(rid, 0)
        if rid in hopped or n == 0:
            continue    # requeue re-runs a phase / engine log absent
        if n != 2:
            problems.append(
                f"handoff: request {rid!r} was handed off but "
                f"retired {n} time(s) — expected exactly 2 "
                f"(prefill clone + real request)")
    return problems


def check_scale_balance(events):
    """The elastic-fleet pairing rule: every ``scale_up``
    must pair with a ``replica_ready`` on the same replica (the
    bring-up probe passed and the replica was admitted) and every
    ``scale_down`` with a ``replica_retired`` there (the drain
    completed) — an unpaired scale event is a membership change that
    never finished.  Replica indexes are never reused (a retired slot's
    index stays burned), so one pairing per index is exact.  Each rid a
    ``replica_retired`` names as drained must retire exactly once on a
    PEER: never on the draining replica itself (a finish there after
    the drain means the corpse kept serving), never twice fleet-wide,
    and never zero times (a lost drain).  Rids that expired at their
    deadline (``router_deadline``) are exempt — expiry is an accounted
    outcome, not a loss — and streams without any ``serve_finish``
    records skip the rid-level audit (the engine log was not merged
    in).  The audit is ORDER-aware over the merged stream: a finish
    BEFORE the drain (a handed-off rid's prefill clone, say) is
    legitimate; what must hold is exactly one finish AFTER it, on a
    peer.  Flight-dump streams are mid-flight snapshots: exempt
    entirely."""
    if any(e.get("event") == "flight_dump" for e in events):
        return []
    ups, downs, ready, retired = set(), set(), set(), set()
    drained = {}          # rid -> retiring replica index
    post = {}             # rid -> [replica finishing AFTER the drain]
    deadline = set()
    have_finish = False
    for e in events:
        kind = e.get("event")
        rep = e.get("replica")
        if kind == "scale_up":
            ups.add(rep)
        elif kind == "scale_down":
            downs.add(rep)
        elif kind == "replica_ready":
            ready.add(rep)
        elif kind == "replica_retired":
            retired.add(rep)
            for rid in e.get("rids") or ():
                drained[rid] = rep
                post.setdefault(rid, [])
        elif kind == "serve_finish":
            have_finish = True
            rid = e.get("request")
            if rid in drained:
                post[rid].append(rep)
        elif kind == "router_deadline":
            deadline.add(e.get("request"))
    problems = []
    for rep in sorted(ups - ready, key=str):
        problems.append(
            f"scale: scale_up of replica {rep} never reached "
            f"replica_ready — the bring-up probe failed or the scale "
            f"action was abandoned")
    for rep in sorted(downs - retired, key=str):
        problems.append(
            f"scale: scale_down of replica {rep} never reached "
            f"replica_retired — the drain was abandoned")
    if have_finish:
        for rid in sorted(drained, key=str):
            if rid in deadline:
                continue
            where = post[rid]
            if not where:
                problems.append(
                    f"scale: request {rid!r} was drained off retiring "
                    f"replica {drained[rid]} but never retired "
                    f"anywhere — a lost drain")
            elif drained[rid] in where:
                problems.append(
                    f"scale: request {rid!r} retired on replica "
                    f"{drained[rid]} AFTER it was drained off it — "
                    f"the draining replica kept serving")
            elif len(where) > 1:
                problems.append(
                    f"scale: drained request {rid!r} retired "
                    f"{len(where)} times after the drain (replicas "
                    f"{sorted(where)}) — expected exactly once on a "
                    f"peer")
    return problems


def check_tier_balance(events):
    """The tiered-KV pairing rule: a ``kv_spill`` opens a
    tier residency for its prefix; exactly ONE terminal event closes
    it — a ``kv_fetch`` (the payload was re-admitted into a pool) or a
    ``kv_tier_drop`` (ring overflow past a dead/absent PS, corruption,
    shutdown).  The audit is ORDER-aware per prefix hash over the
    merged stream: a second spill while the first residency is still
    open is a double-spill (a refresh must NOT re-emit); a fetch or
    drop with no open residency closes nothing (a fabricated fetch);
    and a residency still open at end-of-stream is a leak — completed
    runs call ``TieredKVStore.close()``, which drops every resident.
    Note a host->PS demotion inside the ladder is NOT an event (the
    residency merely moved rungs).  Flight-dump streams are mid-flight
    snapshots: exempt entirely."""
    if any(e.get("event") == "flight_dump" for e in events):
        return []
    open_res = {}          # prefix hash -> count of open residencies
    problems = []
    for e in events:
        kind = e.get("event")
        if kind not in ("kv_spill", "kv_fetch", "kv_tier_drop"):
            continue
        h = e.get("prefix")
        n = open_res.get(h, 0)
        if kind == "kv_spill":
            if n > 0:
                problems.append(
                    f"tier-balance: prefix {h!r} spilled while already "
                    f"tier-resident — a refresh re-emitted kv_spill")
            open_res[h] = n + 1
        else:
            if n <= 0:
                problems.append(
                    f"tier-balance: prefix {h!r} saw {kind} with no "
                    f"open tier residency — nothing was spilled")
            else:
                open_res[h] = n - 1
    for h in sorted(k for k, n in open_res.items() if n > 0):
        problems.append(
            f"tier-balance: prefix {h!r} still tier-resident at end "
            f"of stream — no terminal kv_fetch/kv_tier_drop (close() "
            f"not called?)")
    return problems


def check_quant_consistency(events):
    """The mixed-quantization rule: every ``bench_row`` record in one
    stream must carry the SAME ``quant`` stamp (rows predating the
    stamp count as "off" — they were measured exact).  A stream mixing
    int8-wire/int8-KV rows with exact rows is not comparable: the
    quantized run moves ~4x fewer bytes, so ranking them side by side
    silently rewards the lossy configuration.  Returns problem strings;
    empty when consistent (or when there are no bench rows)."""
    by_quant = {}
    for e in events:
        if e.get("event") != "bench_row":
            continue
        by_quant.setdefault(str(e.get("quant") or "off"), []).append(
            str(e.get("config")))
    if len(by_quant) <= 1:
        return []
    detail = "; ".join(f"{q}: {sorted(set(c))}"
                       for q, c in sorted(by_quant.items()))
    return [f"quant-mix: bench rows were measured under different "
            f"quantization modes and cannot be compared ({detail}) — "
            f"re-run one side or split the streams"]


def check_spec_attribution(events):
    """The speculative-attribution rule: per retired request, accepted
    draft tokens + bonus samples + the prefill token must equal the
    retired sequence length (``n_generated``) — a mismatch means the
    engine emitted tokens it never accounted for, or rolled back tokens
    it already reported.  Records WITHOUT spec fields (non-speculative
    engines) are skipped; rejected drafts are exempt by construction
    (they are not part of the sum).  Returns problem strings."""
    problems = []
    for e in events:
        if e.get("event") != "req_retire":
            continue
        acc = e.get("spec_accepted")
        if acc is None:
            continue
        bonus = e.get("spec_bonus", 0)
        n = e.get("n_generated")
        if not all(isinstance(v, int) for v in (acc, bonus, n)):
            problems.append(
                f"spec-attribution: request {e.get('request')!r} "
                f"carries non-integer spec fields")
            continue
        if acc + bonus + 1 != n:
            problems.append(
                f"spec-attribution: request {e.get('request')!r} "
                f"retired {n} tokens but accounts for "
                f"{acc} accepted + {bonus} bonus + 1 prefill "
                f"= {acc + bonus + 1}")
    return problems


def check_moe_attribution(events):
    """The MoE routing-attribution rule: per ``serve_step``
    record, routed + dropped expert assignments must equal the wave's
    token count × top_k × MoE layer count — capacity overflow re-routes
    a token to the residual path (``moe_dropped``), it NEVER vanishes
    from the ledger, so the two sides always balance.  Records without
    ``moe_routed`` (dense engines) are exempt; a MoE record missing any
    of its companion fields is itself a violation.  Returns problem
    strings."""
    problems = []
    for e in events:
        if e.get("event") != "serve_step":
            continue
        routed = e.get("moe_routed")
        if routed is None:
            continue
        fields = {k: e.get(f"moe_{k}")
                  for k in ("tokens", "dropped", "k", "layers")}
        if not all(isinstance(v, int) for v in fields.values()) \
                or not isinstance(routed, int):
            problems.append(
                f"moe-attribution: step {e.get('step')!r} carries "
                f"moe_routed without complete integer companions "
                f"{sorted(k for k, v in fields.items() if not isinstance(v, int))}")
            continue
        want = fields["tokens"] * fields["k"] * fields["layers"]
        if routed + fields["dropped"] != want:
            problems.append(
                f"moe-attribution: step {e.get('step')!r} routed "
                f"{routed} + dropped {fields['dropped']} = "
                f"{routed + fields['dropped']} expert assignments but "
                f"{fields['tokens']} tokens x top_k {fields['k']} x "
                f"{fields['layers']} MoE layer(s) = {want} — a token "
                f"left the routing ledger")
    return problems


def check_lockdep(events):
    """The lockdep rule: a ``lockdep_violation`` record in
    the stream IS a finding — the sanitizer only emits after it proved
    a lock-order inversion (a cycle in the acquisition graph), a
    blocking call (PS RPC, multi-MB wire encode) under a held lock, or
    a hold longer than ``HETU_LOCKDEP_HOLD_MS``.  Presence fails the
    gate; the record's ``kind``/``lock``/``other``/``site`` fields and
    the in-process report (``analysis.concurrency.lockdep_report``)
    carry both acquisition stacks."""
    problems = []
    for e in events:
        if e.get("event") != "lockdep_violation":
            continue
        msg = (f"lockdep: {e.get('kind')} violation on lock "
               f"{e.get('lock')!r}")
        if e.get("other"):
            msg += f" vs {e.get('other')!r}"
        if e.get("site"):
            msg += f" at {e.get('site')}"
        problems.append(msg)
    return problems


def check_version_coherence(events):
    """The live-weight-sync rule: no retirement may mix
    tokens from two weight versions.  Every per-request record
    (``serve_submit``/``serve_admit``/``serve_finish``, ``req_span``,
    ``req_retire``) carries the ``weight_version`` tag of the engine
    that emitted it, and a rolling swap only lands on a DRAINED
    replica — so all of one request's records must agree on a single
    version.  The one legal exception is a router requeue
    (``router_hop`` names the request): a request admitted pre-swap
    that loses its replica legitimately re-admits — token-identically
    — on a peer that may already run the new version.  A prefill ->
    decode handoff pair is exempt the same way (each phase admits on
    its own replica; a rollout may pass between them).  Streams from a
    flight-recorder dump are mid-flight snapshots and are exempt, as
    are unversioned fleets (no ``weight_version`` tags anywhere)."""
    if any(e.get("event") == "flight_dump" for e in events):
        return []
    versions, exempt = {}, set()
    for e in events:
        kind = e.get("event")
        rid = e.get("request")
        if kind in ("router_hop", "kv_handoff_out", "kv_handoff_in"):
            exempt.add(rid)
            continue
        v = e.get("weight_version")
        if rid is None or v is None:
            continue
        versions.setdefault(rid, set()).add(v)
    problems = []
    for rid in sorted(versions, key=str):
        vs = versions[rid]
        if len(vs) > 1 and rid not in exempt:
            problems.append(
                f"version-coherence: request {rid!r} carries records "
                f"from weight versions {sorted(vs)} with no router "
                f"requeue — a swap landed under a live request")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="hetu_trace",
        description="Merge the telemetry JSONL streams; optionally "
                    "export a Chrome/Perfetto trace of the spans.")
    ap.add_argument("paths", nargs="*",
                    help="JSONL files (default: every HETU_*_LOG / "
                         "HETU_TELEMETRY_LOG set in the environment)")
    ap.add_argument("--export", metavar="TRACE_JSON",
                    help="write a Perfetto-loadable trace.json and "
                         "print a summary line instead of the stream")
    ap.add_argument("--last", type=int, default=None, metavar="N",
                    help="only the newest N records (tail semantics)")
    ap.add_argument("--events", default=None,
                    help="comma-separated kind filter "
                         "(e.g. span,serve_step)")
    ap.add_argument("--check", action="store_true",
                    help="validate every record against the event "
                         "contract AND the request span-balance rule "
                         "(every serve_admit has a serve_finish), the "
                         "quant-mix rule, the speculative-attribution "
                         "rule (accepted + bonus + 1 == n_generated "
                         "per retired request), and the KV-handoff "
                         "pairing rule (every kv_handoff_out has a "
                         "kv_handoff_in, one retirement per "
                         "admission), the gather-balance rule "
                         "(every embed retirement billing gather_ms "
                         "traced a gather phase), and the "
                         "version-coherence rule (no retirement mixes "
                         "weight versions; a request only changes "
                         "version across a router requeue), and the "
                         "scale-balance rule (every scale_up pairs "
                         "with a replica_ready, every scale_down with "
                         "a replica_retired whose drained rids each "
                         "retire exactly once on a peer), and the "
                         "tier-balance rule (every kv_spill closes "
                         "with exactly one kv_fetch or kv_tier_drop "
                         "for its prefix), and the lockdep rule (any "
                         "lockdep_violation record — a proved lock-"
                         "order inversion, blocking-under-lock, or "
                         "long hold — fails the gate), and the MoE "
                         "routing-attribution rule (per serve_step, "
                         "routed + dropped == tokens x top_k x MoE "
                         "layers; dense steps exempt); exit 1 on "
                         "violations")
    args = ap.parse_args(argv)

    paths = args.paths or configured_logs()
    if not paths:
        ap.error("no paths given and no HETU_*_LOG configured")
    events, bad = read_events(paths)
    if args.events:
        kinds = {k.strip() for k in args.events.split(",") if k.strip()}
        events = [e for e in events if e.get("event") in kinds]
    if args.last:
        events = events[-args.last:]

    if args.check:
        problems = []
        for rec in events:
            for p in validate_record(rec):
                problems.append(f"{rec.get('_src')}: {p}: "
                                f"{json.dumps(rec)[:160]}")
        balance = check_span_balance(events)
        problems.extend(balance)
        qmix = check_quant_consistency(events)
        problems.extend(qmix)
        spec = check_spec_attribution(events)
        problems.extend(spec)
        handoff = check_handoff_balance(events)
        problems.extend(handoff)
        gather = check_gather_balance(events)
        problems.extend(gather)
        version = check_version_coherence(events)
        problems.extend(version)
        scale = check_scale_balance(events)
        problems.extend(scale)
        tier = check_tier_balance(events)
        problems.extend(tier)
        lockdep = check_lockdep(events)
        problems.extend(lockdep)
        moe = check_moe_attribution(events)
        problems.extend(moe)
        for p in problems:
            print(p)
        print(json.dumps({"records": len(events), "bad_lines": bad,
                          "contract_violations": len(problems),
                          "span_balance_violations": len(balance),
                          "quant_mix_violations": len(qmix),
                          "spec_attribution_violations": len(spec),
                          "handoff_violations": len(handoff),
                          "gather_violations": len(gather),
                          "version_violations": len(version),
                          "scale_balance_violations": len(scale),
                          "tier_balance_violations": len(tier),
                          "lockdep_violations": len(lockdep),
                          "moe_attribution_violations": len(moe)}))
        return 1 if problems or bad else 0

    if args.export:
        trace, n_spans = to_chrome_trace(events)
        with open(args.export, "w") as f:
            json.dump(trace, f)
        print(json.dumps({
            "records": len(events), "bad_lines": bad,
            "spans": n_spans,
            "trace_events": len(trace["traceEvents"]),
            "out": args.export}))
        return 0

    for rec in events:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
