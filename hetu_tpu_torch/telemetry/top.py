"""hetu_top: a live terminal dashboard over the merged telemetry stream.

``python -m hetu_tpu_torch.telemetry.top`` is the CLI (``hetu_top``
below).  It tails the same contract-shaped JSONL
files ``hetu_trace`` merges (default: every ``HETU_*_LOG`` configured in
the environment) and renders the serving engine's vitals in place:

- engine: batch occupancy, live slots, queue depth, fused-step count;
- paged KV pool: blocks free / shared, registered prefixes (the
  ``gauge`` records kv_manager emits);
- latency: TTFT and TPOT percentiles over the visible window (TPOT
  from per-step emitted-token counts — ``serve_step.new_tokens`` — so
  speculative waves emitting several tokens per step are weighted
  correctly; old logs without the field fall back to per-request
  retire records);
- speculation: drafted vs accepted token counts, acceptance rate, and
  mean per-wave draft length (the ``spec_*`` fields speculative
  engines stamp on every ``serve_step``);
- SLO: current health state (ok/degraded/breach), burn rate, violation
  count — the same signal ``ServingEngine.health()`` returns;
- incidents: flight-recorder dumps and queue rejections.

Everything is derived from the log records alone (no live process
hookup): point ``hetu_top`` at a dead run's log and it renders the
final state — the "what was it doing" companion to the flight
recorder's "what happened".  ``--once`` renders a single frame and
exits (scripts, tests); otherwise the screen refreshes every
``--interval`` seconds until Ctrl-C.

``--fleet`` switches to the ServingRouter view: one row per replica
(state/health, prefill/decode/mixed role, occupancy, queue depth,
breaker state, routed/requeue/reject/death counts, directory hit
rate) assembled from the ``replica``-tagged serve events plus the
router's ``router_route``/``router_hop``/``router_breaker`` and the
supervisor's ``replica_*`` failure records, with fleet totals (shed
by class, requeues, pressure, prefix-directory hits/misses/steals,
KV handoffs) underneath.  The role column reads the ``role`` tag the
replica's engine stamps on its serve events; the directory columns
read the ``directory=hit/steal/miss/stale`` verdicts the router
stamps on its ``router_route`` records.

Live weight sync: the single-engine view shows the current
``weight_version`` and the last-swap timestamp (from ``weight_swap``
records); ``--fleet`` grows a per-replica ``ver`` column (the
``weight_version`` tag riding each replica's serve events) and a
rollout-progress footer (``rollout   rolling 1/2 → v7``) assembled
from the coordinator's ``rollout_*`` records.

MoE serving: MoE engines stamp ``moe_*`` fields on every
``serve_step`` — the single-engine view grows an ``experts`` panel
(routed/dropped assignments, max/mean load imbalance, drop rate from
the ``serve.expert_load``/``serve.expert_drops`` counters' step-level
twins) and ``--fleet`` grows per-replica ``imb``/``drop%`` columns;
dense replicas render "-".

Elastic fleet: ``--fleet`` grows a per-replica ``life``
column (warming/serving/draining/retired, from the router's
``replica_warming``/``replica_ready``/``replica_draining``/
``replica_retired`` lifecycle records) and an autoscale footer —
last scale action + reason, target vs. actual replicas, and the
worst-burn / pressure signal that drove it (``scale_up``/
``scale_down`` events plus the ``fleet.burn``/``fleet.replicas``
gauges the autoscaler emits each tick).
"""

from __future__ import annotations

import argparse
import time

from .metrics import percentile
from .trace import configured_logs, read_events


def _pct_ms(xs, q):
    v = percentile(xs, q) if xs else None
    return None if v is None else v


def summarize(events, window=512):
    """Dashboard stats from the newest ``window`` records of a merged,
    time-sorted stream (``read_events`` output)."""
    events = events[-window:] if window else events
    gauges = {}
    ttft_ms, tpot_ms = [], []
    counts = {"submitted": 0, "finished": 0, "rejected": 0}
    steps = []
    slo = {"state": None, "burn_rate": None, "violations": 0}
    flight_dumps = 0
    workload = None
    weight_version = None
    last_swap_t = None
    for e in events:
        kind = e.get("event")
        # live weight sync: the weight_version tag rides every serve
        # event once the engine is version-stamped; a weight_swap
        # record marks the last rolling-swap instant
        if e.get("weight_version") is not None:
            weight_version = e.get("weight_version")
        if kind == "weight_swap":
            last_swap_t = e.get("t")
            if e.get("version") is not None:
                weight_version = e.get("version")
        # the workload tag embed engines stamp on every serve event;
        # untagged streams (GPT engines predate the tag) default "gpt"
        if kind and kind.startswith("serve_") and \
                e.get("workload") is not None:
            workload = e.get("workload")
        if kind == "gauge":
            gauges[e.get("name")] = e.get("value")
        elif kind == "serve_step":
            steps.append(e)
        elif kind == "serve_submit":
            counts["submitted"] += 1
        elif kind == "serve_finish":
            counts["finished"] += 1
        elif kind == "serve_queue_reject":
            counts["rejected"] += 1
        elif kind == "serve_admit":
            if isinstance(e.get("ttft_s"), (int, float)):
                ttft_ms.append(e["ttft_s"] * 1e3)
        elif kind == "req_retire":
            n = e.get("n_generated")
            d = e.get("decode_ms")
            if isinstance(n, int) and n > 1 and \
                    isinstance(d, (int, float)) and d > 0:
                tpot_ms.append(d / (n - 1))
        elif kind == "slo_health":
            slo["state"] = e.get("state")
            slo["burn_rate"] = e.get("burn_rate")
        elif kind == "slo_violation":
            slo["violations"] += 1
        elif kind == "flight_dump":
            flight_dumps += 1
    last = steps[-1] if steps else {}
    occupancy = gauges.get("serve.occupancy")
    if occupancy is None and isinstance(last.get("live"), int) and \
            isinstance(last.get("slots"), int) and last["slots"]:
        occupancy = round(last["live"] / last["slots"], 4)
    tok_s = None
    if len(steps) >= 2:
        span = steps[-1].get("t", 0) - steps[0].get("t", 0)
        if span > 0:
            tok_s = round(sum(s.get("new_tokens", s.get("live", 0))
                              for s in steps) / span, 1)
    # TPOT from real per-step token counts (a speculative wave emits
    # up to k+1 per slot); retire-record fallback for old logs
    step_tpot = []
    for s in steps:
        n, d = s.get("new_tokens"), s.get("decode_ms")
        if isinstance(n, int) and n > 0 and isinstance(d, (int, float)):
            step_tpot.extend([d / n] * n)
    if step_tpot:
        tpot_ms = step_tpot
    drafted = accepted = 0
    spec_ks = []
    # mixed-mode ragged dispatch ($HETU_SERVE_RAGGED): serve_step
    # events carry the wave's per-mode q-token split — how many query
    # rows were prompt prefill vs spec-verify vs plain decode
    mix_tot = {"q_prefill": 0, "q_verify": 0, "q_decode": 0}
    mix_steps = 0
    for s in steps:
        if isinstance(s.get("spec_proposed"), int):
            drafted += s["spec_proposed"]
            accepted += s.get("spec_accepted", 0)
            if isinstance(s.get("spec_k"), int):
                spec_ks.append(s["spec_k"])
        if isinstance(s.get("q_prefill"), int):
            mix_steps += 1
            for f in mix_tot:
                mix_tot[f] += s.get(f, 0) or 0
    mix = {**mix_tot, "steps": mix_steps} if mix_steps else None
    # MoE serving: serve_step events from MoE engines carry
    # the wave's routing outcome — expert-load imbalance (max/mean) is
    # THE MoE production failure mode, so it gets a panel
    moe_routed = moe_dropped = 0
    moe_imb = None
    moe_steps = 0
    for s in steps:
        if isinstance(s.get("moe_routed"), int):
            moe_steps += 1
            moe_routed += s["moe_routed"]
            moe_dropped += s.get("moe_dropped", 0) or 0
            if isinstance(s.get("moe_imb"), (int, float)):
                moe_imb = s["moe_imb"]
    if moe_imb is None:
        moe_imb = gauges.get("serve.expert_imbalance")
    moe = None
    if moe_steps:
        tot = moe_routed + moe_dropped
        moe = {"routed": moe_routed, "dropped": moe_dropped,
               "imbalance": moe_imb,
               "drop_rate": round(moe_dropped / tot, 4) if tot else 0.0}
    spec = {
        "drafted": drafted,
        "accepted": accepted,
        "acceptance": round(accepted / drafted, 4) if drafted else None,
        "mean_k": (round(sum(spec_ks) / len(spec_ks), 2)
                   if spec_ks else None),
    }
    if slo["burn_rate"] is None:
        slo["burn_rate"] = gauges.get("serve.slo_burn")
    if slo["state"] is None:
        slo["state"] = {0: "ok", 1: "degraded", 2: "breach"}.get(
            gauges.get("serve.health"), "ok")
    return {
        "records": len(events),
        "workload": workload or "gpt",
        "occupancy": occupancy,
        "live": last.get("live"),
        "slots": last.get("slots"),
        "queue_depth": last.get("queue_depth"),
        "steps": len(steps),
        "tokens_per_sec": tok_s,
        "blocks_free": gauges.get("serve.blocks_free"),
        "blocks_shared": gauges.get("serve.blocks_shared"),
        "prefix_entries": gauges.get("serve.prefix_entries"),
        "ttft_p50_ms": _pct_ms(ttft_ms, 50),
        "ttft_p95_ms": _pct_ms(ttft_ms, 95),
        "ttft_p99_ms": _pct_ms(ttft_ms, 99),
        "tpot_p50_ms": _pct_ms(tpot_ms, 50),
        "tpot_p99_ms": _pct_ms(tpot_ms, 99),
        "requests": counts,
        "spec": spec,
        "mix": mix,
        "moe": moe,
        "slo": slo,
        "flight_dumps": flight_dumps,
        "weight_version": weight_version,
        "last_swap_t": last_swap_t,
    }


def summarize_fleet(events, window=4096):
    """Per-replica dashboard rows from a merged fleet stream: serve
    events tagged ``replica=<k>`` (each router replica's engine stamps
    its records), router placement/breaker events, and the
    supervisor's replica_* failure records."""
    events = events[-window:] if window else events
    per = {}

    def row(k):
        return per.setdefault(k, {
            "replica": k, "state": "up", "health": "ok", "role": None,
            "life": None, "workload": None, "version": None,
            "live": None, "slots": None, "queue_depth": None,
            "steps": 0, "breaker": "closed", "routed": 0,
            "requeued": 0, "rejects": 0, "deaths": 0, "restarts": 0,
            "finished": 0, "drafted": 0, "accepted": 0,
            "dir_lookups": 0, "dir_hits": 0,
            "q_prefill": 0, "q_verify": 0, "q_decode": 0,
            "moe_routed": 0, "moe_dropped": 0, "moe_imb": None,
        })

    shed = {"latency": 0, "throughput": 0}
    prefix = {"hits": 0, "misses": 0, "steals": 0, "stale": 0}
    # tiered KV: spill/fetch/drop ledger events plus the
    # directory's "tier" routing verdict (warm in a tier, no pool)
    tier = {"spills": 0, "fetches": 0, "drops": 0, "routed": 0,
            "ps_killed": 0}
    hops = handoffs = 0
    pressure = None
    rollout = None          # live-weight-sync progress footer
    autoscale = None        # elastic-fleet footer (scale_* events)
    fleet_burn = None       # latest fleet.burn gauge
    for e in events:
        kind = e.get("event")
        rep = e.get("replica")
        # the engine's metrics tags ride every serve event — a
        # role-tagged record pins the replica's prefill/decode/mixed kind
        if rep is not None and e.get("role") is not None:
            row(rep)["role"] = e.get("role")
        # the workload tag (embed engines stamp workload="embed" on
        # every serve event; untagged GPT streams render as "gpt")
        if rep is not None and e.get("workload") is not None:
            row(rep)["workload"] = e.get("workload")
        # the weight_version tag (live weight sync): the newest stamp
        # per replica is its current version
        if rep is not None and e.get("weight_version") is not None:
            row(rep)["version"] = e.get("weight_version")
        if kind == "serve_step" and rep is not None:
            r = row(rep)
            r["live"] = e.get("live")
            r["slots"] = e.get("slots")
            r["queue_depth"] = e.get("queue_depth")
            r["steps"] += 1
            if isinstance(e.get("spec_proposed"), int):
                r["drafted"] += e["spec_proposed"]
                r["accepted"] += e.get("spec_accepted", 0)
            if isinstance(e.get("q_prefill"), int):
                # mixed-mode wave: per-replica mode split
                r["q_prefill"] += e["q_prefill"]
                r["q_verify"] += e.get("q_verify", 0) or 0
                r["q_decode"] += e.get("q_decode", 0) or 0
            if isinstance(e.get("moe_routed"), int):
                # MoE serving: per-replica expert routing outcome —
                # the newest imbalance stamp is the replica's current
                # max/mean expert-load ratio
                r["moe_routed"] += e["moe_routed"]
                r["moe_dropped"] += e.get("moe_dropped", 0) or 0
                if isinstance(e.get("moe_imb"), (int, float)):
                    r["moe_imb"] = e["moe_imb"]
        elif kind == "slo_health" and rep is not None:
            row(rep)["health"] = e.get("state")
        elif kind == "serve_finish" and rep is not None:
            row(rep)["finished"] += 1
        elif kind == "serve_queue_reject" and rep is not None:
            row(rep)["rejects"] += 1
        elif kind == "router_route" and rep is not None:
            r = row(rep)
            r["routed"] += 1
            # directory verdict stamped on decode-phase placements:
            # hit/steal routed the request TO this replica's cached span
            d = e.get("directory")
            if d is not None:
                r["dir_lookups"] += 1
                if d in ("hit", "steal"):
                    r["dir_hits"] += 1
                if d == "hit":
                    prefix["hits"] += 1
                elif d == "steal":
                    prefix["steals"] += 1
                elif d == "stale":
                    prefix["stale"] += 1
                elif d == "miss":
                    prefix["misses"] += 1
                elif d == "tier":
                    tier["routed"] += 1
        elif kind == "kv_handoff_in":
            handoffs += 1
        elif kind == "kv_spill":
            tier["spills"] += 1
        elif kind == "kv_fetch":
            tier["fetches"] += 1
        elif kind == "kv_tier_drop":
            tier["drops"] += 1
        elif kind == "kvtier_ps_killed":
            tier["ps_killed"] += 1
        elif kind == "router_hop":
            hops += 1
            to = e.get("to_replica")
            if to is not None:
                r = row(to)
                r["routed"] += 1
                r["requeued"] += 1
        elif kind == "router_breaker" and rep is not None:
            row(rep)["breaker"] = e.get("state")
        elif kind == "rollout_start":
            rollout = {"version": e.get("version"), "done": 0,
                       "replicas": e.get("replicas"),
                       "state": ("rolling"
                                 if e.get("phase") != "rollback"
                                 else "rolling back")}
        elif kind == "rollout_advance" and rollout is not None:
            rollout["done"] = e.get("done", rollout["done"])
        elif kind == "rollout_done" and rollout is not None:
            rollout["state"] = ("done"
                                if e.get("phase") != "rollback"
                                else "rolled back")
        elif kind == "rollout_failed" and rollout is not None:
            rollout["state"] = "failed"
        elif kind == "router_shed":
            cls = e.get("slo_class")
            if cls in shed:
                shed[cls] += 1
        elif kind == "replica_start" and rep is not None:
            row(rep)["state"] = "up"
        elif kind == "replica_exit" and rep is not None:
            r = row(rep)
            r["deaths"] += 1
            r["state"] = "dead"
        elif kind == "replica_restart" and rep is not None:
            r = row(rep)
            r["restarts"] = e.get("attempt", r["restarts"] + 1)
            r["state"] = "up"
        elif kind == "replica_failed" and rep is not None:
            row(rep)["state"] = "failed"
        elif kind in ("scale_up", "scale_down"):
            # elastic fleet: the newest scale action wins the footer
            autoscale = {
                "action": kind, "replica": rep,
                "reason": e.get("reason"),
                "target": e.get("target"), "actual": e.get("actual"),
                "burn": e.get("burn"), "pressure": e.get("pressure"),
            }
        elif kind == "replica_warming" and rep is not None:
            row(rep)["life"] = "warming"
        elif kind == "replica_ready" and rep is not None:
            row(rep)["life"] = "serving"
        elif kind == "replica_draining" and rep is not None:
            row(rep)["life"] = "draining"
        elif kind == "replica_retired" and rep is not None:
            r = row(rep)
            r["life"] = "retired"
            r["state"] = "retired"
        elif kind == "gauge" and e.get("name") == "fleet.burn":
            fleet_burn = e.get("value")
        elif kind == "gauge" and e.get("name") == "fleet.replicas":
            if autoscale is not None:
                autoscale["actual"] = e.get("value")
        elif kind == "gauge" and e.get("name") == "router.pressure":
            pressure = e.get("value")
    for r in per.values():
        if isinstance(r["live"], int) and isinstance(r["slots"], int) \
                and r["slots"]:
            r["occupancy"] = round(r["live"] / r["slots"], 4)
        else:
            r["occupancy"] = None
        r["acceptance"] = (round(r["accepted"] / r["drafted"], 4)
                           if r["drafted"] else None)
        r["dir_hit_rate"] = (round(r["dir_hits"] / r["dir_lookups"], 4)
                             if r["dir_lookups"] else None)
        moe_tot = r["moe_routed"] + r["moe_dropped"]
        r["moe_drop_rate"] = (round(r["moe_dropped"] / moe_tot, 4)
                              if moe_tot else None)
    return {
        "records": len(events),
        "replicas": [per[k] for k in sorted(per)],
        "shed": shed,
        "requeues": hops,
        "prefix": prefix,
        "tier": tier,
        "handoffs": handoffs,
        "pressure": pressure,
        "rollout": rollout,
        "autoscale": autoscale,
        "fleet_burn": fleet_burn,
    }


def render_fleet(stats, clock=None):
    """One fleet frame as a string: a row per replica + fleet totals."""
    lines = [
        f"hetu_top --fleet — "
        f"{time.strftime('%H:%M:%S', time.gmtime(clock))} UTC"
        f"  ({stats['records']} records)",
        "-" * 72,
        f"{'rep':>3} {'state':<7} {'life':<8} {'role':<8} {'wkld':<6} "
        f"{'ver':>4} "
        f"{'health':<9} {'occ':>5} "
        f"{'live':>4} {'queue':>5} {'breaker':<9} {'routed':>6} "
        f"{'requeued':>8} {'rejects':>7} {'deaths':>6} "
        f"{'drafted':>7} {'acc':>5} {'dir%':>5} "
        f"{'qpre':>6} {'qver':>6} {'qdec':>6} "
        f"{'imb':>5} {'drop%':>6}",
    ]
    for r in stats["replicas"]:
        ver = r.get("version")
        # mixed-mode columns stay "-" for phase-split replicas (their
        # serve_step events carry no per-mode q split)
        mixed = (r.get("q_prefill", 0) or r.get("q_verify", 0)
                 or r.get("q_decode", 0))
        lines.append(
            f"{r['replica']:>3} {r['state']:<7} "
            f"{str(r.get('life') or '-'):<8} "
            f"{str(r.get('role') or '-'):<8} "
            f"{str(r.get('workload') or 'gpt'):<6} "
            f"{('v' + str(ver)) if ver is not None else '-':>4} "
            f"{str(r['health']):<9} "
            f"{_fmt(r['occupancy'], nd=2):>5} {_fmt(r['live']):>4} "
            f"{_fmt(r['queue_depth']):>5} {r['breaker']:<9} "
            f"{r['routed']:>6} {r['requeued']:>8} {r['rejects']:>7} "
            f"{r['deaths']:>6} {r['drafted']:>7} "
            f"{_fmt(r['acceptance'], nd=2):>5} "
            f"{_fmt(r.get('dir_hit_rate'), nd=2):>5} "
            f"{_fmt(r['q_prefill'] if mixed else None):>6} "
            f"{_fmt(r['q_verify'] if mixed else None):>6} "
            f"{_fmt(r['q_decode'] if mixed else None):>6} "
            # MoE columns stay "-" for dense replicas (their
            # serve_step events carry no moe_* fields)
            f"{_fmt(r.get('moe_imb'), nd=2):>5} "
            f"{_fmt(r.get('moe_drop_rate'), nd=4):>6}")
    shed = stats["shed"]
    pre = stats.get("prefix") or {}
    lines.append("-" * 72)
    lines.append(
        f"fleet     requeues {stats['requeues']}"
        f"  shed latency {shed['latency']}"
        f" / throughput {shed['throughput']}"
        f"  pressure {_fmt(stats['pressure'], nd=2)}")
    lines.append(
        f"prefix    hits {pre.get('hits', 0)}"
        f"  misses {pre.get('misses', 0)}"
        f"  steals {pre.get('steals', 0)}"
        f"  stale {pre.get('stale', 0)}"
        f"  handoffs {stats.get('handoffs', 0)}")
    tr = stats.get("tier") or {}
    if any(tr.values()):
        # tiered KV panel — only when the ladder saw traffic
        lines.append(
            f"kv-tier   spills {tr.get('spills', 0)}"
            f"  fetches {tr.get('fetches', 0)}"
            f"  drops {tr.get('drops', 0)}"
            f"  routed {tr.get('routed', 0)}"
            + ("  PS DEAD" if tr.get("ps_killed") else ""))
    ro = stats.get("rollout")
    if ro is not None:
        # "rollout   rolling 1/2 → v7" while in flight; terminal
        # states render as done/failed/rolled back
        lines.append(
            f"rollout   {ro['state']} {ro.get('done', 0)}"
            f"/{_fmt(ro.get('replicas'))} → v{_fmt(ro.get('version'))}")
    asc = stats.get("autoscale")
    if asc is not None:
        # elastic fleet: last scale action (target vs. actual replicas
        # + the signal that drove it) and the worst burn gauge
        lines.append(
            f"autoscale {asc['action']} r{_fmt(asc.get('replica'))}"
            f" ({_fmt(asc.get('reason'))})"
            f"  target {_fmt(asc.get('target'))}"
            f" actual {_fmt(asc.get('actual'))}"
            f"  burn {_fmt(stats.get('fleet_burn'), nd=2)}"
            f"  pressure {_fmt(asc.get('pressure'), nd=2)}")
    return "\n".join(lines)


def _fmt(v, suffix="", nd=1):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}{suffix}"
    return f"{v}{suffix}"


def render(stats, clock=None):
    """One dashboard frame as a string (ANSI-free: the CLI owns the
    clear-screen escape so tests can assert on plain text)."""
    s = stats
    r = s["requests"]
    slo = s["slo"]
    state = slo["state"] or "ok"
    badge = {"ok": "[ OK ]", "degraded": "[DEGR]",
             "breach": "[BRCH]"}.get(state, f"[{state}]")
    lines = [
        f"hetu_top — {time.strftime('%H:%M:%S', time.gmtime(clock))} UTC"
        f"  ({s['records']} records)",
        "-" * 64,
        f"engine    workload {s.get('workload') or 'gpt'}"
        f"  occupancy {_fmt(s['occupancy'])}"
        f"  live {_fmt(s['live'])}/{_fmt(s['slots'])}"
        f"  queue {_fmt(s['queue_depth'])}"
        f"  steps {_fmt(s['steps'])}"
        f"  tok/s {_fmt(s['tokens_per_sec'])}",
        f"weights   version "
        f"{('v' + str(s['weight_version'])) if s.get('weight_version') is not None else '-'}"
        f"  last_swap "
        + (time.strftime('%H:%M:%S', time.gmtime(s['last_swap_t']))
           if s.get('last_swap_t') else '-'),
        f"kv pool   blocks_free {_fmt(s['blocks_free'])}"
        f"  blocks_shared {_fmt(s['blocks_shared'])}"
        f"  prefixes {_fmt(s['prefix_entries'])}",
        f"requests  submitted {r['submitted']}"
        f"  finished {r['finished']}  rejected {r['rejected']}",
        f"TTFT ms   p50 {_fmt(s['ttft_p50_ms'])}"
        f"  p95 {_fmt(s['ttft_p95_ms'])}"
        f"  p99 {_fmt(s['ttft_p99_ms'])}",
        f"TPOT ms   p50 {_fmt(s['tpot_p50_ms'])}"
        f"  p99 {_fmt(s['tpot_p99_ms'])}",
        f"SLO       {badge} burn {_fmt(slo['burn_rate'], nd=2)}"
        f"  violations {slo['violations']}"
        f"  flight_dumps {s['flight_dumps']}",
    ]
    sp = s.get("spec") or {}
    if sp.get("drafted"):
        lines.insert(-1, (
            f"spec      drafted {sp['drafted']}"
            f"  accepted {sp['accepted']}"
            f"  acceptance {_fmt(sp['acceptance'], nd=2)}"
            f"  mean_k {_fmt(sp['mean_k'], nd=1)}"))
    mx = s.get("mix")
    if mx:
        # mixed-mode ragged dispatch: the per-step prefill/verify/
        # decode q-token split of the unified waves
        lines.insert(-1, (
            f"mixed     q_prefill {mx['q_prefill']}"
            f"  q_verify {mx['q_verify']}"
            f"  q_decode {mx['q_decode']}"
            f"  waves {mx['steps']}"))
    me = s.get("moe")
    if me:
        # MoE serving: routed/dropped expert assignments, load
        # imbalance (max/mean — 1.0 = perfectly balanced), drop rate
        lines.insert(-1, (
            f"experts   routed {me['routed']}"
            f"  dropped {me['dropped']}"
            f"  imbalance {_fmt(me['imbalance'], nd=2)}"
            f"  drop_rate {_fmt(me['drop_rate'], nd=4)}"))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="hetu_top",
        description="Live terminal dashboard over the merged telemetry "
                    "JSONL stream (occupancy, queue, KV pool, TTFT/TPOT "
                    "percentiles, SLO health).")
    ap.add_argument("paths", nargs="*",
                    help="JSONL files (default: every HETU_*_LOG / "
                         "HETU_TELEMETRY_LOG set in the environment)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (scripts/tests)")
    ap.add_argument("--window", type=int, default=512, metavar="N",
                    help="newest N records the frame is computed over")
    ap.add_argument("--fleet", action="store_true",
                    help="per-replica rows for a ServingRouter fleet "
                         "(state, health, role, occupancy, queue, "
                         "breaker, routed/requeue/reject/death counts, "
                         "directory hit rate + fleet prefix totals)")
    args = ap.parse_args(argv)

    paths = args.paths or configured_logs()
    if not paths:
        ap.error("no paths given and no HETU_*_LOG configured")
    while True:
        events, _bad = read_events(paths)
        if args.fleet:
            frame = render_fleet(
                summarize_fleet(events, window=max(args.window, 4096)),
                clock=time.time())
        else:
            frame = render(summarize(events, window=args.window),
                           clock=time.time())
        if args.once:
            print(frame)
            return 0
        print("\x1b[2J\x1b[H" + frame, flush=True)
        try:
            time.sleep(max(args.interval, 0.1))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
