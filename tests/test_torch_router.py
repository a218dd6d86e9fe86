"""The serving fleet's router on port engines, on the CPU.

- Every scenario of the JAX package's ``tests/test_router.py`` (routing
  and affinity, the circuit breaker, the seeded chaos kill with zero
  loss, wedge detection, shedding, backpressure, deadlines, retry
  exhaustion, span balance, ``hetu_top --fleet``) runs unchanged on
  ``hetu_tpu_torch`` engines, routers, fault plans and telemetry
  (``torch_fleet_shim``), held to that file's own assertions: greedy
  tokens equal the port's offline ``generate_fast``.
- The seeded chaos kill runs through the JAX router over JAX engines and
  the port router over port engines on the same params and chaos spec:
  per request the tokens and finish reason are equal, and per replica
  the routed, requeued and retired counts.
"""

import pytest

import test_router as J
from hetu_tpu.ps import faults as jfaults
from hetu_tpu.serving import Request as JRequest
from hetu_tpu.serving import ServingEngine as JEngine
from hetu_tpu.serving import ServingRouter as JRouter
from hetu_tpu_torch import telemetry as ttelemetry
from hetu_tpu_torch.ps import faults as tfaults
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingRouter as TRouter
from torch_fleet_shim import CpuEngine, port_fixture

model = J.model
_fresh = port_fixture(J)


class TestTorchRouting(J.TestRouting):
    pass


class TestTorchCircuitBreaker(J.TestCircuitBreaker):
    pass


class TestTorchChaosKillIntegration(J.TestChaosKillIntegration):
    pass


class TestTorchSheddingAndBackpressure(J.TestSheddingAndBackpressure):
    pass


class TestTorchFleetObservability(J.TestFleetObservability):
    pass


def _chaos_run(Router, Engine, Request, faults, read_events, model,
               monkeypatch, log):
    p, cfg = model
    monkeypatch.setenv("HETU_CHAOS", "seed=3,kill=4,role=replica1")
    monkeypatch.setenv("HETU_SERVE_LOG", log)
    faults.reset_plans()
    router = Router(lambda i: Engine(p, cfg, slots=2, queue_limit=16,
                                     fast_path=False),
                    replicas=2, restart_backoff=0.01)
    reqs = [Request(prompt=pr, max_new_tokens=n, request_id=f"q{i}")
            for i, (pr, n) in enumerate(J._trace(8, seed=11))]
    res = router.run(reqs)
    snap = router.snapshot()
    faults.reset_plans()
    events, bad = read_events([log])
    assert bad == 0
    per_req = {k: (v.tokens.tolist(), v.finish_reason)
               for k, v in res.items()}
    per_rep = [(row["routed"],
                sum(1 for e in events if e["event"] == "router_hop"
                    and e["from_replica"] == i),
                sum(1 for e in events if e["event"] == "serve_finish"
                    and e.get("replica") == i))
               for i, row in enumerate(snap["replicas"])]
    return per_req, per_rep, snap


def test_chaos_kill_matches_jax_router(model, monkeypatch, tmp_path):
    """The same seeded kill through both routers: equal tokens and
    finish reasons per request, equal routed / requeued (hops off the
    replica) / retired (``serve_finish`` on it) counts per replica, and
    every request retired exactly once."""
    from hetu_tpu.telemetry.trace import read_events as jread
    from hetu_tpu_torch.telemetry.trace import read_events as tread
    want = _chaos_run(JRouter, JEngine, JRequest, jfaults, jread, model,
                      monkeypatch, str(tmp_path / "jax.jsonl"))
    ttelemetry.reset()
    got = _chaos_run(TRouter, CpuEngine, TRequest, tfaults, tread, model,
                     monkeypatch, str(tmp_path / "torch.jsonl"))
    assert got[0] == want[0]
    assert got[1] == want[1]
    snap = got[2]
    assert len(got[0]) == 8 and sum(r[2] for r in got[1]) == 8
    assert snap["requeued"] >= 1 and snap["lost"] == 0
    assert snap["duplicates"] == 0 and snap["finished"] == 8


def test_mixed_engine_between_steps_is_away_time(model):
    """A mixed-mode engine whose steps are spread out (a router stepping
    its peers between them) credits the gaps to its mid-prefill
    requests as away time: the wave-attribution check still holds, and
    the request's chunk stall is that time, not an accounting fault."""
    import time

    p, cfg = model
    eng = CpuEngine(p, cfg, slots=2, paged=True, kv_block=8, ragged=True,
                    prefill_chunk=4)
    req = TRequest(prompt=list(range(1, 15)), max_new_tokens=2,
                   request_id="gap")
    eng.submit(req)
    while eng.pending:
        eng.step()
        time.sleep(0.12)          # longer than the check's 50 ms floor
    row = next(b for b in eng.metrics.breakdowns if b["request"] == "gap")
    assert 240.0 <= row["chunk_stall_ms"] <= row["ttft_ms"]
