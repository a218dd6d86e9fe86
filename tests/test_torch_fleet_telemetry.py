"""The fleet's chaos plans and telemetry tools on the port, on the CPU.

- ``HETU_CHAOS``: the port's ``FaultPlan`` draws the same stream as the
  JAX package's for the same spec (kinds, values, fired counts, role
  gating, inline kills, wedges), and the fault-plan scenarios of the JAX
  package's ``tests/test_faults.py`` (``TestFaultPlan``,
  ``TestReplicaScopedChaos``) run on the port's module.
- ``trace --check``: on the port's own fleet logs (a chaos kill with a
  role-split handoff, and the same log with a retirement cut out) the
  port's checker returns what the JAX package's returns, line for line
  and exit code for exit code, and ``python -m
  hetu_tpu_torch.telemetry.trace --check`` runs as a command.
- ``top``: the port's single-engine and ``--fleet`` summaries of that
  log equal the JAX package's.
- ``health``: the sibling and MFU gates and the provenance stamp equal
  the JAX package's; the port claims no calibrated matmul peak (the
  repo's calibration file holds TPU figures, not the card's).
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import test_faults as JF
from hetu_tpu.ps import faults as jfaults
from hetu_tpu.telemetry import health as jhealth
from hetu_tpu.telemetry import top as jtop
from hetu_tpu.telemetry import trace as jtrace
from hetu_tpu_torch import telemetry
from hetu_tpu_torch.ps import faults as tfaults
from hetu_tpu_torch.serving import Request, ServingRouter
from hetu_tpu_torch.telemetry import health as thealth
from hetu_tpu_torch.telemetry import top as ttop
from hetu_tpu_torch.telemetry import trace as ttrace
from test_router import _rand_gpt, _trace
from torch_fleet_shim import CpuEngine

SPECS = ["seed=5,drop=0.3,dup=0.2,delay=0.1:0.0",
         "seed=1,drop=0.25,reset=0.05,slow=0.1:0.2",
         "seed=9,kill=7,wedge=3",
         "seed=3,kill=4,role=replica1"]


@pytest.fixture(autouse=True)
def _fresh_plans(monkeypatch):
    # test_faults.py's other globals are the PS (ROADMAP A10)
    monkeypatch.setattr(JF, "faults", tfaults)
    monkeypatch.setattr(JF, "FaultPlan", tfaults.FaultPlan)
    monkeypatch.delenv("HETU_CHAOS_ROLE", raising=False)
    tfaults.reset_plans()
    jfaults.reset_plans()
    yield
    tfaults.reset_plans()
    jfaults.reset_plans()


def _stream(mod, spec, n, **draw_kw):
    p = mod.FaultPlan.from_spec(spec)
    out = []
    for _ in range(n):
        f = p.draw(inline=True, **draw_kw)
        out.append((f.kind, f.seconds))
    return out, dict(p.fired), p._n


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("draw_kw", [
    {}, {"kinds": ("kill", "wedge")}, {"role": "replica1"},
    {"role": "replica0", "kinds": ("kill",)}], ids=["all", "kinds", "role",
                                                     "other-role"])
def test_chaos_draw_stream_equals_jax(spec, draw_kw):
    assert _stream(tfaults, spec, 400, **draw_kw) == \
        _stream(jfaults, spec, 400, **draw_kw)


def test_u01_equals_jax():
    for seed in (0, 1, 7, 2 ** 31 - 1):
        assert [tfaults._u01(seed, n) for n in range(200)] == \
            [jfaults._u01(seed, n) for n in range(200)]


class TestTorchFaultPlan(JF.TestFaultPlan):
    pass


class TestTorchReplicaScopedChaos(JF.TestReplicaScopedChaos):
    pass


# ------------------------------------------------------------------- #
# trace / top on the port's own fleet logs
# ------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fleet_log(tmp_path_factory):
    """ONE port fleet run into a serve log: a role-split fleet (prefill
    and decode replicas, so KV hands off at retirement) under a seeded
    chaos kill."""
    d = tmp_path_factory.mktemp("fleetlog")
    log = str(d / "serve.jsonl")
    mp = pytest.MonkeyPatch()
    mp.setenv("HETU_TELEMETRY", "1")
    mp.setenv("HETU_SERVE_LOG", log)
    mp.setenv("HETU_CHAOS", "seed=3,kill=6,role=replica2")
    tfaults.reset_plans()
    telemetry.reset()
    try:
        p, cfg = _rand_gpt()
        router = ServingRouter(
            lambda i: CpuEngine(p, cfg, slots=2, queue_limit=16, paged=True,
                                kv_block=8, prefix_share=True),
            replicas=3, roles="prefill,decode,decode",
            restart_backoff=0.01)
        rng = np.random.RandomState(5)
        reqs = [Request(prompt=[int(t) for t in rng.randint(0, 61, 12)],
                        max_new_tokens=4) for _ in range(4)]
        reqs += [Request(prompt=pr, max_new_tokens=n)
                 for pr, n in _trace(6, seed=11)]
        res = router.run(reqs)
        snap = router.snapshot()
    finally:
        mp.undo()
        tfaults.reset_plans()
        telemetry.reset()
    assert len(res) == len(reqs) and snap["lost"] == 0
    assert snap["handoffs"] >= 1 and snap["requeued"] >= 1
    return log


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_trace_check_equals_jax_on_port_log(fleet_log, tmp_path):
    events, bad = ttrace.read_events([fleet_log])
    assert bad == 0
    kinds = {e["event"] for e in events}
    assert {"router_hop", "kv_handoff_out", "kv_handoff_in"} <= kinds
    clean = _cli(ttrace.main, [fleet_log, "--check"])
    assert clean == _cli(jtrace.main, [fleet_log, "--check"])
    assert clean[0] == 0
    # cut one retirement: span balance and handoff pairing now fail
    cut = str(tmp_path / "cut.jsonl")
    with open(fleet_log) as f:
        lines = f.readlines()
    drop = next(i for i, ln in enumerate(lines)
                if json.loads(ln)["event"] == "serve_finish")
    with open(cut, "w") as f:
        f.writelines(lines[:drop] + lines[drop + 1:])
    broken = _cli(ttrace.main, [cut, "--check"])
    assert broken == _cli(jtrace.main, [cut, "--check"])
    assert broken[0] != 0


def test_trace_cli_module(fleet_log):
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.trace",
         fleet_log, "--check"], capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "jax" not in proc.stderr


def test_top_equals_jax_on_port_log(fleet_log):
    events, _ = ttrace.read_events([fleet_log])
    jevents, _ = jtrace.read_events([fleet_log])
    assert ttop.summarize(events) == jtop.summarize(jevents)
    fleet = ttop.summarize_fleet(events)
    assert fleet == jtop.summarize_fleet(jevents)
    assert ttop.render_fleet(fleet, clock=0.0) == \
        jtop.render_fleet(fleet, clock=0.0)
    assert _cli(ttop.main, [fleet_log, "--once", "--fleet"])[0] == 0


def test_health_gates_equal_jax(monkeypatch):
    monkeypatch.setenv("HETU_TELEMETRY", "1")
    probes = {8: 216.0, 16: 223.0, 48: 64.6, 32: 219.0}
    assert thealth.check_sibling_consistency(probes) == \
        jhealth.check_sibling_consistency(probes)
    for mfu in (0.4, 1.5):
        assert thealth.check_physics_ceiling(mfu=mfu) == \
            jhealth.check_physics_ceiling(mfu=mfu)
    assert thealth.check_physics_ceiling(platform="cpu") == \
        jhealth.check_physics_ceiling(platform="cpu")
    # no calibrated peak of the card: an achieved rate alone never fails
    assert thealth.CALIBRATION_FILE is None
    assert thealth.check_physics_ceiling(tflops_chip=1e6)["ok"]
    rec = {"x": 1}
    assert thealth.stamp_provenance(dict(rec), False, "t0") == \
        jhealth.stamp_provenance(dict(rec), False, "t0")
