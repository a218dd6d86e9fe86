"""The port's comm ops (``hetu_tpu_torch.graph.ops_comm``) and static
parallelism checks (``hetu_tpu_torch.analysis.shard_check``) against the
JAX package's:

- each collective op in the per-rank view on a VirtualMesh
  (``parallel.collectives.run_per_rank``: the virtual ranks as threads in
  lockstep) against the JAX op under ``shard_map`` on the same mesh of
  the 8-device CPU platform, rank by rank, exactly: all-reduce (and its
  p2p factory), group all-reduce, all-gather, reduce-scatter, broadcast and reduce over one
  axis of a 2-D mesh, the pipeline send/receive rotations on ``pp``;
  (the same on a gloo ``DeviceMesh``: tests/test_torch_strategies.py);
- the whole-value view (no ``comm``, an Executor run through both
  host-device copies) is the identity;
- the PS ops raise A10, the host-device copies move to the run's device;
- ``shard_check``'s verdicts (the raised ``kind`` or the findings) equal
  JAX's on good and broken graphs for every check it ports.
"""

import re

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu.analysis import shard_check as jsc
from hetu_tpu.graph import ops_comm as jops
from hetu_tpu.graph.node import TraceContext as JTC
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu_torch.analysis import shard_check as tsc
from hetu_tpu_torch.graph import ops_comm as tops
from hetu_tpu_torch.graph.node import TraceContext as TTC
from hetu_tpu_torch.parallel import make_mesh
from hetu_tpu_torch.parallel.collectives import run_per_rank


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")


OPS = {
    "allreduce": lambda m, n: m.allreduceCommunicate_op(n, axis="dp"),
    "allreduce_p2p": lambda m, n: m.allreduceCommunicatep2p_op(
        n, axis="dp"),
    "groupallreduce": lambda m, n: m.groupallreduceCommunicate_op(
        n, axis="tp"),
    "allgather": lambda m, n: m.allgatherCommunicate_op(n, axis="tp"),
    "reducescatter": lambda m, n: m.reducescatterCommunicate_op(
        n, axis="tp"),
    "broadcast": lambda m, n: m.broadcastCommunicate_op(n, root=1,
                                                        axis="dp"),
    "reduce": lambda m, n: m.reduceCommunicate_op(n, axis="dp"),
}
AXES = {"dp": 2, "tp": 2}
BLOCK = (4, 3)


def _jax_per_rank(op, x, axes):
    names = tuple(axes)
    mesh = jmake_mesh(dict(axes))
    node = op(jops, jht.placeholder_op("x"))

    def f(b):
        tc = JTC(axis_env=names)
        y = node.compute([b.reshape(b.shape[len(names):])], tc)
        return y.reshape((1,) * len(names) + y.shape)

    spec = P(*names)
    out = jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                        check_vma=False)(jnp.asarray(x))
    return np.asarray(out)


def _port_per_rank(op, x, axes):
    mesh = make_mesh(dict(axes), device="cpu")
    node = op(tops, tht.placeholder_op("x"))
    sizes = list(axes.values())
    blocks = [(torch.from_numpy(x[idx]),)
              for idx in np.ndindex(*sizes)]

    def f(comm, b):
        return node.compute([b], TTC(device="cpu", comm=comm))

    outs = run_per_rank(f, mesh, blocks)
    return np.stack([o.numpy() for o in outs]).reshape(
        tuple(sizes) + tuple(outs[0].shape))


@pytest.mark.parametrize("name", sorted(OPS))
def test_collectives_per_rank_match_shard_map(name):
    rng = np.random.RandomState(1)
    x = rng.randn(*AXES.values(), *BLOCK).astype(np.float32)
    want = _jax_per_rank(OPS[name], x, AXES)
    got = _port_per_rank(OPS[name], x, AXES)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", [
    lambda m, n: m.pipeline_send_op(n), lambda m, n: m.pipeline_receive_op(n)],
    ids=["send", "receive"])
def test_pipeline_rotations_match_shard_map(op):
    x = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    want = _jax_per_rank(op, x, {"pp": 4})
    got = _port_per_rank(op, x, {"pp": 4})
    np.testing.assert_array_equal(got, want)


def test_whole_value_view_is_identity():
    x = torch.randn(4, 3)
    for name, op in OPS.items():
        node = op(tops, tht.placeholder_op("x"))
        assert torch.equal(node.compute([x], TTC(device="cpu")), x), name
    xp = tht.placeholder_op("x")
    out = tht.reduce_sum_op(tht.datad2h_op(tht.allreduceCommunicate_op(
        tht.pipeline_send_op(tht.datah2d_op(xp)))), axes=[0])
    ex = tht.Executor([out], device="cpu")
    (got,) = ex.run(feed_dict={xp: x.numpy()})
    torch.testing.assert_close(got, x.sum(0))


def test_ps_ops_raise_a10():
    x = tht.placeholder_op("x")
    with pytest.raises(NotImplementedError, match="A10"):
        tht.parameterServerCommunicate_op(x)
    with pytest.raises(NotImplementedError, match="A10"):
        tht.parameterServerSparsePull_op(x, x)
    # the int8 trio is no longer refused: it needs the gradient's shape
    with pytest.raises(ValueError, match="needs the gradient shape"):
        tops.quantized_allreduce_op(x)
    assert isinstance(tops.quantized_allreduce_op(x, shape=(4, 4)),
                      tops.DequantizeCommOp)


# ------------------------------------------------------------------- #
# shard_check
# ------------------------------------------------------------------- #

def _verdict(fn):
    try:
        out = fn()
    except Exception as e:              # noqa: BLE001 - compared below
        return ("raise", type(e).__name__, getattr(e, "kind", None))
    if isinstance(out, list):
        out = [d["kind"] if isinstance(d, dict) else
               (tuple(re.sub(r"_\d+$", "", str(x)) for x in d)
                if isinstance(d, tuple) else re.sub(r"_\d+$", "", str(d)))
               for d in out]
    return ("ok", out)


def _mlp(ht, n_layers=4):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.matmul_op(x, ht.init.xavier_uniform((8, 16), name="in_w"))
    for i in range(n_layers):
        w = ht.init.xavier_uniform((16, 16), name=f"l{i}_w")
        h = h + ht.gelu_op(ht.matmul_op(h, w))
    return ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(h, ht.init.xavier_uniform((16, 4), name="head")), y),
        axes=0)


def _comm_graph(ht, axis):
    x = ht.placeholder_op("x")
    return [ht.allreduceCommunicate_op(ht.allgatherCommunicate_op(
        x, axis="tp"), axis=axis)]


def _spec_graph(ht, spec, shape=(6, 4)):
    w = ht.init.xavier_uniform(shape, name="w")
    w.sharding_spec = spec
    return [ht.reduce_sum_op(w, axes=[0])]


CASES = {
    "mesh_axes_ok": lambda ht, sc, mk: sc.check_mesh_axes(
        _comm_graph(ht, "dp"), mk({"dp": 2, "tp": 2})),
    "mesh_axes_missing": lambda ht, sc, mk: sc.check_mesh_axes(
        _comm_graph(ht, "ep"), mk({"dp": 2, "tp": 2})),
    "mesh_axes_no_mesh": lambda ht, sc, mk: sc.check_mesh_axes(
        _comm_graph(ht, "ep"), None),
    "divisible": lambda ht, sc, mk: sc.check_divisibility(
        _spec_graph(ht, ("tp", None)), mk({"tp": 2})),
    "not_divisible": lambda ht, sc, mk: sc.check_divisibility(
        _spec_graph(ht, (None, "tp"), (6, 3)), mk({"tp": 2})),
    "spec_axis_absent": lambda ht, sc, mk: sc.check_divisibility(
        _spec_graph(ht, ("dp", None)), mk({"tp": 2})),
    "feed_not_dp_divisible": lambda ht, sc, mk: sc.check_divisibility(
        _spec_graph(ht, None), mk({"dp": 4}), feed_shapes={"x": (6, 2)}),
    "pipeline_ok": lambda ht, sc, mk: sc.check_pipeline_stages(
        _mlp(ht), 2),
    "pipeline_uneven": lambda ht, sc, mk: sc.check_pipeline_stages(
        _mlp(ht), 3),
    "pipeline_too_few": lambda ht, sc, mk: sc.check_pipeline_stages(
        _mlp(ht), 8),
    "pipeline_no_body": lambda ht, sc, mk: sc.check_pipeline_stages(
        _mlp(ht, 1), 2),
    "pipeline_from_mesh": lambda ht, sc, mk: sc.check_pipeline_stages(
        _mlp(ht), None, mesh=mk({"pp": 4})),
    "expert_mesh_ok": lambda ht, sc, mk: sc.check_expert_mesh(
        mk({"ep": 4}), 8),
    "expert_mesh_none": lambda ht, sc, mk: sc.check_expert_mesh(None, 8),
    "expert_mesh_axis": lambda ht, sc, mk: sc.check_expert_mesh(
        mk({"dp": 4}), 8),
    "expert_mesh_uneven": lambda ht, sc, mk: sc.check_expert_mesh(
        mk({"ep": 4}), 6),
    "alltoall_none": lambda ht, sc, mk: sc.check_expert_alltoall(
        [_mlp(ht, 1)]),
    "sequence": lambda ht, sc, mk: sc.collective_sequence(
        _comm_graph(ht, "dp")),
    "order_equal": lambda ht, sc, mk: sc.check_collective_order_static(
        {"a": _comm_graph(ht, "dp"), "b": _comm_graph(ht, "dp")}),
    "order_diverge": lambda ht, sc, mk: sc.check_collective_order_static(
        {"a": _comm_graph(ht, "dp"), "b": _comm_graph(ht, "ep")}),
    "order_filtered": lambda ht, sc, mk: sc.check_collective_order_static(
        {"a": _comm_graph(ht, "dp"), "b": _comm_graph(ht, "ep")},
        axes=("tp",)),
    "umbrella": lambda ht, sc, mk: sc.check_parallelism(
        [_mlp(ht), ht.optim.SGDOptimizer(0.1).minimize(_mlp(ht))],
        mk({"pp": 2}), config=type("C", (), {"pipeline": "gpipe",
                                              "num_stages": 3})()),
}


def _stage_chain(ht, stage, send=True):
    x = ht.placeholder_op("x")
    a = ht.relu_op(x)
    s = ht.pipeline_send_op(a) if send else ht.tanh_op(a)
    r = ht.pipeline_receive_op(s) if send else ht.tanh_op(s)
    b = ht.relu_op(r)
    nodes = {"x": x, "a": a, "s": s, "r": r, "b": b}
    return [b], {nodes[k]: v for k, v in stage.items()}


STAGES = {
    "stages_ok": ({"x": 0, "a": 0, "s": 0, "r": 1, "b": 1}, True, None),
    "stages_gap": ({"x": 0, "a": 0, "s": 0, "r": 2, "b": 2}, True, 3),
    "stages_backward": ({"x": 1, "a": 1, "s": 1, "r": 0, "b": 0}, True,
                        None),
    "stages_bypass": ({"x": 0, "a": 0, "s": 1, "r": 1, "b": 1}, False,
                      None),
    "stages_skip": ({"x": 0, "a": 0, "s": 0, "r": 2, "b": 2}, True, None),
}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(STAGES))
def test_shard_check_verdicts_equal_jax(case):
    if case in CASES:
        want = _verdict(lambda: CASES[case](jht, jsc, jmake_mesh))
        got = _verdict(lambda: CASES[case](
            tht, tsc, lambda a: make_mesh(a, device="cpu")))
    else:
        stage, send, S = STAGES[case]
        want = _verdict(lambda: jsc.check_stage_assignment(
            *_stage_chain(jht, stage, send), num_stages=S))
        got = _verdict(lambda: tsc.check_stage_assignment(
            *_stage_chain(tht, stage, send), num_stages=S))
    assert got == want
    if case.endswith(("missing", "not_divisible", "uneven", "diverge",
                      "bypass", "backward")):
        assert got[0] == "raise" and got[2] is not None
