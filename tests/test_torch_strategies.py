"""The port's distribution strategies and sharded executor
(``hetu_tpu_torch.parallel.distributed_strategies``, ``ht.dist``; the
mesh half of ``graph/executor.py``) against the JAX package's, on the
fixed-weight MLP of tests/test_all_layouts.py:

- every layout of its ``LAYOUTS`` (dp8, dp2, tp2, tp2_patterns, tp2xdp4,
  fsdp8, explicit_plan) on a VirtualMesh: the trajectory equals JAX's
  single-device one within 1e-5 and the specs equal JAX's by variable
  name; each virtual rank's stored shard has the spec's shape; Adam on
  the composed layout; the eval subgraph on the same layout;
- ``ShardingPlan``'s typo ``KeyError`` and no-mesh ``ValueError``;
  ``DataParallel(aggregate="int8")`` splices the int8 trio, and an
  unknown ``$HETU_COMM_QUANT`` mode raises;
- one gloo world of four processes (a ``DeviceMesh``; its own gloo
  timeout and join timeout, killed past it) running DataParallel dp 4,
  FSDP dp 4, ShardingPlan dp 2 x tp 2 and ``Executor(pipeline=
  "gpipe"/"1f1b")`` over ``{"pp": 4}`` with the stage boundaries sent
  between the processes, each held to JAX's single-device trajectory,
  DataParallel dp 4 on a BatchNorm MLP and on tiny BERT pretraining,
  every process evaluating the global batch (JAX's single-device step,
  running statistics included), and every comm op in the per-rank view
  over the process groups, held rank by rank to JAX's under
  ``shard_map``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401
from jax.sharding import PartitionSpec as P

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu import models as jmodels
from hetu_tpu_torch.parallel import mesh as tmesh
from hetu_tpu_torch.parallel.sharding import rank_pieces
from test_torch_data_parallel import (BERT_CFG, BERT_FEEDS, bert_batch,
                                      build_bert, mlp, mlp_batch)

REPO = Path(__file__).resolve().parent.parent
BATCH, IN, HID, OUT = 16, 8, 32, 4
TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")


def build_mlp(ht, opt=None):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    w1 = ht.init.xavier_uniform((IN, HID), name="mlp_fc1_weight")
    b1 = ht.init.zeros((HID,), name="mlp_fc1_bias")
    w2 = ht.init.xavier_uniform((HID, IN), name="mlp_fc2_weight")
    b2 = ht.init.zeros((IN,), name="mlp_fc2_bias")
    wh = ht.init.xavier_uniform((IN, OUT), name="mlp_head_weight")
    h = ht.gelu_op(ht.linear_op(x, w1, b1))
    h = ht.linear_op(h, w2, b2)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, wh), y), axes=0)
    opt = opt or ht.optim.SGDOptimizer(learning_rate=0.1)
    return x, y, loss, opt.minimize(loss)


def make_batches(n=8, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xb = rng.randn(BATCH, IN).astype(np.float32)
        yb = np.eye(OUT, dtype=np.float32)[xb[:, :OUT].argmax(axis=1)]
        out.append((xb, yb))
    return out


def traj(ex, x, y, batches, name="train"):
    return [float(np.asarray(ex.run(name, feed_dict={x: a, y: b})[0]))
            for a, b in batches]


TP = {"mlp_fc1_weight": (None, "tp"), "mlp_fc1_bias": ("tp",),
      "mlp_fc2_weight": ("tp", None)}


def layouts(d, spec):
    return {
        "dp8": lambda: d.DataParallel(num_devices=8),
        "dp2": lambda: d.DataParallel(num_devices=2),
        "tp2": lambda: d.ModelParallel4LM(tp=2, dp=1, specs=spec),
        "tp2_patterns": lambda: d.ModelParallel4LM(tp=2, dp=1),
        "tp2xdp4": lambda: d.ModelParallel4LM(tp=2, dp=4, specs=spec),
        "fsdp8": lambda: d.FSDP(dp=8, min_size=16),
        "explicit_plan": lambda: d.ShardingPlan(
            spec, mesh_axes={"dp": 4, "tp": 2}),
    }


J_LAYOUTS = layouts(jht.dist, {k: P(*v) for k, v in TP.items()})
T_LAYOUTS = layouts(tht.dist, TP)


def _specs(ex):
    return {k: None if v.sharding_spec is None
            else tuple(v.sharding_spec) for k, v in ex.variables.items()}


@pytest.fixture(scope="module")
def baseline():
    x, y, loss, train = build_mlp(jht)
    ex = jht.Executor({"train": [loss, train]})
    w0 = ex.return_tensor_values()
    batches = make_batches()
    return w0, batches, traj(ex, x, y, batches)


@pytest.mark.parametrize("layout", sorted(T_LAYOUTS))
def test_layout_matches_jax(baseline, layout):
    w0, batches, base = baseline
    x, y, loss, train = build_mlp(jht)
    want_specs = _specs(jht.Executor({"train": [loss, train]},
                                     dist_strategy=J_LAYOUTS[layout]()))
    x, y, loss, train = build_mlp(tht)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=T_LAYOUTS[layout]())
    assert _specs(ex) == {k: None if v is None else tuple(v)
                          for k, v in want_specs.items()}
    ex.load_dict(w0)
    np.testing.assert_allclose(traj(ex, x, y, batches), base, atol=TOL)
    # each virtual rank stores its piece of every variable
    shape = ex.mesh.shape
    for name, node in ex.variables.items():
        spec = node.sharding_spec or ()
        want = tuple(n // shape[a] if a else n for n, a in
                     zip(node.shape, tuple(spec) + (None,) * 4))
        pieces = ex.local_shards(name)
        assert len(pieces) == int(np.prod(list(shape.values())))
        assert {tuple(p.shape) for p in pieces} == {want}, name


def test_adam_composed_layout(baseline):
    _, batches, _ = baseline
    x, y, loss, train = build_mlp(
        jht, jht.optim.AdamOptimizer(learning_rate=0.01))
    jex = jht.Executor({"train": [loss, train]})
    w0 = jex.return_tensor_values()
    want = traj(jex, x, y, batches)
    x, y, loss, train = build_mlp(
        tht, tht.optim.AdamOptimizer(learning_rate=0.01))
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=tht.dist.ModelParallel4LM(
                          tp=2, dp=4, specs=TP))
    ex.load_dict(w0)
    np.testing.assert_allclose(traj(ex, x, y, batches), want, atol=TOL)
    # each virtual rank reads the slots as the parameter's shards
    (slots,) = ex.opt_states.values()
    pieces = rank_pieces(slots["mlp_fc1_weight"]["m"],
                         ex.param_sharding("mlp_fc1_weight"), ex.mesh)
    assert [tuple(p.shape) for p in pieces] == [(IN, HID // 2)] * 8


def test_eval_subgraph_same_layout(baseline):
    w0, batches, base = baseline
    x, y, loss, train = build_mlp(tht)
    ex = tht.Executor({"train": [loss, train], "eval": [loss]},
                      device="cpu", dist_strategy=tht.dist.ModelParallel4LM(
                          tp=2, dp=4, specs=TP))
    ex.load_dict(w0)
    for k, (a, b) in enumerate(batches[:3]):
        ev = float(ex.run("eval", feed_dict={x: a, y: b})[0])
        tr = float(ex.run("train", feed_dict={x: a, y: b})[0])
        np.testing.assert_allclose(ev, tr, atol=1e-6)
        np.testing.assert_allclose(tr, base[k], atol=TOL)


@pytest.mark.parametrize("strategy", ["DataParallel", "FSDP",
                                      "ExpertParallel"])
def test_no_world_means_one_rank_on_a_many_card_host(baseline, monkeypatch,
                                                      strategy):
    """Without torch.distributed a strategy's mesh is virtual, its ranks
    all on one device: on a host of 8 cards the strategy with no size
    still builds one rank (and default_mesh one 'dp' rank), so the run
    is the plain one, not 8 turns on one card."""
    w0, batches, base = baseline
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(tmesh, "local_device_count", lambda: 8)
    assert tmesh.default_mesh(device="cpu").shape == {"dp": 1}
    x, y, loss, train = build_mlp(tht)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=getattr(tht.dist, strategy)())
    assert ex.mesh.sizes == (1,)
    ex.load_dict(w0)
    np.testing.assert_allclose(traj(ex, x, y, batches), base, atol=TOL)


def test_refusals(monkeypatch):
    x, y, loss, train = build_mlp(tht)
    with pytest.raises(KeyError, match="unknown variables"):
        tht.Executor({"train": [loss, train]}, device="cpu",
                     dist_strategy=tht.dist.ShardingPlan(
                         {"mlp_fc1_weihgt": (None, "tp")},
                         mesh_axes={"tp": 2}))
    with pytest.raises(ValueError, match="needs a mesh"):
        tht.Executor({"train": [loss, train]}, device="cpu",
                     dist_strategy=tht.dist.ShardingPlan(TP))
    # the int8 aggregation is no longer refused: it splices the trio
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=tht.dist.DataParallel(aggregate="int8"))
    assert all(type(g).__name__ == "DequantizeCommOp" for g in train.inputs)
    assert ex.mesh.shape == {"dp": 1}
    # an unknown mode of the knob is
    monkeypatch.setenv("HETU_COMM_QUANT", "int4")
    x, y, loss, train = build_mlp(tht)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tht.Executor({"train": [loss, train]}, device="cpu",
                     dist_strategy=tht.dist.DataParallel())


# ------------------------------------------------------------------- #
# torch.distributed: one gloo world of four processes
# ------------------------------------------------------------------- #

WORLD = 4
GLOO_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300

_WORKER = textwrap.dedent('''
    import datetime, os, sys
    os.environ["HETU_VALIDATE"] = "0"
    import numpy as np
    import torch
    import torch.distributed as dist
    import hetu_tpu_torch.graph as ht
    from hetu_tpu_torch.parallel import make_mesh

    rank, world, init, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds={gloo_timeout}))
    d = dict(np.load(data))
    IN, HID, OUT = 8, 32, 4
    res = {{}}

    def mlp():
        x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
        w1 = ht.init.xavier_uniform((IN, HID), name="mlp_fc1_weight")
        b1 = ht.init.zeros((HID,), name="mlp_fc1_bias")
        w2 = ht.init.xavier_uniform((HID, IN), name="mlp_fc2_weight")
        b2 = ht.init.zeros((IN,), name="mlp_fc2_bias")
        wh = ht.init.xavier_uniform((IN, OUT), name="mlp_head_weight")
        h = ht.linear_op(ht.gelu_op(ht.linear_op(x, w1, b1)), w2, b2)
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
            ht.matmul_op(h, wh), y), axes=0)
        return x, y, loss, ht.optim.SGDOptimizer(
            learning_rate=0.1).minimize(loss)

    def resmlp():
        x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
        H = 16
        h = ht.linear_op(x, ht.init.xavier_uniform((IN, H), name="in_w"),
                         ht.init.zeros((H,), name="in_b"))
        for i in range(4):
            w1 = ht.init.xavier_uniform((H, 2 * H), name=f"l{{i}}_w1")
            b1 = ht.init.zeros((2 * H,), name=f"l{{i}}_b1")
            w2 = ht.init.xavier_uniform((2 * H, H), name=f"l{{i}}_w2")
            b2 = ht.init.zeros((H,), name=f"l{{i}}_b2")
            h = h + ht.linear_op(ht.gelu_op(ht.linear_op(h, w1, b1)),
                                 w2, b2)
        logits = ht.matmul_op(h, ht.init.xavier_uniform((H, OUT),
                                                        name="head_w"))
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y),
                                 axes=0)
        return x, y, loss, ht.optim.SGDOptimizer(
            learning_rate=0.1).minimize(loss)

    def run(tag, build, prefix, **kw):
        x, y, loss, train = build()
        ex = ht.Executor({{"train": [loss, train]}}, device="cpu", **kw)
        ex.load_dict({{k[len(prefix):]: v for k, v in d.items()
                       if k.startswith(prefix)}})
        n = d[prefix[:-1] + "_n"]
        res[tag] = np.array([float(ex.run("train", feed_dict={{
            x: d[prefix + "x"][i], y: d[prefix + "y"][i]}})[0])
            for i in range(int(n))])
        return ex

    run("dp4", mlp, "mlp/", dist_strategy=ht.dist.DataParallel())
    ex = run("fsdp4", mlp, "mlp/", dist_strategy=ht.dist.FSDP(min_size=16))
    res["fsdp4/fc1"] = np.array(ex.local_shards("mlp_fc1_weight")[0].shape)
    res["fsdp4/final"] = ex.return_tensor_values()["mlp_fc1_weight"]
    ex = run("dp2tp2", mlp, "mlp/", dist_strategy=ht.dist.ShardingPlan(
        {{"mlp_fc1_weight": (None, "tp"), "mlp_fc1_bias": ("tp",),
          "mlp_fc2_weight": ("tp", None)}}, mesh_axes={{"dp": 2, "tp": 2}}))
    res["dp2tp2/fc1"] = np.array(ex.local_shards("mlp_fc1_weight")[0].shape)

    # the comm ops in the per-rank view over the process groups
    from hetu_tpu_torch.graph.node import TraceContext
    from hetu_tpu_torch.parallel.collectives import run_per_rank
    from hetu_tpu_torch.parallel.mesh import rank_coords
    ops = {{
        "allreduce": lambda n: ht.allreduceCommunicate_op(n, axis="dp"),
        "groupallreduce": lambda n: ht.groupallreduceCommunicate_op(
            n, axis="tp"),
        "allgather": lambda n: ht.allgatherCommunicate_op(n, axis="tp"),
        "reducescatter": lambda n: ht.reducescatterCommunicate_op(
            n, axis="tp"),
        "broadcast": lambda n: ht.broadcastCommunicate_op(n, root=1,
                                                          axis="dp"),
        "reduce": lambda n: ht.reduceCommunicate_op(n, axis="dp"),
        "send": ht.pipeline_send_op, "receive": ht.pipeline_receive_op}}
    meshes = {{"2d": make_mesh({{"dp": 2, "tp": 2}}),
              "pp": make_mesh({{"pp": world}})}}
    for name, make in ops.items():
        mesh = meshes["pp" if name in ("send", "receive") else "2d"]
        c = rank_coords(mesh)[0]
        x = d["ops/pp"][c["pp"]] if "pp" in c else \
            d["ops/x"][c["dp"], c["tp"]]
        node = make(ht.placeholder_op("x"))
        res["ops/" + name] = run_per_rank(
            lambda comm, b: node.compute([b], TraceContext(comm=comm)),
            mesh, (torch.from_numpy(x),)).numpy()
        res["ops/" + name + "/at"] = np.array(list(c.values()))
    # the global-batch step: BatchNorm's moments over the whole batch,
    # and BERT pretraining's masked mean over every row's labels
    def bnmlp():
        x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
        h = ht.linear_op(x, ht.init.xavier_uniform((IN, 32), name="bn_in_w"),
                         ht.init.zeros((32,), name="bn_in_b"))
        h = ht.layers.BatchNorm(32, name="bn0")(h)
        logits = ht.matmul_op(h, ht.init.xavier_uniform((32, OUT),
                                                        name="bn_head"))
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y),
                                 axes=0)
        return x, y, loss, ht.optim.SGDOptimizer(
            learning_rate=0.1).minimize(loss)

    ex = run("bn", bnmlp, "bn/", dist_strategy=ht.dist.DataParallel())
    res["bn/final"] = ex.return_tensor_values()
    from hetu_tpu_torch import models
    bcfg = {bert_cfg}
    phs = [ht.placeholder_op(n) for n in {bert_feeds}]
    loss, _, _ = models.BertForPreTraining(models.BertConfig(
        batch_size=d["bert/ids"].shape[0], **bcfg))(*phs)
    train = ht.optim.SGDOptimizer(learning_rate=0.05).minimize(loss)
    ex = ht.Executor({{"train": [loss, train]}}, device="cpu",
                     dist_strategy=ht.dist.DataParallel())
    ex.load_dict({{k[5:]: v for k, v in d.items()
                  if k.startswith("bert/") and k[5:] not in {bert_feeds}}})
    feeds = {{p: d["bert/" + n] for p, n in zip(phs, {bert_feeds})}}
    res["bert"] = np.array([float(ex.run("train", feed_dict=feeds)[0])
                            for _ in range(2)])
    res["bert/final"] = ex.return_tensor_values()
    for mode in ("gpipe", "1f1b"):
        ex = run(mode, resmlp, "res/", pipeline=mode,
                 mesh=make_mesh({{"pp": world}}), num_microbatches=4)
        assert ex.subexecutor["train"].spmd
        res[mode + "/final"] = ex.return_tensor_values()["l3_w2"]
    flat = {{}}
    for k, v in res.items():
        if isinstance(v, dict):
            flat.update({{k + "/" + n: a for n, a in v.items()}})
        else:
            flat[k] = v
    np.savez(out, **flat)
    dist.barrier()
    dist.destroy_process_group()
''').format(gloo_timeout=GLOO_TIMEOUT_S, bert_cfg=repr(BERT_CFG),
           bert_feeds=repr(BERT_FEEDS))


OPS_X = np.random.RandomState(1).randn(2, 2, 4, 3).astype(np.float32)
OPS_PP = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory, baseline):
    """JAX's single-device trajectories of both MLPs, and the four ranks'
    results of the worker on the same weights and batches."""
    sys.path.insert(0, str(REPO / "tests"))
    w0, batches, base = baseline
    from test_torch_pipeline_executor import build_model, make_batches \
        as res_batches
    x, y, loss, train = build_model(jht)
    jex = jht.Executor({"train": [loss, train]})
    rw0 = jex.return_tensor_values()
    rb = res_batches(4)
    rbase = traj(jex, x, y, rb)
    rfinal = jex.return_tensor_values()["l3_w2"]
    global_batch = {}
    x, y, loss, train = mlp(jht)
    jex = jht.Executor({"train": [loss, train]})
    data = {f"bn/{k}": v for k, v in jex.return_tensor_values().items()}
    xb, yb = mlp_batch()
    data.update({"bn/x": np.stack([xb, xb]), "bn/y": np.stack([yb, yb]),
                 "bn_n": np.array(2)})
    global_batch["bn"] = (traj(jex, x, y, [(xb, yb)] * 2),
                          jex.return_tensor_values())
    arrays = bert_batch(4)
    phs, loss, train = build_bert(jht, jmodels, 4)
    jex = jht.Executor({"train": [loss, train]})
    data.update({f"bert/{k}": v for k, v in
                 jex.return_tensor_values().items()})
    data.update({f"bert/{n}": a for n, a in zip(BERT_FEEDS, arrays)})
    feeds = dict(zip(phs, arrays))
    global_batch["bert"] = (
        [float(np.asarray(jex.run("train", feed_dict=feeds)[0]))
         for _ in range(2)], jex.return_tensor_values())
    tmp = tmp_path_factory.mktemp("gloo")
    data.update({f"mlp/{k}": v for k, v in w0.items()})
    data.update({f"res/{k}": v for k, v in rw0.items()})
    data.update({"mlp/x": np.stack([a for a, _ in batches]),
                 "mlp/y": np.stack([b for _, b in batches]),
                 "mlp_n": np.array(len(batches)),
                 "res/x": np.stack([a for a, _ in rb]),
                 "res/y": np.stack([b for _, b in rb]),
                 "res_n": np.array(len(rb)),
                 "ops/x": OPS_X, "ops/pp": OPS_PP})
    np.savez(tmp / "data.npz", **data)
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(WORLD), init,
         str(tmp / "data.npz"), str(tmp / f"rank{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the gloo world did not finish in {JOIN_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(ranks=ranks, base=base, rbase=rbase, rfinal=rfinal,
                w0=w0, batches=batches, global_batch=global_batch)


@pytest.mark.parametrize("tag", ["dp4", "fsdp4", "dp2tp2"])
def test_distributed_layouts_match_jax(gloo_world, tag):
    for r in gloo_world["ranks"]:
        np.testing.assert_allclose(r[tag], gloo_world["base"], atol=TOL)
    if tag == "fsdp4":
        assert all(tuple(r["fsdp4/fc1"]) == (IN, HID // 4)
                   for r in gloo_world["ranks"])
        x, y, loss, train = build_mlp(jht)
        jex = jht.Executor({"train": [loss, train]})
        jex.load_dict(gloo_world["w0"])
        traj(jex, x, y, gloo_world["batches"])
        want = jex.return_tensor_values()["mlp_fc1_weight"]
        for r in gloo_world["ranks"]:
            np.testing.assert_allclose(r["fsdp4/final"], want, atol=TOL)
    if tag == "dp2tp2":
        assert all(tuple(r["dp2tp2/fc1"]) == (IN, HID // 2)
                   for r in gloo_world["ranks"])


@pytest.mark.parametrize("case", ["bn", "bert"])
def test_distributed_global_batch_matches_jax(gloo_world, case):
    """DataParallel dp 4 over the gloo world: every process evaluates the
    global batch, so the BatchNorm MLP (running statistics included) and
    tiny BERT pretraining (B 4) equal JAX's single-device step."""
    losses, final = gloo_world["global_batch"][case]
    for r in gloo_world["ranks"]:
        np.testing.assert_allclose(r[case], losses, rtol=1e-5, atol=TOL)
        for k, v in final.items():
            np.testing.assert_allclose(r[f"{case}/final/{k}"], v, atol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["gpipe", "1f1b"])
def test_distributed_pipeline_matches_jax(gloo_world, mode):
    for r in gloo_world["ranks"]:
        np.testing.assert_allclose(r[mode], gloo_world["rbase"], atol=TOL)
        np.testing.assert_allclose(r[mode + "/final"], gloo_world["rfinal"],
                                   atol=TOL)


@pytest.mark.parametrize("name", ["allreduce", "groupallreduce", "allgather",
                                  "reducescatter", "broadcast", "reduce",
                                  "send", "receive"])
def test_distributed_comm_ops_match_shard_map(gloo_world, name):
    """Each rank's result of the comm op over the gloo process groups
    equals JAX's for the same rank under shard_map."""
    from test_torch_ops_comm import OPS, _jax_per_rank
    if name in ("send", "receive"):
        op = {"send": lambda m, n: m.pipeline_send_op(n),
              "receive": lambda m, n: m.pipeline_receive_op(n)}[name]
        want = _jax_per_rank(op, OPS_PP, {"pp": 4})
    else:
        want = _jax_per_rank(OPS[name], OPS_X, {"dp": 2, "tp": 2})
    for r in gloo_world["ranks"]:
        at = tuple(int(i) for i in r[f"ops/{name}/at"])
        np.testing.assert_allclose(r[f"ops/{name}"], want[at], rtol=1e-6,
                                   atol=1e-6)
