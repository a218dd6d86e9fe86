"""The 1.5-D GCN of the PyTorch port (``hetu_tpu_torch.graph.ops_gnn``:
``DistGCN15dOp``, ``distgcn_15d_op``, ``gcn_layer_shard_specs``; the
entry point ``hetu_tpu_torch.train_gcn``) against the JAX package's, on
the inputs of ``tests/test_gnn.py`` (numpy seeds), on the CPU:

- the dense layer and the no-W variant through the graph executor:
  within 1e-5 of (A @ H) @ W and of JAX's executor;
- five SGD steps through the layer: the losses within 1e-5 of JAX's
  and falling;
- the per-rank view over dp 4 x tp 2 (a ``VirtualMesh``, the ranks'
  A[row, col] and H[col] blocks, one all-reduce over tp): every rank of
  a row equal, the rows together within JAX's 1e-4 + 1e-5 of the dense
  result and within 1e-5 of JAX's op under ``shard_map``;
- ``train_gcn``'s two-layer GCN (its ``build_gcn``, the masked loss),
  three SGD steps on the executor over ``make_mesh({"dp": 4, "tp":
  2})`` equal to the single-device executor's and within 1e-5 of JAX's
  example graph from the same weights; ``train_gcn`` itself with and
  without ``--mesh``: the same falling losses.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import hetu_tpu as jht
from hetu_tpu.graph.node import TraceContext as JTC
from hetu_tpu.graph.ops_gnn import gcn_layer_shard_specs as jspecs
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
import hetu_tpu_torch.graph as tht
from hetu_tpu_torch import gnn_common, train_gcn
from hetu_tpu_torch.graph.node import TraceContext as TTC
from hetu_tpu_torch.parallel import make_mesh
from hetu_tpu_torch.parallel.collectives import run_per_rank

TOL = 1e-5


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=16, f=8, h=4, seed=0):
    rng = np.random.RandomState(seed)
    adj = (rng.rand(n, n) < 0.3).astype(np.float32)
    adj /= np.maximum(adj.sum(1, keepdims=True), 1)  # row-normalized
    feat = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f, h).astype(np.float32)
    return adj, feat, w


def _outputs(ht, build, feeds, **ex_kw):
    """``build(ht) -> (placeholders, nodes)`` run once by each package's
    executor; numpy outputs."""
    phs, nodes = build(ht)
    kw = dict(device="cpu") if ht is tht else {}
    ex = ht.Executor({"f": nodes}, **kw, **ex_kw)
    out = ex.run("f", feed_dict=dict(zip(phs, feeds)),
                 convert_to_numpy_ret_vals=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("need_w", [True, False])
def test_layer_matches_dense_and_jax(need_w):
    adj, feat, w = _problem()

    def build(ht):
        a, hh = ht.placeholder_op("a"), ht.placeholder_op("h")
        ww = ht.Variable("w", value=w) if need_w else None
        return (a, hh), [ht.distgcn_15d_op(a, hh, ww, need_W=need_w)]

    (got,) = _outputs(tht, build, (adj, feat))
    (want,) = _outputs(jht, build, (adj, feat))
    dense = adj @ feat @ w if need_w else adj @ feat
    np.testing.assert_allclose(got, dense, rtol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_gradient_steps_match_jax():
    adj, feat, w = _problem(8, 4, 2)
    losses = {}
    for ht in (tht, jht):
        a, hh = ht.placeholder_op("a"), ht.placeholder_op("h")
        z = ht.distgcn_15d_op(a, hh, ht.Variable("w", value=w))
        loss = ht.reduce_mean_op(ht.reduce_sum_op(ht.mul_op(z, z), [1]),
                                 [0])
        train = ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
        ex = ht.Executor({"t": [loss, train]},
                         **(dict(device="cpu") if ht is tht else {}))
        losses[ht] = [float(np.asarray(ex.run(
            "t", feed_dict={a: adj, hh: feat},
            convert_to_numpy_ret_vals=True)[0])) for _ in range(6)]
    np.testing.assert_allclose(losses[tht], losses[jht], rtol=TOL)
    assert losses[tht][-1] < losses[tht][0]


ROW, COL = 4, 2


def _blocks(adj, feat):
    """Each rank's (A[row, col], H[col]) in rank order (dp-major)."""
    n = adj.shape[0]
    r, c = n // ROW, n // COL
    return [(adj[i * r:(i + 1) * r, j * c:(j + 1) * c],
             feat[j * c:(j + 1) * c]) for i in range(ROW) for j in range(COL)]


def test_15d_per_rank_matches_dense_and_jax():
    adj, feat, w = _problem(16, 8, 4)
    node = tht.distgcn_15d_op(tht.placeholder_op("a"),
                              tht.placeholder_op("h"),
                              tht.placeholder_op("w"))
    mesh = make_mesh({"dp": ROW, "tp": COL}, device="cpu")
    outs = run_per_rank(
        lambda comm, a, h: node.compute(
            [a, h, torch.from_numpy(w)], TTC(device="cpu", comm=comm)),
        mesh, [(torch.from_numpy(a), torch.from_numpy(h))
               for a, h in _blocks(adj, feat)])
    outs = [o.numpy() for o in outs]
    for i in range(ROW):
        np.testing.assert_array_equal(outs[i * COL], outs[i * COL + 1])
    got = np.concatenate(outs[::COL])
    np.testing.assert_allclose(got, (adj @ feat) @ w, rtol=1e-4, atol=1e-5)

    jnode = jht.distgcn_15d_op(jht.placeholder_op("a"),
                               jht.placeholder_op("h"),
                               jht.placeholder_op("w"))
    a_spec, h_spec, w_spec = jspecs("dp", "tp")
    want = np.asarray(jax.jit(jax.shard_map(
        lambda a, h, ww: jnode.compute([a, h, ww],
                                       JTC(axis_env=("dp", "tp"))),
        mesh=jmake_mesh({"dp": ROW, "tp": COL}),
        in_specs=(a_spec, h_spec, w_spec), out_specs=P("dp", None),
        check_vma=False))(adj, feat, w))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_gcn_layer_shard_specs_match_jax():
    for axes in (("dp", "tp"), ("x", "y")):
        assert tht.gcn_layer_shard_specs(*axes) == tuple(
            tuple(s) for s in jspecs(*axes))


N, F, HID, C, STEPS = 32, 8, 16, 4, 3


def _jax_gcn(feat_dim, hidden, classes, optimizer):
    """examples/gnn/train_gcn.py's graph in the JAX package."""
    ht = jht
    a, x = ht.placeholder_op("adj"), ht.placeholder_op("feat")
    y, m = ht.placeholder_op("labels"), ht.placeholder_op("mask")
    w1 = ht.init.xavier_uniform((feat_dim, hidden), name="gcn_w1")
    w2 = ht.init.xavier_uniform((hidden, classes), name="gcn_w2")
    h = ht.relu_op(ht.distgcn_15d_op(a, x, w1))
    logits = ht.distgcn_15d_op(a, h, w2)
    masked = ht.mul_op(ht.softmaxcrossentropy_sparse_op(logits, y), m)
    loss = ht.div_op(ht.reduce_sum_op(masked, [0]), ht.reduce_sum_op(m, [0]))
    return (a, x, y, m), logits, loss, optimizer.minimize(loss)


def _steps(ex, phs, feeds):
    return [float(np.asarray(ex.run("train", feed_dict=dict(zip(phs, feeds)),
                                    convert_to_numpy_ret_vals=True)[0]))
            for _ in range(STEPS)]


def test_gcn_training_on_mesh_matches_single_device_and_jax():
    adj, feat, labels = gnn_common.sbm_graph(N, C, 0.3, 0.02, F)
    mask = (np.arange(N) % 2).astype(np.float32)
    feeds = (adj, feat, labels, mask)
    runs = {}
    for key, mesh in (("plain", None),
                      ("mesh", make_mesh({"dp": 4, "tp": 2}, device="cpu"))):
        phs, _, loss, train = train_gcn.build_gcn(
            F, HID, C, tht.optim.SGDOptimizer(learning_rate=0.1))
        ex = tht.Executor({"train": [loss, train]}, device="cpu", mesh=mesh)
        if key == "plain":
            w0 = ex.return_tensor_values()
        else:
            ex.load_dict(w0)
        runs[key] = _steps(ex, phs, feeds)
    assert runs["mesh"] == runs["plain"]
    assert runs["plain"][-1] < runs["plain"][0]
    phs, _, loss, train = _jax_gcn(F, HID, C,
                                   jht.optim.SGDOptimizer(learning_rate=0.1))
    jex = jht.Executor({"train": [loss, train]})
    jex.load_dict(w0)
    np.testing.assert_allclose(runs["plain"], _steps(jex, phs, feeds),
                               rtol=TOL, atol=TOL)


def test_train_gcn_entry_point_with_and_without_mesh():
    args = ["--device", "cpu", "--nodes", "64", "--epochs", "20"]
    plain = train_gcn.run(args)
    meshed = train_gcn.run(args + ["--mesh", "dp2xtp2"])
    assert meshed["executor"].mesh.shape == {"dp": 2, "tp": 2}
    np.testing.assert_allclose(meshed["losses"], plain["losses"], rtol=TOL,
                               atol=TOL)
    assert plain["losses"][-1] < plain["losses"][0]
    assert plain["accuracy"] > 0.5
    assert gnn_common.parse_mesh(None) is None
