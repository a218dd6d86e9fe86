"""``Executor(pipeline=...)`` of the port's graph surface
(``hetu_tpu_torch.pipeline_executor``) against the JAX package's
executor, on the models of tests/test_pipeline_executor.py and
tests/test_all_layouts.py, weights carried across with ``load_dict``:

- the residual MLP through gpipe, 1f1b and pipedream, on the microbatch
  path (no ``pp`` axis) and on the stage path (``make_mesh({"pp": 4})``
  and ``{"pp": 2, "dp": 4}``, virtual meshes), Adam, the eval subgraph,
  checkpoints (the port's own round trip, a port checkpoint continued by
  JAX's pipelined executor and back), the non-uniform fallback,
  ``non_batch_feeds`` and the divisibility error, weights tied across
  the ends, BatchNorm state chained through pipedream's microbatches;
- the tiny BERT-4L of ``TestBert4L`` on the stage path, and
  ``shard_pipeline_ends``' specs on ``TestShardedEnds``'s BERT;
- ``mixed_precision="bf16"`` through both paths (f32 masters);
- the refusals: an unknown mode, comm_mode 'Hybrid', and hetpipe (A10).

Losses within rtol 2e-4 of JAX's (its own tests' tolerance for the
pipelined BERT; the MLP cases agree to ~1e-6).
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu.models.bert import BertConfig as JBertConfig
from hetu_tpu.models.bert import \
    BertForSequenceClassification as JBertClassifier
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu_torch.models import BertConfig as TBertConfig
from hetu_tpu_torch.models import \
    BertForSequenceClassification as TBertClassifier
from hetu_tpu_torch.parallel import make_mesh
from hetu_tpu_torch.parallel.pipeline import HIGH_WATER

BATCH, IN, HID, OUT = 16, 8, 16, 4
RTOL = 2e-4


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")


def build_model(ht, opt=None, n_layers=4):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.linear_op(x, ht.init.xavier_uniform((IN, HID), name="in_w"),
                     ht.init.zeros((HID,), name="in_b"))
    for i in range(n_layers):
        w1 = ht.init.xavier_uniform((HID, 2 * HID), name=f"l{i}_w1")
        b1 = ht.init.zeros((2 * HID,), name=f"l{i}_b1")
        w2 = ht.init.xavier_uniform((2 * HID, HID), name=f"l{i}_w2")
        b2 = ht.init.zeros((HID,), name=f"l{i}_b2")
        h = h + ht.linear_op(ht.gelu_op(ht.linear_op(h, w1, b1)), w2, b2)
    logits = ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT),
                                                    name="head_w"))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0)
    opt = opt or ht.optim.SGDOptimizer(learning_rate=0.1)
    return x, y, loss, opt.minimize(loss)


def make_batches(n=6, seed=11):
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


def port(opt=None, **kw):
    x, y, loss, train = build_model(tht, opt)
    ex = tht.Executor({"train": [loss, train], "eval": [loss]},
                      device="cpu", **kw)
    return x, y, ex


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's trajectories of the MLP: the plain executor (what its sync
    pipelines equal), pipedream, and Adam; with the initial weights."""
    batches = make_batches()
    x, y, loss, train = build_model(jht)
    ex = jht.Executor({"train": [loss, train]})
    w0 = ex.return_tensor_values()
    base = traj(ex, x, y, batches)
    x, y, loss, train = build_model(jht)
    ex = jht.Executor({"train": [loss, train]}, pipeline="pipedream",
                      num_stages=2, num_microbatches=4)
    ex.load_dict(w0)
    dream = traj(ex, x, y, batches)
    x, y, loss, train = build_model(
        jht, jht.optim.AdamOptimizer(learning_rate=0.01))
    ex = jht.Executor({"train": [loss, train]}, pipeline="gpipe",
                      num_stages=4, num_microbatches=8)
    ex.load_dict(w0)
    adam = traj(ex, x, y, batches)
    return dict(w0=w0, batches=batches, base=base, pipedream=dream,
                adam=adam)


CASES = {
    "gpipe": dict(pipeline="gpipe", num_stages=2, num_microbatches=4),
    "1f1b": dict(pipeline="1f1b", num_stages=2, num_microbatches=4),
    "pipedream": dict(pipeline="pipedream", num_stages=2,
                      num_microbatches=4),
    "gpipe_pp4": dict(pipeline="gpipe", mesh=(("pp", 4),),
                      num_microbatches=4),
    "1f1b_pp4": dict(pipeline="1f1b", mesh=(("pp", 4),),
                     num_microbatches=8),
    "pipedream_pp4": dict(pipeline="pipedream", mesh=(("pp", 4),),
                          num_microbatches=4),
    "gpipe_pp2xdp4": dict(pipeline="gpipe", mesh=(("pp", 2), ("dp", 4)),
                          num_microbatches=4),
    "1f1b_pp2": dict(pipeline="1f1b", mesh=(("pp", 2),),
                     num_microbatches=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mlp_matches_jax(jax_runs, case):
    kw = dict(CASES[case])
    if "mesh" in kw:
        kw["mesh"] = make_mesh(dict(kw["mesh"]), device="cpu")
    x, y, ex = port(**kw)
    sub = ex.subexecutor["train"]
    assert sub.spmd == ("mesh" in kw and "pipedream" not in case)
    ex.load_dict(jax_runs["w0"])
    tr = traj(ex, x, y, jax_runs["batches"])
    want = jax_runs["pipedream" if "pipedream" in case else "base"]
    np.testing.assert_allclose(tr, want, rtol=RTOL, atol=1e-5)
    if case == "1f1b_pp4":
        assert HIGH_WATER["1f1b"] == 7


def test_adam_matches_jax(jax_runs):
    x, y, ex = port(tht.optim.AdamOptimizer(learning_rate=0.01),
                    pipeline="gpipe", num_stages=4, num_microbatches=8)
    ex.load_dict(jax_runs["w0"])
    np.testing.assert_allclose(traj(ex, x, y, jax_runs["batches"]),
                               jax_runs["adam"], rtol=RTOL, atol=1e-5)


def test_eval_subgraph_untouched(jax_runs):
    x, y, ex = port(pipeline="gpipe", num_stages=2, num_microbatches=4)
    assert type(ex.subexecutor["eval"]).__name__ == "SubExecutor"
    ex.load_dict(jax_runs["w0"])
    a, b = jax_runs["batches"][0]
    ev = float(ex.run("eval", feed_dict={x: a, y: b})[0])
    np.testing.assert_allclose(ev, jax_runs["base"][0], rtol=RTOL)
    np.testing.assert_allclose(traj(ex, x, y, jax_runs["batches"]),
                               jax_runs["base"], rtol=RTOL, atol=1e-5)


def test_checkpoints_cross_packages(jax_runs, tmp_path):
    """Three steps in the port, saved; JAX's pipelined executor loads the
    port's checkpoint and continues; the port loads JAX's and continues:
    each continuation equals the uninterrupted trajectory."""
    batches, base = jax_runs["batches"], jax_runs["base"]
    x, y, ex = port(pipeline="1f1b", mesh=make_mesh({"pp": 4},
                                                    device="cpu"),
                    num_microbatches=4)
    ex.load_dict(jax_runs["w0"])
    traj(ex, x, y, batches[:3])
    ex.save(str(tmp_path / "port"))
    x2, y2, ex2 = port(pipeline="gpipe", num_stages=2, num_microbatches=4)
    ex2.load(str(tmp_path / "port"))
    assert ex2.step == 3
    np.testing.assert_allclose(traj(ex2, x2, y2, batches[3:]), base[3:],
                               rtol=RTOL, atol=1e-5)
    jx, jy, jloss, jtrain = build_model(jht)
    jex = jht.Executor({"train": [jloss, jtrain]}, pipeline="gpipe",
                       num_stages=2, num_microbatches=4)
    jex.load(str(tmp_path / "port"))
    np.testing.assert_allclose(traj(jex, jx, jy, batches[3:5]), base[3:5],
                               rtol=RTOL, atol=1e-5)
    jex.save(str(tmp_path / "jax"))
    x3, y3, ex3 = port(pipeline="gpipe", mesh=make_mesh({"pp": 2},
                                                        device="cpu"),
                       num_microbatches=4)
    ex3.load(str(tmp_path / "jax"))
    np.testing.assert_allclose(traj(ex3, x3, y3, batches[5:]), base[5:],
                               rtol=RTOL, atol=1e-5)


def test_nonuniform_falls_back():
    x, y = tht.placeholder_op("x"), tht.placeholder_op("y")
    w = tht.init.xavier_uniform((IN, IN), name="shared_w2")
    h = x
    for _ in range(2):
        h = tht.gelu_op(tht.matmul_op(h, w))
    loss = tht.reduce_mean_op(tht.softmaxcrossentropy_op(
        tht.matmul_op(h, tht.init.xavier_uniform((IN, OUT), name="hw2")),
        y), axes=0)
    train = tht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      pipeline="gpipe", num_microbatches=4,
                      mesh=make_mesh({"pp": 2}, device="cpu"))
    assert not ex.subexecutor["train"].spmd
    before = ex.return_tensor_values()["shared_w2"]
    tr = traj(ex, x, y, make_batches())
    assert np.all(np.isfinite(tr))
    assert not np.allclose(ex.return_tensor_values()["shared_w2"], before)


def _const_model(ht):
    x, y, c = (ht.placeholder_op(n) for n in ("x", "y", "cmask"))
    h = ht.linear_op(x, ht.init.xavier_uniform((IN, HID), name="nb_in_w"),
                     ht.init.zeros((HID,), name="nb_in_b"))
    h = ht.matmul_op(h, c) + h
    logits = ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT),
                                                    name="nb_head"))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0)
    return x, y, c, loss, \
        ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)


def test_non_batch_feeds_and_divisibility():
    cmask = (np.eye(HID) * 0.1).astype(np.float32)
    batches = make_batches(3)
    x, y, c, loss, train = _const_model(jht)
    jex = jht.Executor({"train": [loss, train]})
    w0 = jex.return_tensor_values()
    want = [float(np.asarray(jex.run("train", feed_dict={
        x: a, y: b, c: cmask})[0])) for a, b in batches]
    x, y, c, loss, train = _const_model(tht)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      pipeline="gpipe", num_stages=2, num_microbatches=4,
                      non_batch_feeds=("cmask",))
    ex.load_dict(w0)
    got = [float(ex.run("train", feed_dict={x: a, y: b, c: cmask})[0])
           for a, b in batches]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    x, y, ex = port(pipeline="gpipe", num_stages=2, num_microbatches=4)
    with pytest.raises(ValueError, match="non_batch_feeds"):
        ex.run("train", feed_dict={x: np.zeros((15, IN), np.float32),
                                   y: np.zeros((15, OUT), np.float32)})
    x, y, ex = port(pipeline="gpipe", num_stages=2, num_microbatches=5)
    with pytest.raises(ValueError, match="divisible"):
        ex.run("train", feed_dict={x: np.zeros((16, IN), np.float32),
                                   y: np.zeros((16, OUT), np.float32)})


def _tied(ht):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    w_in = ht.init.xavier_uniform((IN, HID), name="tied_w")
    h = ht.matmul_op(x, w_in)
    for i in range(2):
        w1 = ht.init.xavier_uniform((HID, HID), name=f"t{i}_w1")
        b1 = ht.init.zeros((HID,), name=f"t{i}_b1")
        h = h + ht.gelu_op(ht.linear_op(h, w1, b1))
    logits = ht.matmul_op(h, w_in, trans_B=True)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0)
    return x, y, loss, \
        ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)


def test_tied_weights_across_pre_post():
    rng = np.random.RandomState(2)
    batches = [(rng.randn(BATCH, IN).astype(np.float32),
                np.eye(IN, dtype=np.float32)[rng.randint(0, IN, BATCH)])
               for _ in range(4)]
    x, y, loss, train = _tied(jht)
    jex = jht.Executor({"train": [loss, train]})
    w0 = jex.return_tensor_values()
    want = traj(jex, x, y, batches)
    x, y, loss, train = _tied(tht)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      pipeline="gpipe", num_microbatches=4,
                      mesh=make_mesh({"pp": 2}, device="cpu"))
    assert ex.subexecutor["train"].spmd
    ex.load_dict(w0)
    np.testing.assert_allclose(traj(ex, x, y, batches), want, rtol=RTOL,
                               atol=1e-5)


def _bn(ht):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.linear_op(x, ht.init.xavier_uniform((IN, HID), name="bn_in_w"),
                     ht.init.zeros((HID,), name="bn_in_b"))
    h = ht.layers.BatchNorm(HID, name="bn0")(h)
    logits = ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT),
                                                    name="bn_head"))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0)
    return x, y, loss, \
        ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)


def test_bn_state_chains_through_microbatches():
    """pipedream == JAX's plain executor stepped once per microbatch,
    running statistics included."""
    M, mb = 4, BATCH // 4
    rng = np.random.RandomState(7)
    xb = rng.randn(BATCH, IN).astype(np.float32)
    yb = np.eye(OUT, dtype=np.float32)[rng.randint(0, OUT, BATCH)]
    x, y, loss, train = _bn(jht)
    jex = jht.Executor({"train": [loss, train]})
    w0 = jex.return_tensor_values()
    for m in range(M):
        jex.run("train", feed_dict={x: xb[m * mb:(m + 1) * mb],
                                    y: yb[m * mb:(m + 1) * mb]})
    want = jex.return_tensor_values()
    x, y, loss, train = _bn(tht)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      pipeline="pipedream", num_stages=2,
                      num_microbatches=M)
    ex.load_dict(w0)
    ex.run("train", feed_dict={x: xb, y: yb})
    got = ex.return_tensor_values()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def _bert(ht, cfg_cls, model_cls, batch, V=100, H=32, L=4, S=16):
    cfg = cfg_cls(vocab_size=V, hidden_size=H, num_hidden_layers=L,
                  num_attention_heads=2, intermediate_size=2 * H,
                  seq_len=S, batch_size=batch, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    ids, labels = ht.placeholder_op("input_ids"), ht.placeholder_op("labels")
    loss, _ = model_cls(cfg, num_labels=3)(ids, labels=labels)
    return ids, labels, loss, \
        ht.optim.SGDOptimizer(learning_rate=0.05).minimize(loss)


@pytest.mark.parametrize("mode", ["gpipe", "1f1b"])
def test_bert4l_stage_path_matches_jax(mode):
    B, S, V, M = 8, 16, 100, 4
    rng = np.random.RandomState(5)
    batches = [(rng.randint(0, V, (B, S)).astype(np.int32),
                rng.randint(0, 3, (B,)).astype(np.int32)) for _ in range(3)]
    ids, labels, loss, train = _bert(jht, JBertConfig, JBertClassifier, B)
    jex = jht.Executor({"train": [loss, train]})
    w0 = jex.return_tensor_values()
    want = traj(jex, ids, labels, batches)
    ids, labels, loss, train = _bert(tht, TBertConfig, TBertClassifier,
                                     B // M)
    ex = tht.Executor({"train": [loss, train]}, device="cpu", pipeline=mode,
                      mesh=make_mesh({"pp": 2}, device="cpu"),
                      num_microbatches=M)
    sub = ex.subexecutor["train"]
    assert sub.spmd and sub.plan.num_body_blocks() == 4
    ex.load_dict(w0)
    np.testing.assert_allclose(traj(ex, ids, labels, batches), want,
                               rtol=RTOL)


def test_shard_pipeline_ends_specs_equal_jax():
    """``TestShardedEnds``' BERT (V 4096, H 64, 4 layers, pp 2): the
    same variables get the same 'pp' specs, each stage stores half of the
    word embeddings, and the body layers stay whole."""
    def specs(ht, cfg_cls, model_cls, mesh, **kw):
        ids, labels, loss, train = _bert(ht, cfg_cls, model_cls, 2,
                                         V=4096, H=64)
        ex = ht.Executor({"train": [loss, train]}, pipeline="gpipe",
                         mesh=mesh, num_microbatches=4, **kw)
        return ex, {k: None if v.sharding_spec is None
                    else tuple(v.sharding_spec)
                    for k, v in ex.variables.items()}

    _, want = specs(jht, JBertConfig, JBertClassifier, jmake_mesh({"pp": 2}))
    ex, got = specs(tht, TBertConfig, TBertClassifier,
                    make_mesh({"pp": 2}, device="cpu"), device="cpu")
    assert got == want
    assert got["bert_embeddings_word_embeddings"] == ("pp", None)
    shards = ex.local_shards("bert_embeddings_word_embeddings")
    assert [tuple(s.shape) for s in shards] == [(2048, 64)] * 2
    assert ex.param_sharding("bert_layer0_attn_q_weight") is None


@pytest.mark.parametrize("spmd", [False, True], ids=["microbatch", "stage"])
def test_bf16_pipeline_trains_f32_masters(spmd):
    kw = dict(pipeline="gpipe", num_microbatches=4, mixed_precision="bf16")
    if spmd:
        kw["mesh"] = make_mesh({"pp": 2}, device="cpu")
    else:
        kw["num_stages"] = 2
    x, y, ex = port(**kw)
    assert ex.subexecutor["train"].spmd == spmd
    tr = traj(ex, x, y, make_batches(10))
    assert np.all(np.isfinite(tr))
    assert np.mean(tr[-3:]) < np.mean(tr[:3]), tr
    assert ex.var_values["l0_w1"].dtype == torch.float32


def test_refusals():
    with pytest.raises(ValueError, match="zigzag"):
        tht.HetuConfig(pipeline="zigzag")
    x, y, loss, train = build_model(tht)
    with pytest.raises(NotImplementedError):
        tht.Executor({"train": [loss, train]}, device="cpu",
                     pipeline="gpipe", comm_mode="Hybrid")
    with pytest.raises(NotImplementedError, match="A10"):
        tht.Executor({"train": [loss, train]}, device="cpu",
                     pipeline="hetpipe", num_stages=2)
    with pytest.raises(NotImplementedError, match="A10"):
        tht.HetuConfig(use_preduce=True)
    with pytest.raises(NotImplementedError, match="exactly one optimizer"):
        tht.Executor({"train": [loss, train, train]}, device="cpu",
                     pipeline="gpipe")
    with pytest.raises(NotImplementedError, match=r"\[loss, train_op\]"):
        tht.Executor({"train": [loss, loss, train]}, device="cpu",
                     pipeline="gpipe")
