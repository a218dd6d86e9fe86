"""Data and expert parallelism of the port's graph executor compute the
global-batch step, as the JAX package's ``Executor(dist_strategy=...)``
does under GSPMD: the graph is built at the global batch and each run
equals the single-device run of that batch.  Each case runs the JAX
package's executor under the same strategy, from the same initial
values (``load_dict``) on the same numpy-seeded batches, and holds the
port's losses, final variables and BatchNorm running statistics to it
within 1e-5 (JAX's own tolerance for ``TestExpertParallelExecutor``):

- a BatchNorm MLP (IN 8, HID 32, OUT 4, B 16, rows 8-15 scaled x3 + 2,
  SGD 0.1) under ``DataParallel(num_devices=2)``: BatchNorm's moments
  over all 16 rows;
- the same MLP with ReLU for BatchNorm and a loss summed over the batch,
  two steps;
- tiny ``BertForPreTraining`` (additive mask; 3 and 1 MLM labels in its
  two rows, so the masked mean's count differs by row) under
  ``DataParallel(num_devices=2)``, built at B 2;
- JAX's ``build_moe`` (E 4, D 8, F 16, 32 tokens, top-1, capacity 1.0)
  under ``ExpertParallel(ep=4, dp=1)`` and ``(ep=2, dp=4)``: the gate's
  capacities over all 32 tokens;
- the pipeline executor (pipedream, 4 microbatches) over a virtual dp 2
  on the BatchNorm MLP: each microbatch is the global batch's, so the
  run equals JAX's plain executor stepped once per microbatch.
"""

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu import models as jmodels
from hetu_tpu_torch import models as tmodels
from hetu_tpu_torch.parallel import make_mesh

IN, HID, OUT, B = 8, 32, 4, 16
TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")

@pytest.fixture(autouse=True)
def _one_thread():
    # tiny tensors: one intra-op thread is the fastest, and many
    # processes of the suite share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def mlp(ht, batchnorm=True):
    """The BatchNorm MLP, or with ReLU for BatchNorm and the summed
    loss."""
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.linear_op(x, ht.init.xavier_uniform((IN, HID), name="bn_in_w"),
                     ht.init.zeros((HID,), name="bn_in_b"))
    h = ht.layers.BatchNorm(HID, name="bn0")(h) if batchnorm \
        else ht.relu_op(h)
    logits = ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT),
                                                    name="bn_head"))
    xent = ht.softmaxcrossentropy_op(logits, y)
    loss = ht.reduce_mean_op(xent, axes=0) if batchnorm \
        else ht.reduce_sum_op(xent, axes=0)
    return x, y, loss, ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)


def mlp_batch():
    rng = np.random.RandomState(7)
    xb = rng.randn(B, IN).astype(np.float32)
    xb[8:] = xb[8:] * 3 + 2
    yb = np.eye(OUT, dtype=np.float32)[rng.randint(0, OUT, B)]
    return xb, yb


def run_both(build, jstrategy, tstrategy, feeds_of, steps):
    """JAX's executor under ``jstrategy`` and the port's under
    ``tstrategy`` from JAX's initial values, ``steps`` runs each:
    {"jax"/"torch": (losses, final variables)}."""
    out, w0 = {}, None
    for key, strategy in (("jax", jstrategy), ("torch", tstrategy)):
        m = tht if key == "torch" else jht
        phs, loss, train = build(m)
        if key == "torch":
            ex = tht.Executor({"train": [loss, train]}, device="cpu",
                              dist_strategy=strategy())
            ex.load_dict(w0)
        else:
            ex = jht.Executor({"train": [loss, train]},
                              dist_strategy=strategy())
            w0 = ex.return_tensor_values()
        feeds = feeds_of(phs)
        losses = [float(np.asarray(ex.run("train", feed_dict=feeds)[0]))
                  for _ in range(steps)]
        out[key] = (losses, ex.return_tensor_values())
    return out


def assert_same(out, rtol=0.0):
    (tl, tv), (jl, jv) = out["torch"], out["jax"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=TOL)
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=TOL, err_msg=k)


@pytest.mark.parametrize("batchnorm", [True, False],
                         ids=["batchnorm", "summed_loss"])
def test_mlp_data_parallel_is_the_global_step(batchnorm):
    xb, yb = mlp_batch()

    def build(m):
        x, y, loss, train = mlp(m, batchnorm)
        return (x, y), loss, train

    out = run_both(build, lambda: jht.dist.DataParallel(num_devices=2),
                   lambda: tht.dist.DataParallel(num_devices=2),
                   lambda p: {p[0]: xb, p[1]: yb}, steps=2)
    assert_same(out, rtol=1e-6)
    # the reference's first-step losses of this input
    want = 2.7791733 if batchnorm else 44.936451
    np.testing.assert_allclose(out["torch"][0][0], want, rtol=1e-6)
    if batchnorm:      # the running statistics are held above too
        assert any(k.endswith("_running_mean") for k in out["torch"][1])


# tiny BERT pretraining; its batch size is the case's
BERT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=32, seq_len=16,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
BERT_FEEDS = ("ids", "tok", "mask", "mlm", "nsp")


def bert_batch(batch):
    """(ids, tok, mask, mlm, nsp) of ``batch`` rows: the second row's
    mask ends at 9; 3 MLM labels in even rows, 1 in odd ones."""
    S, V = BERT_CFG["seq_len"], BERT_CFG["vocab_size"]
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (batch, S)).astype(np.int32)
    tok = np.zeros((batch, S), np.int32)
    mask = np.ones((batch, S), np.float32)
    mask[1, 9:] = 0
    mlm = np.full((batch, S), -1, np.int32)
    for r in range(batch):
        at = [1, 4, 7] if r % 2 == 0 else [3]
        mlm[r, at] = rng.randint(0, V, len(at))
    nsp = (np.arange(batch) % 2).astype(np.int32)
    return ids, tok, mask, mlm, nsp


def build_bert(m, models, batch):
    model = models.BertForPreTraining(models.BertConfig(batch_size=batch,
                                                        **BERT_CFG))
    phs = [m.placeholder_op(n) for n in BERT_FEEDS]
    loss, _, _ = model(*phs)
    return phs, loss, m.optim.SGDOptimizer(learning_rate=0.05).minimize(loss)


def test_bert_pretraining_data_parallel_at_global_batch():
    arrays = bert_batch(2)
    out = run_both(
        lambda m: build_bert(m, jmodels if m is jht else tmodels, 2),
        lambda: jht.dist.DataParallel(num_devices=2),
        lambda: tht.dist.DataParallel(num_devices=2),
        lambda p: dict(zip(p, arrays)), steps=2)
    assert_same(out, rtol=1e-5)


E, D, F, T = 4, 8, 16, 32


def build_moe(ht):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    gate = ht.layers.TopKGate(D, T, E, k=1, capacity_factor=1.0)
    experts = ht.layers.StackedExperts(E, D, F, activation="relu")
    moe = ht.layers.MoELayer(gate=gate, experts=experts, num_tokens=T,
                             embed_dim=D)
    out, l_aux = moe(x)
    logits = ht.matmul_op(out, ht.init.xavier_uniform((D, 2),
                                                      name="moe_head"))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0) \
        + ht.mul_byconst_op(l_aux, 0.01)
    return (x, y), loss, ht.optim.SGDOptimizer(
        learning_rate=0.1).minimize(loss)


@pytest.mark.parametrize("ep,dp", [(4, 1), (2, 4)], ids=["ep4", "ep2xdp4"])
def test_moe_expert_parallel_is_the_global_step(ep, dp):
    rng = np.random.RandomState(0)
    xb = rng.randn(T, D).astype(np.float32)
    yb = np.eye(2, dtype=np.float32)[(xb[:, 0] > 0).astype(int)]
    out = run_both(build_moe,
                   lambda: jht.dist.ExpertParallel(ep=ep, dp=dp),
                   lambda: tht.dist.ExpertParallel(ep=ep, dp=dp),
                   lambda p: {p[0]: xb, p[1]: yb}, steps=2)
    assert_same(out)
    np.testing.assert_allclose(out["torch"][0][0], 0.70637, atol=1e-5)


def test_pipeline_data_axis_keeps_the_global_microbatch():
    """pipedream over a virtual dp 2 == JAX's plain executor stepped once
    per microbatch of the global batch, BatchNorm statistics included."""
    M, mb = 4, B // 4
    xb, yb = mlp_batch()
    x, y, loss, train = mlp(jht)
    jex = jht.Executor({"train": [loss, train]})
    w0 = jex.return_tensor_values()
    want_l = [float(np.asarray(jex.run("train", feed_dict={
        x: xb[m * mb:(m + 1) * mb], y: yb[m * mb:(m + 1) * mb]})[0]))
        for m in range(M)]
    want = jex.return_tensor_values()
    x, y, loss, train = mlp(tht)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      pipeline="pipedream", num_stages=2, num_microbatches=M,
                      mesh=make_mesh({"dp": 2}, device="cpu"))
    ex.load_dict(w0)
    got_l = float(ex.run("train", feed_dict={x: xb, y: yb})[0])
    np.testing.assert_allclose(got_l, np.mean(want_l), rtol=1e-6)
    got = ex.return_tensor_values()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)
