"""The port's tensor-parallel compute split against the JAX package and
its own unplaced runs, on the CPU, at tiny sizes.

Serving (``models.gpt_decode.tp_shard_params``):

- JAX's ``TestTensorParallelDecode`` inputs: a GPT of 2 layers, hidden
  32, 4 heads, trained here by the port's graph executor (150 Adam
  steps on the +1 mapping), placed over a virtual tp 4: each rank's q
  weight is (32, 8), and ``generate_fast``'s greedy tokens equal the
  unplaced port's and JAX's ``generate_fast`` on the same numpy dict
  (exact);
- the head-divisibility and absent-axis ``ValueError``; ``prep_param``
  keeps the placement;
- ``ServingEngine`` over a placed dict in all four layout/scheduler
  configurations, plain, with ``spec=3`` and with int8 KV: every
  request's tokens (greedy and sampled) equal the unplaced engine's,
  and ``cache_bytes`` is one rank's (1/tp of the unplaced); plain and
  with ``spec=3`` the greedy tokens also equal those of JAX's
  ``ServingEngine`` over JAX's ``tp_shard_params`` of the same dict on
  a tp-4 mesh of host devices (int8 is held to JAX through the
  unplaced engine, ``test_torch_int8.py``);
- an MoE GPT splits its attention and dense FFN blocks, its gate and
  expert stacks whole, the engine's tokens and expert load unchanged;
- ``swap_params`` into a placed dict equals a fresh engine on the new
  weights; the handoff wire between a tp engine and a plain one holds
  whole heads both ways (1e-6);
- one gloo world of two processes (a tp-2 ``DeviceMesh``; gloo timeout
  60 s, join 300 s): each process stores half of every split weight and
  half the cache, the engine's greedy tokens equal the unplaced
  engine's, its export equals the virtual mesh's, and the graph MLP's
  tp-2 trajectory equals the plain one (1e-6) with no gather.

Training (``graph/tensor_parallel.py``):

- JAX's ``TestGPTLayouts`` specs (tp 2, tp 2 x dp 4; the fused q/k/v
  product over split weights), unfused and flash, within 1e-5 relative
  of JAX's single-device trajectory (which JAX's own layouts test holds
  its tp runs to), with ``tp_gathers == 0``;
- BERT's Megatron ``ShardingPlan`` (phase 15b's specs) over dp 2 x tp 2
  and tp 4 against the plain executor (1e-6 relative), with no gather,
  and over dp 2 x tp 2 within 1e-5 relative of JAX's executor under the
  same plan;
- a split value read by an op outside the pattern is gathered and
  counted, as is each whole read by the pipeline executor's
  microbatches; the per-rank reshape divides the split dim of the whole
  target shape (a per-rank ``-1`` would fold the heads into the batch).

The MLP layouts of ``test_all_layouts.py`` (tp2, tp2_patterns,
explicit_plan, tp2xdp4) are held to JAX in test_torch_strategies.py;
here they assert ``tp_gathers == 0``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu.models import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt_decode import generate_fast as jgenerate_fast

import hetu_tpu_torch.graph as tht
from hetu_tpu_torch import models as tmodels
from hetu_tpu_torch.graph.tensor_parallel import RankVals, TPRun
from hetu_tpu_torch.models import gpt as tgpt
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.models.gpt_config import GPTConfig as TGPTConfig
from hetu_tpu_torch.parallel import make_mesh
from hetu_tpu_torch.parallel.sharding import Placed, group_of, placement
from hetu_tpu_torch.serving import Request, ServingEngine
from hetu_tpu_torch.weights import prep_param
from test_torch_gpt_decode import rand_gpt

REPO = Path(__file__).resolve().parent.parent

TQ = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=16, batch_size=4,
          seq_len=16, dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the graph executor refuses HETU_VALIDATE (A11); tiny tensors run
    # fastest on one intra-op thread
    monkeypatch.setenv("HETU_VALIDATE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(tp, **axes):
    return make_mesh({**axes, "tp": tp}, device="cpu")


# ------------------------------------------------------------------- #
# serving
# ------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def trained():
    """JAX's TestTensorParallelDecode model, trained by the port's graph
    executor: numpy params."""
    torch.set_num_threads(1)
    os.environ["HETU_VALIDATE"] = "0"
    try:
        m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TQ), name="tq")
        ids, labels = tht.placeholder_op("tq_ids"), \
            tht.placeholder_op("tq_labels")
        loss, _ = m(ids, labels=labels)
        train = tht.optim.AdamOptimizer(learning_rate=3e-3).minimize(loss)
        ex = tht.Executor({"train": [loss, train]}, device="cpu")
        rng = np.random.RandomState(1)
        for _ in range(150):
            iv = rng.randint(0, 61, (4, 16)).astype(np.int32)
            ex.run("train", feed_dict={
                ids: iv, labels: ((iv + 1) % 61).astype(np.int32)})
        return ex.return_tensor_values()
    finally:
        os.environ["HETU_VALIDATE"] = "1"


def test_tp4_matches_unplaced_and_jax(trained):
    cfg = TGPTConfig(**TQ)
    base = tgd.generate_fast(trained, cfg, [7, 8, 9], num_tokens=6,
                             device="cpu")
    mesh = _mesh(4)
    placed = tgd.tp_shard_params(trained, mesh, cfg)
    w = placed["tq_h0_attn_q_weight"]
    group, dim = group_of(w), placement(w)[2]
    assert dim == 1 and group.n == 4
    assert {tuple(group.piece(w, r).shape) for r in group.ranks} == {(32, 8)}
    assert placement(placed["tq_h0_attn_proj_weight"])[2] == 0
    assert placement(placed["tq_h0_attn_q_bias"])[2] == 0
    for k in ("tq_h0_attn_proj_bias", "tq_h0_ffn_wo_bias", "tq_wte_table",
              "tq_h0_ln1_scale"):
        assert placement(placed[k]) is None, k
    out = tgd.generate_fast(placed, cfg, [7, 8, 9], num_tokens=6,
                            device="cpu")
    jout = jgenerate_fast(trained, JGPTConfig(**TQ), [7, 8, 9],
                          num_tokens=6)
    assert out[0].tolist() == base[0].tolist() == \
        np.asarray(jout)[0].tolist()
    assert out[0].tolist() == list(range(7, 16))


@pytest.mark.parametrize("heads,mesh", [(3, {"tp": 4}), (4, {"dp": 4})],
                         ids=["indivisible", "no-tp-axis"])
def test_tp_shard_params_refuses_before_placement(heads, mesh):
    cfg = TGPTConfig(vocab_size=61, hidden_size=12, num_hidden_layers=1,
                     num_attention_heads=heads, max_position_embeddings=8,
                     seq_len=8)
    with pytest.raises(ValueError):
        tgd.tp_shard_params({"g_wte_table": np.zeros((61, 12))},
                            make_mesh(mesh, device="cpu"), cfg)


def test_prep_param_keeps_the_placement():
    p, _, cfg = rand_gpt()
    placed = tgd.tp_shard_params(p, _mesh(2), cfg)
    w = placed["rg_h0_ffn_wi_weight"]
    for v in (prep_param(w, "cpu"), prep_param(w, "cpu", torch.bfloat16),
              w.clone(), w.contiguous()):
        assert isinstance(v, Placed)
        assert placement(v) == placement(w)
    assert type(w @ torch.ones(256, 1)) is torch.Tensor
    # the engine's own copies of a placed dict keep it too
    eng = ServingEngine(placed, cfg, slots=2, device="cpu")
    assert placement(eng.params["rg_h1_ffn_wo_weight"])[2] == 0


PROMPTS = [(list(range(20, 32)) + [1, 2, 3], 6, 0.0, 0), ([3, 4], 8, 0.0, 0),
           (list(range(20, 32)) + [5, 6], 5, 0.0, 0), ([11], 7, 0.0, 0),
           (list(range(7, 18)), 5, 0.9, 5)]
CONFIGS = {
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=True, kv_block=8, ragged=False,
                        prefill_chunk=4, prefix_share=True),
    "contiguous-mixed": dict(paged=False, ragged=True),
    "paged-mixed": dict(paged=True, kv_block=8, ragged=True,
                        prefill_chunk=4, prefix_share=True),
}


def _serve(params, cfg, **kw):
    eng = ServingEngine(params, cfg, slots=4, device="cpu", **kw)
    res = eng.run([Request(prompt=p, max_new_tokens=n, temperature=t,
                           top_k=k, seed=i, request_id=f"r{i}")
                   for i, (p, n, t, k) in enumerate(PROMPTS)])
    return {k: v.tokens.tolist() for k, v in res.items()}, eng


@pytest.fixture(scope="module")
def rg():
    p, jcfg, cfg = rand_gpt()
    return {k: v.astype(np.float32) for k, v in p.items()}, cfg, jcfg


def _jax_serve(p, jcfg, **kw):
    """The greedy requests' tokens of JAX's ServingEngine over JAX's
    ``tp_shard_params`` of ``p`` on a tp-4 mesh of host devices."""
    from hetu_tpu.models.gpt_decode import tp_shard_params
    from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
    from hetu_tpu.serving import Request as JRequest
    from hetu_tpu.serving import ServingEngine as JEngine
    eng = JEngine(tp_shard_params(p, jmake_mesh({"tp": 4}), jcfg), jcfg,
                  slots=4, fast_path=False, **kw)
    res = eng.run([JRequest(prompt=pr, max_new_tokens=n, temperature=t,
                            top_k=k, seed=i, request_id=f"r{i}")
                   for i, (pr, n, t, k) in enumerate(PROMPTS)])
    return {f"r{i}": res[f"r{i}"].tokens.tolist()
            for i, (_, _, t, _) in enumerate(PROMPTS) if t == 0.0}


@pytest.mark.parametrize("extra", [{}, {"spec": 3}, {"kv_quant": "int8"}],
                         ids=["plain", "spec", "int8"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_over_placed_params(rg, config, extra):
    p, cfg, jcfg = rg
    want, plain = _serve(p, cfg, **CONFIGS[config], **extra)
    got, eng = _serve(tgd.tp_shard_params(p, _mesh(4), cfg), cfg,
                      **CONFIGS[config], **extra)
    assert got == want
    if not extra.get("kv_quant"):
        jgot = _jax_serve(p, jcfg, **CONFIGS[config], **extra)
        assert {k: got[k] for k in jgot} == jgot
    assert eng.kv.cache_bytes * 4 == plain.kv.cache_bytes
    if extra.get("spec"):
        assert eng.spec_proposed > 0


def test_moe_gpt_splits_attention_and_dense_blocks_only():
    """An MoE GPT: attention and the dense FFN blocks split, the gate and
    expert stacks whole (JAX's patterns do not match them); the engine's
    tokens equal the unplaced engine's."""
    from hetu_tpu_torch.models.moe_decode import (MoEDecodeConfig,
                                                  init_moe_params)
    cfg = MoEDecodeConfig(vocab_size=97, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=2,
                          ffn_mult=2, seq_len=48, dropout_rate=0.0,
                          max_position_embeddings=48, num_experts=4,
                          top_k=2, capacity_factor=2.0, moe_every=2)
    p = init_moe_params(cfg, name="moe")
    placed = tgd.tp_shard_params(p, _mesh(2), cfg)
    split = {k for k, v in placed.items() if placement(v) is not None}
    assert "moe_h0_ffn_wi_weight" in split and "moe_h1_attn_v_bias" in split
    assert not any("_moe_" in k for k in split)
    assert "moe_h1_ffn_wi_weight" not in placed     # block 1 is routed
    runs = []
    for params in (p, placed):
        eng = ServingEngine(params, cfg, slots=2, device="cpu", name="moe",
                            **CONFIGS["paged-mixed"])
        runs.append((eng.run([Request(prompt=[5, 9, 2, 7], max_new_tokens=6,
                                      request_id="m")])["m"].tokens.tolist(),
                     eng.expert_load.tolist()))
    assert runs[0] == runs[1]


def test_swap_params_into_placed(rg):
    p, cfg, _ = rg
    new = {k: v.astype(np.float32) for k, v in rand_gpt(seed=1)[0].items()}
    eng = ServingEngine(tgd.tp_shard_params(p, _mesh(2), cfg), cfg, slots=4,
                        device="cpu", **CONFIGS["paged-mixed"])
    eng.swap_params(new)
    got = eng.run([Request(prompt=[3, 4, 5], max_new_tokens=6,
                           request_id="a")])["a"].tokens.tolist()
    want = ServingEngine(new, cfg, slots=4, device="cpu",
                         **CONFIGS["paged-mixed"]).run(
        [Request(prompt=[3, 4, 5], max_new_tokens=6,
                 request_id="a")])["a"].tokens.tolist()
    assert got == want
    bad = dict(new, rg_h0_attn_q_weight=np.zeros((64, 32), np.float32))
    with pytest.raises(ValueError):
        eng.swap_params(bad)


def _exported(params, cfg, layout):
    """The KV payload of one request, exported at its retirement."""
    eng = ServingEngine(params, cfg, slots=2, device="cpu",
                        **CONFIGS[layout])
    out = {}
    eng.retire_hook = lambda req, slot: out.setdefault(
        "payload", eng.kv.export_blocks(slot))
    eng.run([Request(prompt=list(range(3, 14)), max_new_tokens=3,
                     request_id="x")])
    return out["payload"], eng


@pytest.mark.parametrize("layout", ["contiguous-mixed", "paged-mixed"])
def test_handoff_between_tp_and_plain(rg, layout):
    p, cfg, _ = rg
    want, plain = _exported(p, cfg, layout)
    got, tp = _exported(tgd.tp_shard_params(p, _mesh(4), cfg), cfg, layout)
    assert got["k"].shape == want["k"].shape       # whole heads
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-6)
    # both ways: the plain wire into the tp engine's cache and back out
    for src, dst in ((want, tp.kv), (got, plain.kv)):
        slot = dst.import_blocks(src, "y")
        back = dst.export_blocks(slot)
        for key in ("k", "v"):
            np.testing.assert_array_equal(back[key], src[key])


# ------------------------------------------------------------------- #
# training on the graph
# ------------------------------------------------------------------- #

GPT_TP_SPECS = {}
for _i in range(2):
    for _n in ("attn_q_weight", "attn_k_weight", "attn_v_weight",
               "ffn_wi_weight"):
        GPT_TP_SPECS[f"g_h{_i}_{_n}"] = (None, "tp")
    for _n in ("attn_proj_weight", "ffn_wo_weight"):
        GPT_TP_SPECS[f"g_h{_i}_{_n}"] = ("tp", None)
GPT_CFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=16,
               batch_size=8, seq_len=16, dropout_rate=0.0)


def _gpt_batches():
    rng = np.random.RandomState(2)
    out = []
    for _ in range(6):
        iv = rng.randint(0, 61, (8, 16)).astype(np.int32)
        out.append((iv, ((iv + 1) % 61).astype(np.int32)))
    return out


def _build_gpt(ht, models, flash=False):
    kw = dict(GPT_CFG, use_flash=True) if flash else GPT_CFG
    m = models.GPTForCausalLM(models.GPTConfig(**kw), name="g")
    ids, labels = ht.placeholder_op("g_ids"), ht.placeholder_op("g_labels")
    loss, _ = m(ids, labels=labels)
    train = ht.optim.AdamOptimizer(learning_rate=3e-3).minimize(loss)
    return ids, labels, loss, train


@pytest.fixture(scope="module")
def gpt_jax():
    """JAX's single-device GPT trajectory (TestGPTLayouts' baseline) from
    the port executor's initial values (given to the JAX graph's
    variables: its initializers would compile once per shape), and those
    values."""
    from hetu_tpu.models import gpt as jgpt
    from test_torch_zoo import seed_jax_variables
    os.environ["HETU_VALIDATE"] = "0"
    try:
        w0 = tht.Executor({"train": list(_build_gpt(tht, tgpt)[2:])},
                          device="cpu").return_tensor_values()
    finally:
        os.environ["HETU_VALIDATE"] = "1"
    ids, labels, loss, train = _build_gpt(jht, jgpt)
    seed_jax_variables([loss, train], w0)
    ex = jht.Executor({"train": [loss, train]})
    base = [float(np.asarray(ex.run("train", feed_dict={
        ids: a, labels: b})[0])) for a, b in _gpt_batches()]
    assert base[-1] < base[0]
    return w0, base


@pytest.mark.parametrize("flash", [False, True], ids=["unfused", "flash"])
@pytest.mark.parametrize("dp", [1, 4], ids=["tp2", "tp2xdp4"])
def test_gpt_layouts_split_per_rank(gpt_jax, dp, flash):
    w0, base = gpt_jax
    ids, labels, loss, train = _build_gpt(tht, tgpt, flash)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=tht.dist.ModelParallel4LM(
                          tp=2, dp=dp, specs=GPT_TP_SPECS))
    ex.load_dict(w0)
    got = []
    for a, b in _gpt_batches():
        got.append(float(ex.run("train", feed_dict={ids: a, labels: b})[0]))
        assert ex.tp_gathers == 0
    np.testing.assert_allclose(got, base, rtol=1e-5)
    assert ex.tp_run.n == 2 and len(ex.tp_run.split_vars) == 12


def _bert_specs(L):
    tp = {}
    for i in range(L):
        pre = f"bert_layer{i}_"
        for n in ("attn_q", "attn_k", "attn_v", "intermediate"):
            tp[pre + n + "_weight"] = (None, "tp")
            tp[pre + n + "_bias"] = ("tp",)
        for n in ("attn_proj_weight", "output_weight"):
            tp[pre + n] = ("tp", None)
    return tp


def _build_bert(flash, ht=tht, models=tmodels):
    cfg = models.BertConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, batch_size=4, seq_len=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        use_flash_attention=flash)
    ids, labels = ht.placeholder_op("input_ids"), \
        ht.placeholder_op("labels")
    loss, _ = models.BertForSequenceClassification(cfg, num_labels=3)(
        ids, labels=labels)
    train = ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return ids, labels, loss, train


def _bert_batches():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 100, (4, 16)).astype(np.int32),
             rng.randint(0, 3, (4,)).astype(np.int32)) for _ in range(3)]


@pytest.fixture(scope="module")
def bert_jax():
    """JAX's executor under the same dp 2 x tp 2 ShardingPlan (unfused),
    from the port executor's initial values: its trajectory."""
    from jax.sharding import PartitionSpec as P

    from hetu_tpu import models as jmodels
    from test_torch_zoo import seed_jax_variables
    os.environ["HETU_VALIDATE"] = "0"
    try:
        w0 = tht.Executor({"train": list(_build_bert(False)[2:])},
                          device="cpu").return_tensor_values()
    finally:
        os.environ["HETU_VALIDATE"] = "1"
    ids, labels, loss, train = _build_bert(False, jht, jmodels)
    seed_jax_variables([loss, train], w0)
    ex = jht.Executor({"train": [loss, train]},
                      dist_strategy=jht.dist.ShardingPlan(
                          {k: P(*v) for k, v in _bert_specs(2).items()},
                          mesh_axes={"dp": 2, "tp": 2}))
    return [float(np.asarray(ex.run("train", feed_dict={
        ids: a, labels: b})[0])) for a, b in _bert_batches()]


@pytest.mark.parametrize("flash", [False, True], ids=["unfused", "flash"])
def test_bert_sharding_plan_split_per_rank(bert_jax, flash):
    batches = _bert_batches()
    ids, labels, loss, train = _build_bert(flash)
    ex0 = tht.Executor({"train": [loss, train]}, device="cpu")
    w0 = ex0.return_tensor_values()
    base = [float(ex0.run("train", feed_dict={ids: a, labels: b})[0])
            for a, b in batches]
    want = ex0.return_tensor_values()
    for axes in ({"dp": 2, "tp": 2}, {"tp": 4}):
        ids, labels, loss, train = _build_bert(flash)
        ex = tht.Executor({"train": [loss, train]}, device="cpu",
                          dist_strategy=tht.dist.ShardingPlan(
                              _bert_specs(2), mesh_axes=axes))
        ex.load_dict(w0)
        got = []
        for a, b in batches:
            got.append(float(ex.run("train", feed_dict={
                ids: a, labels: b})[0]))
            assert ex.tp_gathers == 0
        np.testing.assert_allclose(got, base, rtol=1e-6)
        if axes == {"dp": 2, "tp": 2}:
            np.testing.assert_allclose(got, bert_jax, rtol=1e-5)
        for k, v in ex.return_tensor_values().items():
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def _mlp(head_split):
    x, y = tht.placeholder_op("x"), tht.placeholder_op("y")
    w1 = tht.init.xavier_uniform((8, 32), name="mlp_fc1_weight")
    b1 = tht.init.zeros((32,), name="mlp_fc1_bias")
    w2 = tht.init.xavier_uniform((32, 8), name="mlp_fc2_weight")
    b2 = tht.init.zeros((8,), name="mlp_fc2_bias")
    wh = tht.init.xavier_uniform((8, 4), name="mlp_head_weight")
    h = tht.linear_op(tht.gelu_op(tht.linear_op(x, w1, b1)), w2, b2)
    loss = tht.reduce_mean_op(tht.softmaxcrossentropy_op(
        tht.matmul_op(h, wh), y), axes=0)
    train = tht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    specs = {"mlp_fc1_weight": (None, "tp"), "mlp_fc1_bias": ("tp",),
             "mlp_fc2_weight": ("tp", None)}
    if head_split:
        specs["mlp_head_weight"] = (None, "tp")
    return x, y, loss, train, specs


@pytest.mark.parametrize("layout", ["tp2", "tp2_patterns", "explicit_plan",
                                    "tp2xdp4"])
def test_mlp_layouts_run_without_gathers(layout):
    x, y, loss, train, specs = _mlp(False)
    strategy = {
        "tp2": lambda: tht.dist.ModelParallel4LM(tp=2, dp=1, specs=specs),
        "tp2_patterns": lambda: tht.dist.ModelParallel4LM(tp=2, dp=1),
        "explicit_plan": lambda: tht.dist.ShardingPlan(
            specs, mesh_axes={"dp": 4, "tp": 2}),
        "tp2xdp4": lambda: tht.dist.ModelParallel4LM(tp=2, dp=4,
                                                     specs=specs)}[layout]
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=strategy())
    rng = np.random.RandomState(3)
    xb = rng.randn(16, 8).astype(np.float32)
    ex.run("train", feed_dict={x: xb, y: np.eye(4, dtype=np.float32)[
        xb[:, :4].argmax(1)]})
    assert ex.tp_run is not None and ex.tp_gathers == 0


def test_split_value_outside_the_pattern_is_gathered_and_counted():
    x, y, loss, train, specs = _mlp(True)
    ex0 = tht.Executor({"train": [loss, train]}, device="cpu")
    w0 = ex0.return_tensor_values()
    rng = np.random.RandomState(3)
    xb = rng.randn(16, 8).astype(np.float32)
    yb = np.eye(4, dtype=np.float32)[xb[:, :4].argmax(1)]
    want = [float(ex0.run("train", feed_dict={x: xb, y: yb})[0])
            for _ in range(3)]
    x, y, loss, train, specs = _mlp(True)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      dist_strategy=tht.dist.ShardingPlan(
                          specs, mesh_axes={"tp": 2}))
    ex.load_dict(w0)
    got = [float(ex.run("train", feed_dict={x: xb, y: yb})[0])
           for _ in range(3)]
    # the head's column product splits the logits, which the loss reads
    # whole
    assert ex.tp_gathers >= 1
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pipeline_stages_count_their_whole_reads():
    """The pipeline executor's microbatches read each split value whole:
    one counted gather per split variable per microbatch, and the
    trajectory is the plain executor's."""
    x, y, loss, train, specs = _mlp(False)
    ex0 = tht.Executor({"train": [loss, train]}, device="cpu")
    w0 = ex0.return_tensor_values()
    rng = np.random.RandomState(3)
    xb = rng.randn(16, 8).astype(np.float32)
    yb = np.eye(4, dtype=np.float32)[xb[:, :4].argmax(1)]
    want = [float(ex0.run("train", feed_dict={x: xb, y: yb})[0])
            for _ in range(2)]
    x, y, loss, train, specs = _mlp(False)
    ex = tht.Executor({"train": [loss, train]}, device="cpu",
                      pipeline="gpipe", num_stages=2, num_microbatches=4,
                      dist_strategy=tht.dist.ShardingPlan(
                          specs, mesh_axes={"tp": 2}))
    ex.load_dict(w0)
    got = []
    for _ in range(2):
        got.append(float(ex.run("train", feed_dict={x: xb, y: yb})[0]))
        assert ex.tp_gathers == len(specs) * 4
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_per_rank_reshape_does_not_fold_heads_into_the_batch():
    B, S, nh, hd, tp = 2, 4, 4, 3, 2
    node = tht.array_reshape_op(tht.placeholder_op("x"), [-1, S, nh, hd])
    run = TPRun(_mesh(tp), {})
    whole = torch.arange(B * S * nh * hd, dtype=torch.float32).reshape(
        B * S, nh * hd)
    out = run.compute(node, [run.scatter(whole, 1)], None)
    assert isinstance(out, RankVals) and out.dim == 2
    assert [tuple(p.shape) for p in out.parts] == [(B, S, nh // tp, hd)] * tp
    torch.testing.assert_close(run.join(out), whole.reshape(B, S, nh, hd),
                               rtol=0, atol=0)
    # the whole-width shape with its -1 on a rank's piece is the silent
    # fold the planner avoids
    naive = torch.reshape(run.scatter(whole, 1).parts[0], [-1, S, nh, hd])
    assert tuple(naive.shape) == (B // tp, S, nh, hd)
    # and back: [B, S, nh/tp, hd] -> [-1, nh * hd] keeps the rank's heads
    back = tht.array_reshape_op(tht.placeholder_op("y"), [-1, nh * hd])
    flat = run.compute(back, [out], None)
    assert [tuple(p.shape) for p in flat.parts] == \
        [(B * S, nh * hd // tp)] * tp
    torch.testing.assert_close(run.join(flat), whole, rtol=0, atol=0)
    assert run.gathers == 0


# ------------------------------------------------------------------- #
# torch.distributed: one gloo world of two processes, a tp-2 DeviceMesh
# ------------------------------------------------------------------- #

WORLD = 2
GLOO_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300

_WORKER = textwrap.dedent('''
    import datetime, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    os.environ["HETU_VALIDATE"] = "0"
    import hetu_tpu_torch.graph as ht
    from hetu_tpu_torch.models import gpt_decode as gd
    from hetu_tpu_torch.models.gpt_config import GPTConfig
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.collectives import ProcessComm
    from hetu_tpu_torch.serving import Request, ServingEngine

    rank, world, init, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds={gloo_timeout}))
    d = dict(np.load(data))
    res = {{}}
    mesh = make_mesh({{"tp": world}})
    res["rank"] = np.array(ProcessComm(mesh).index("tp"))
    cfg = GPTConfig(**{cfg})
    params = {{k[2:]: v for k, v in d.items() if k.startswith("p/")}}
    placed = gd.tp_shard_params(params, mesh, cfg)
    for k in ("rg_h0_attn_q_weight", "rg_h0_attn_q_bias",
              "rg_h1_ffn_wo_weight", "rg_h1_ffn_wo_bias"):
        res["stored/" + k] = placed[k].as_subclass(torch.Tensor).numpy()
    eng = ServingEngine(placed, cfg, slots=2, paged=True, kv_block=8,
                        ragged=True, device="cpu")
    got = {{}}
    eng.retire_hook = lambda req, slot: got.setdefault(
        req.request_id, eng.kv.export_blocks(slot))
    toks = eng.run([Request(request_id="0", prompt=list(range(3, 14)),
                            max_new_tokens=3)])
    res["engine"] = np.asarray(toks["0"].tokens)
    res["cache_bytes"] = np.array(eng.kv.cache_bytes)
    res["export_k"] = got["0"]["k"]
    # the graph MLP split over tp 2: a trajectory and its gathers
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    w1 = ht.Variable("mlp_fc1_weight", value=d["m/w1"])
    b1 = ht.Variable("mlp_fc1_bias", value=d["m/b1"])
    w2 = ht.Variable("mlp_fc2_weight", value=d["m/w2"])
    b2 = ht.Variable("mlp_fc2_bias", value=d["m/b2"])
    h = ht.linear_op(ht.gelu_op(ht.linear_op(x, w1, b1)), w2, b2)
    loss = ht.reduce_mean_op(ht.reduce_sum_op(h * h, axes=1), axes=0)
    train = ht.optim.SGDOptimizer(learning_rate=0.05).minimize(loss)
    ex = ht.Executor({{"train": [loss, train]}}, device="cpu",
                     dist_strategy=ht.dist.
                     ShardingPlan({{"mlp_fc1_weight": (None, "tp"),
                                   "mlp_fc1_bias": ("tp",),
                                   "mlp_fc2_weight": ("tp", None)}},
                                  mesh_axes={{"tp": world}}))
    traj, gathers = [], []
    for _ in range(3):
        traj.append(float(ex.run("train", feed_dict={{x: d["m/x"]}})[0]))
        gathers.append(ex.tp_gathers)
    res["mlp"] = np.array(traj)
    res["mlp_gathers"] = np.array(gathers)
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
''')


def _mlp_data():
    rng = np.random.RandomState(5)
    return {"m/w1": rng.randn(8, 16).astype(np.float32) * 0.3,
            "m/b1": rng.randn(16).astype(np.float32) * 0.1,
            "m/w2": rng.randn(16, 8).astype(np.float32) * 0.3,
            "m/b2": rng.randn(8).astype(np.float32) * 0.1,
            "m/x": rng.randn(6, 8).astype(np.float32)}


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory, rg):
    tmp = tmp_path_factory.mktemp("gloo_tp")
    p, cfg, _ = rg
    np.savez(tmp / "data.npz", **{f"p/{k}": v for k, v in p.items()},
             **_mlp_data())
    kw = {k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "max_position_embeddings", "seq_len")}
    (tmp / "worker.py").write_text(_WORKER.format(
        gloo_timeout=GLOO_TIMEOUT_S, cfg=repr(kw)))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(WORLD), init,
         str(tmp / "data.npz"), str(tmp / f"rank{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        pytest.fail(f"the gloo world did not finish in {JOIN_TIMEOUT_S} s")
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n{log}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    assert [int(r["rank"]) for r in ranks] == list(range(WORLD))
    return ranks


def test_gloo_device_mesh_stores_and_serves_a_rank(gloo_world, rg):
    p, cfg, _ = rg
    want, plain = _exported(p, cfg, "paged-mixed")
    toks = ServingEngine(p, cfg, slots=2, device="cpu",
                         **CONFIGS["paged-mixed"]).run(
        [Request(request_id="0", prompt=list(range(3, 14)),
                 max_new_tokens=3)])["0"].tokens
    engine_bytes = ServingEngine(p, cfg, slots=2, paged=True, kv_block=8,
                                 ragged=True, device="cpu").kv.cache_bytes
    for r, res in enumerate(gloo_world):
        np.testing.assert_array_equal(res["engine"], toks)
        assert int(res["cache_bytes"]) * WORLD == engine_bytes
        np.testing.assert_allclose(res["export_k"], want["k"], rtol=1e-6,
                                   atol=1e-6)
        for k, dim in (("rg_h0_attn_q_weight", 1), ("rg_h0_attn_q_bias", 0),
                       ("rg_h1_ffn_wo_weight", 0)):
            np.testing.assert_array_equal(
                res["stored/" + k], np.split(p[k], WORLD, axis=dim)[r])
        np.testing.assert_array_equal(res["stored/rg_h1_ffn_wo_bias"],
                                      p["rg_h1_ffn_wo_bias"])


def test_gloo_graph_split_matches_plain(gloo_world):
    d = _mlp_data()
    x = tht.placeholder_op("x")
    w1 = tht.Variable("mlp_fc1_weight", value=d["m/w1"])
    b1 = tht.Variable("mlp_fc1_bias", value=d["m/b1"])
    w2 = tht.Variable("mlp_fc2_weight", value=d["m/w2"])
    b2 = tht.Variable("mlp_fc2_bias", value=d["m/b2"])
    h = tht.linear_op(tht.gelu_op(tht.linear_op(x, w1, b1)), w2, b2)
    loss = tht.reduce_mean_op(tht.reduce_sum_op(h * h, axes=1), axes=0)
    train = tht.optim.SGDOptimizer(learning_rate=0.05).minimize(loss)
    ex = tht.Executor({"train": [loss, train]}, device="cpu")
    want = [float(ex.run("train", feed_dict={x: d["m/x"]})[0])
            for _ in range(3)]
    for res in gloo_world:
        np.testing.assert_allclose(res["mlp"], want, rtol=1e-6)
        assert res["mlp_gathers"].tolist() == [0, 0, 0]
