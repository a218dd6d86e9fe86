"""GPT on the port's graph surface (``hetu_tpu_torch.models.gpt``)
against the JAX package's graph GPT, on the CPU, at a tiny size (2
layers, hidden 32, 2 heads, vocab 61, S 16, B 4, dropout 0), f32, from
the JAX executor's initial values (``Executor.load_dict``):

- three AdamW steps (weight decay 0.01, clip 1.0) on labels with -1
  tails: the losses within 1e-5 relative and every variable within 1e-5
  (k's bias within 3 lr: its exact gradient is 0, and AdamW's eps turns
  each side's rounding-level gradient into a +-lr step), on the unfused
  chain, on the flash path (JAX's Pallas kernels in interpret mode, the
  port's K2/K3 plain versions) and on the flash path with ``kv_lens``;
- the logits of the call without labels within 1e-5, and
  ``greedy_generate``'s tokens identical to JAX's;
- the graph GPT's three-step trajectory equal to the ``nn.Module``
  trainer's (``GPTForCausalLMModule``) from the same weights at one seed
  (1e-5 relative);
- the variable names JAX's, the ``gpt_decode.py`` contract's;
- ``serve_gpt``: graph-trained weights served with and without
  ``--spec 3``, the tokens identical between the two and to
  ``greedy_generate`` on the same weights, and under spec 3 on the
  card's auto layout (paged, mixed, prefix sharing; ROADMAP C9).
"""

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu.models import gpt as jgpt
from hetu_tpu_torch import optimizer as topt
from hetu_tpu_torch import serve_gpt
from hetu_tpu_torch.executor import Executor as ModuleExecutor
from hetu_tpu_torch.models import gpt as tgpt
from hetu_tpu_torch.models.gpt_module import GPTForCausalLMModule
from hetu_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=16, batch_size=4,
           seq_len=16, dropout_rate=0.0)
LENS = np.array([16, 12, 5, 16], np.int32)
LR = 1e-4
PKG = {"jax": (jht, jgpt), "torch": (tht, tgpt)}


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



def batch(kv_lens=False):
    rng = np.random.RandomState(0)
    B, S, V = CFG["batch_size"], CFG["seq_len"], CFG["vocab_size"]
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = ((ids + 1) % V).astype(np.int32)
    labels[:, -1] = -1
    labels[1, -4:] = -1
    if kv_lens:
        labels[np.arange(S)[None, :] >= LENS[:, None]] = -1
    return ids, labels


def build(key, flash, kv_lens):
    """(placeholders, loss, train op, logits of the call without
    labels)."""
    m, models = PKG[key]
    model = models.GPTForCausalLM(models.GPTConfig(use_flash=flash, **CFG),
                                  name="gpt")
    ids, labels = m.placeholder_op("input_ids"), m.placeholder_op("labels")
    phs = [ids, labels]
    lens = None
    if kv_lens:
        lens = m.placeholder_op("kv_lens")
        phs.append(lens)
    loss, _ = model(ids, labels=labels, kv_lens=lens)
    opt = m.optim.AdamWOptimizer(learning_rate=LR, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    return phs, loss, opt.minimize(loss), model(ids)


CASES = {"unfused": (False, False), "flash": (True, False),
         "flash_kv_lens": (True, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_three_adamw_steps_match_jax(case):
    flash, kv_lens = CASES[case]
    arrays = batch(kv_lens) + ((LENS,) if kv_lens else ())
    res, w0 = {}, None
    for key in ("jax", "torch"):
        phs, loss, train, logits = build(key, flash, kv_lens)
        subs = {"train": [loss, train], "logits": [logits]}
        if key == "jax":
            ex = jht.Executor(subs)
            w0 = ex.return_tensor_values()
        else:
            ex = tht.Executor(subs, device="cpu")
            ex.load_dict(w0)
            assert set(ex.variables) == set(w0)
        feeds = dict(zip(phs, arrays))
        first = None
        if case == "unfused":
            first = np.asarray(ex.run("logits", feed_dict={
                phs[0]: arrays[0]})[0])
        losses = [float(np.asarray(ex.run("train", feed_dict=feeds)[0]))
                  for _ in range(3)]
        greedy = None
        if case == "unfused":
            greedy = PKG[key][1].greedy_generate(
                ex, "logits", phs[0], 0, [5, 6, 7], 9, CFG["seq_len"])
        res[key] = (first, losses, ex.return_tensor_values(), greedy)
    (tf, tl, tv, tg), (jf, jl, jv, jg) = res["torch"], res["jax"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for k in jv:
        tol = 3 * LR if k.endswith("_attn_k_bias") else 1e-5
        d = float(np.abs(tv[k] - jv[k]).max())
        assert d <= tol, (k, d, tol)
    assert tg == jg
    if case == "unfused":
        assert tf.shape == (CFG["batch_size"] * CFG["seq_len"],
                            CFG["vocab_size"])
        np.testing.assert_allclose(tf, jf, atol=1e-5)
        assert len(tg) == 12 and tg[:3] == [5, 6, 7]


def test_names_are_the_serving_contract():
    _, loss, _, _ = build("torch", False, False)
    ex = tht.Executor([loss], device="cpu")
    names = set(ex.variables)
    assert {"gpt_wte_table", "gpt_wpe", "gpt_ln_f_scale", "gpt_ln_f_bias",
            "gpt_head_bias", "gpt_h0_ln1_scale", "gpt_h1_attn_q_weight",
            "gpt_h1_attn_proj_bias", "gpt_h0_ffn_wi_weight",
            "gpt_h1_ffn_wo_bias"} <= names


def test_trajectory_equals_the_module_trainer():
    ids, labels = batch()
    phs, loss, train, _ = build("torch", False, False)
    ex = tht.Executor({"train": [loss, train]}, device="cpu", seed=3)
    w0 = ex.return_tensor_values()
    graph = [float(ex.run("train", feed_dict={phs[0]: ids,
                                               phs[1]: labels})[0])
             for _ in range(3)]
    model = GPTForCausalLMModule(tgpt.GPTConfig(use_flash=False, **CFG),
                                 seed=3).load_var_values(w0)
    opt = topt.AdamWOptimizer(learning_rate=LR, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    mex = ModuleExecutor(model, opt, device="cpu")
    module = [float(mex.run({"input_ids": ids, "labels": labels})[0])
              for _ in range(3)]
    np.testing.assert_allclose(graph, module, rtol=1e-5)
    final = ex.return_tensor_values()
    for k, v in model.var_values().items():
        np.testing.assert_allclose(final[k], v, atol=1e-5, err_msg=k)


def test_serve_gpt_spec_equals_plain_and_greedy():
    argv = ["--device", "cpu", "--train-steps", "20", "--requests", "4",
            "--slots", "2"]
    frac, plain, ex, cfg = serve_gpt.run(argv)
    frac3, spec, _, _ = serve_gpt.run(argv + ["--spec", "3"])
    assert 0.0 <= frac <= 1.0 and frac3 == frac
    assert spec == plain
    model = tgpt.GPTForCausalLM(cfg, name="sg")
    ids = tht.placeholder_op("sg_ids")
    gex = tht.Executor({"logits": [model(ids)]}, device="cpu")
    gex.load_dict(ex.return_tensor_values())
    for toks in plain:
        want = tgpt.greedy_generate(gex, "logits", ids, 0, toks[:1],
                                    len(toks) - 1, cfg.seq_len)
        assert toks == want
    assert serve_gpt.main(["--device", "cpu", "--train-steps", "0",
                           "--requests", "1"]) in (0.0, 1.0)
    # the card's auto layout (a paged pool of 16, mixed waves, prefix
    # sharing) under spec 3: a verify rollback into a block shared only
    # with a registered prefix evicts the prefix and rewrites the block
    # in place (the JAX engine raises "pool exhausted un-COWing
    # rollback" there); the tokens equal those without prefix sharing
    for share in (None, False):
        eng = ServingEngine(ex.var_values, cfg, slots=2, queue_limit=4,
                            spec=3, paged=16, ragged=True,
                            prefix_share=share, device="cpu")
        reqs = serve_gpt.requests(4, cfg.vocab_size, cfg.seq_len)
        res = eng.run(reqs)
        assert [[int(t) for t in res[r.request_id].tokens]
                for r in reqs] == plain

