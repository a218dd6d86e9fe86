"""MoE serving in the PyTorch port against the JAX package on the CPU:
the MoE GPT of the JAX suite (``tests/test_moe_serving.py``: 4 layers,
hidden 32, 4 experts, top-2, capacity factor 2.0, every second block
routed), weights from ``init_moe_params`` on both sides.

- Each core (``_prefill_forward``, ``_decode_step`` over slot rows and
  over the pool, ``_mixed_step``, ``_verify_step``,
  ``_serve_prefill_chunk``) and ``teacher_forced_logits``: logits within
  1e-4 of JAX's counterpart and the per-expert load and drop equal, at
  a capacity that cannot bind and at one that does (every core call
  here flattens the same count of positions on both sides).
- In bf16 (params and caches), ``_prefill_forward``, ``_decode_step``
  and ``_mixed_step``: logits within 2 bf16 ulps of the largest
  |logit|, load and drop equal exactly.
- ``ServingEngine`` over contiguous and paged phase-split, paged int8,
  ``spec=2``, paged mixed, chunked paged mixed and contiguous mixed:
  greedy tokens equal JAX's offline ``generate_fast``, and lifetime
  ``expert_load`` / ``expert_drops`` / ``moe_tokens`` equal the JAX
  engine's in the same configuration; every step record holds
  load + drop == tokens x k x MoE layers.
- At a binding capacity: drops > 0 and the invariant on every step; on
  the mixed layout (whose waves flatten as many positions as JAX's)
  the counters and tokens equal the JAX engine's too.
- Inside the port: the draft's spec has ``draft=True``; offline
  ``generate_fast(spec=2)`` equals ``spec=0``; replicated experts with
  k = E reproduce the dense model; a dense engine has no expert
  accounting.

The card tests (``cuda``; they import no JAX, so ``python -m pytest
--noconftest tests/test_torch_moe_serving.py -m cuda`` runs them where
JAX is absent): ``moe_ffn`` on the card equals its CPU result at T 2048,
ties included, and an MoE engine launches the dense engine's attention
kernels, as often, in each layout.
"""

import types

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.models import moe_decode as tmd
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TServingEngine
from hetu_tpu_torch.weights import params_from_numpy

PROMPTS = [[5, 9, 2], [7, 1, 4, 3, 8], [11, 6]]
MAX_NEW = 8
L, H, Dh, V, S = 4, 2, 16, 97, 48
ATOL = 1e-4


def _kw(**over):
    kw = dict(vocab_size=V, hidden_size=H * Dh, num_hidden_layers=L,
              num_attention_heads=H, ffn_mult=2, seq_len=S,
              dropout_rate=0.0, max_position_embeddings=S, num_experts=4,
              top_k=2, capacity_factor=2.0, moe_every=2)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card tests need no JAX."""
    import jax
    import jax.numpy as jnp

    from hetu_tpu.models import gpt_decode as jgd
    from hetu_tpu.models import moe_decode as jmd
    from hetu_tpu.serving import Request, ServingEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, jgd=jgd, jmd=jmd,
                                 Request=Request, Engine=ServingEngine)


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.jmd.MoEDecodeConfig(**_kw())
    tcfg = tmd.MoEDecodeConfig(**_kw())
    p = tmd.init_moe_params(tcfg, name="moe", seed=0)
    jp = {k: jx.jgd._prep_param(v) for k, v in p.items()}
    return p, jp, params_from_numpy(p, device="cpu"), jcfg, tcfg


@pytest.fixture(scope="module")
def offline_ref(jx, model):
    """JAX offline greedy tokens per prompt (computed once)."""
    p, _, _, jcfg, _ = model
    return {str(i): np.asarray(jx.jgd.generate_fast(
        p, jcfg, [pr], MAX_NEW, name="moe"))[0].tolist()
        for i, pr in enumerate(PROMPTS)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(jx, cf):
    js = jx.jmd.MoESpec(4, 2, cf, 2)
    ts = tmd.MoESpec(4, 2, cf, 2)
    return ("moe", L, H, Dh, S, js), ("moe", L, H, Dh, S, ts)


def _pool(rng, bs=8, T=4, B=4):
    N = 1 + B * T
    tables = rng.permutation(np.arange(1, N)).reshape(B, T).astype(np.int32)
    return rng.randn(2, L, N, bs, H, Dh).astype(np.float32), tables


def _jit_core(jx, fn, jp, jcfg, args, kw=None, **static):
    """A JAX core, jitted, on ``args`` (and array keywords ``kw``):
    (logits, {"load", "drop"}) of its ``moe_stats``."""
    def run(args, kw):
        sd = {}
        out = fn(jp, jcfg, *args, moe_stats=sd, **kw, **static)
        return out[0], sd
    return jx.jax.jit(run)(args, kw or {})


def _core(jx, jp, tp, jcfg, tcfg, core, rng, bf16=False):
    """(JAX logits, JAX stats, port logits, port stats, live rows) of one
    core on one seeded input; ``bf16`` casts the caches to bf16 on both
    sides."""
    jnp = jx.jnp
    if bf16:
        def jc(a):
            return jnp.asarray(a, jnp.bfloat16)

        def tc(a):
            return _t(a).to(torch.bfloat16)
    else:
        jc, tc = jnp.asarray, _t
    jgd = jx.jgd
    ts = {}
    if core == "prefill":
        tokens = rng.randint(0, V, (3, 16)).astype(np.int32)
        lens = np.array([16, 9, 1], np.int32)
        jl, js = _jit_core(jx, jgd._prefill_forward, jp, jcfg,
                           (jnp.asarray(tokens), jnp.asarray(lens)))
        tl = tgd._prefill_forward(tp, tcfg, _t(tokens).long(), _t(lens),
                                  stats=ts)[0]
        return jl, js, tl, ts, slice(None)
    if core.startswith("decode"):
        token = rng.randint(0, V, 4).astype(np.int32)
        live = np.array([True, False, True, True])
        if core == "decode-paged":
            cache, tables = _pool(rng)
            pos = np.array([3, 0, 16, 31], np.int32)
            jl, js = _jit_core(
                jx, jgd._decode_step, jp, jcfg,
                (jc(cache[0]), jc(cache[1]),
                 jnp.asarray(pos), jnp.asarray(token)),
                dict(block_tables=jnp.asarray(tables),
                     live_mask=jnp.asarray(live)))
            tables = _t(tables)
        else:
            cache = rng.randn(2, L, 4, S, H, Dh).astype(np.float32)
            pos = np.array([9, 0, 40, S - 1], np.int32)
            jl, js = _jit_core(
                jx, jgd._decode_step, jp, jcfg,
                (jc(cache[0]), jc(cache[1]),
                 jnp.asarray(pos), jnp.asarray(token)),
                dict(token_valid=jnp.asarray(live)))
            tables = None
        tl = tgd._decode_step(tp, tcfg, tc(cache[0]), tc(cache[1]),
                              _t(pos), _t(token).long(),
                              block_tables=tables, live_mask=_t(live),
                              stats=ts)
        return jl, js, tl, ts, live
    if core == "chunk":
        cache, tables = _pool(rng)
        row, bs = tables[0], cache.shape[3]
        pos_off, n = 8, 8
        toks = rng.randint(0, V, n).astype(np.int32)
        wblk = np.array([row[(pos_off + j) // bs] for j in range(n)],
                        np.int32)
        woff = np.array([(pos_off + j) % bs for j in range(n)], np.int32)
        out = jx.jax.jit(lambda a: jgd._serve_prefill_chunk(
            jp, jcfg, *a))((
                jc(cache[0]), jc(cache[1]),
                jnp.asarray(row), jnp.asarray(toks), jnp.int32(pos_off),
                jnp.int32(n), jnp.float32(0.0), jnp.int32(0),
                jx.jax.random.PRNGKey(0), jnp.asarray(wblk),
                jnp.asarray(woff)))
        load, drop, ntok = out[-1]
        js = {"load": load, "drop": drop}
        # the chunk's logits: JAX's masked mixed step with fresh K/V
        jl, _ = _jit_core(
            jx, jgd._mixed_step, jp, jcfg,
            (jc(cache[0]), jc(cache[1]),
             jnp.asarray([pos_off], jnp.int32), jnp.asarray(toks[None]),
             jnp.asarray([n], jnp.int32), jnp.asarray([True])),
            dict(block_tables=jnp.asarray(row[None])), attn="masked",
            has_fresh=True)
        jl = jl[0, n - 1]
        tok, tl = tgd._serve_prefill_chunk(
            tp, tcfg, tc(cache[0]), tc(cache[1]), _t(row), _t(toks).long(),
            pos_off, sample=(0.0, 0, None), stats=ts)
        assert tok == int(out[0]) and int(ntok) == n
        return jl, js, tl, ts, slice(None)
    # a mixed wave over the pool, or a verify wave over slot rows
    pos = np.array([3, 10, 0, 0], np.int32)
    q_len = np.array([5, 1, 0, 1], np.int32)
    tokens = np.zeros((4, 8), np.int32)
    for b in range(4):
        tokens[b, :q_len[b]] = rng.randint(0, V, q_len[b])
    if core == "mixed-paged":
        cache, tables = _pool(rng)
        jl, js = _jit_core(
            jx, jgd._mixed_step, jp, jcfg,
            (jc(cache[0]), jc(cache[1]), jnp.asarray(pos),
             jnp.asarray(tokens), jnp.asarray(q_len),
             jnp.asarray([True, False, False, False])),
            dict(block_tables=jnp.asarray(tables)),
            # in bf16 the kernel's path, whose P stays f32 as the port's
            **(dict(attn="ragged") if bf16 else
               dict(attn="masked", has_fresh=True)))
        tl = tgd._mixed_step(tp, tcfg, tc(cache[0]), tc(cache[1]), _t(pos),
                             _t(tokens).long(), _t(q_len), _t(tables),
                             stats=ts)
    else:
        cache = rng.randn(2, L, 4, S, H, Dh).astype(np.float32)
        jl, js = _jit_core(
            jx, jgd._verify_step, jp, jcfg,
            (jc(cache[0]), jc(cache[1]), jnp.asarray(pos),
             jnp.asarray(tokens), jnp.asarray(q_len)))
        tl = tgd._verify_step(tp, tcfg, tc(cache[0]), tc(cache[1]),
                              _t(pos), _t(tokens).long(), _t(q_len),
                              stats=ts)
    return jl, js, tl, ts, np.arange(8)[None, :] < q_len[:, None]


CORES = ["prefill", "decode-slots", "decode-paged", "chunk", "mixed-paged",
         "verify-contiguous"]


@pytest.mark.parametrize("cf", [2.0, 0.125], ids=["free", "binding"])
@pytest.mark.parametrize("core", CORES)
def test_core_matches_jax(jx, model, core, cf):
    _, jp, tp, _, _ = model
    jcfg, tcfg = _cfgs(jx, cf)
    rng = np.random.RandomState(CORES.index(core))
    jl, js, tl, ts, rows = _core(jx, jp, tp, jcfg, tcfg, core, rng)
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ts["load"].numpy(), np.asarray(js["load"]))
    np.testing.assert_array_equal(ts["drop"].numpy(), np.asarray(js["drop"]))
    if cf < 1.0 and not core.startswith("decode"):
        assert int(ts["drop"].sum()) > 0


BF16_CORES = ["prefill", "decode-slots", "mixed-paged"]


@pytest.mark.parametrize("cf", [2.0, 0.125], ids=["free", "binding"])
@pytest.mark.parametrize("core", BF16_CORES)
def test_bf16_core_matches_jax(jx, model, core, cf):
    """bf16 params and caches: logits within 2 bf16 ulps of the largest
    |logit|, the bound the dense bf16 cores meet
    (``test_torch_gpt_decode.py``; measured here at most 0.95 of one
    such ulp), and the per-expert load and drop equal exactly."""
    jnp = jx.jnp
    p = model[0]
    jp = {k: jnp.asarray(np.asarray(v, np.float32), jnp.bfloat16)
          for k, v in p.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in model[2].items()}
    jcfg, tcfg = _cfgs(jx, cf)
    rng = np.random.RandomState(CORES.index(core))
    jl, js, tl, ts, rows = _core(jx, jp, tp, jcfg, tcfg, core, rng,
                                 bf16=True)
    assert tl.dtype == torch.float32
    want = np.asarray(jnp.asarray(jl, jnp.float32))[rows]
    tol = 2 * 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(tl.numpy()[rows], want, atol=tol, rtol=0)
    np.testing.assert_array_equal(ts["load"].numpy(), np.asarray(js["load"]))
    np.testing.assert_array_equal(ts["drop"].numpy(), np.asarray(js["drop"]))
    if cf < 1.0 and not core.startswith("decode"):
        assert int(ts["drop"].sum()) > 0


@pytest.mark.parametrize("fake_quant", [False, True])
def test_teacher_forced_logits_matches_jax(jx, model, fake_quant):
    p, _, _, jcfg, tcfg = model
    seq = np.random.RandomState(7).randint(0, V, 20)
    want = jx.jax.jit(lambda s: jx.jgd.teacher_forced_logits(
        p, jcfg, s, fake_quant, name="moe"))(seq)
    got = tgd.teacher_forced_logits(p, tcfg, seq, fake_quant, name="moe",
                                    device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _mk(Req, prompts=None):
    return [Req(request_id=str(i), prompt=pr, max_new_tokens=MAX_NEW,
                temperature=0.0, seed=0)
            for i, pr in enumerate(PROMPTS if prompts is None else prompts)]


def _tokens(res):
    return {k: [int(t) for t in r.tokens] for k, r in res.items()}


def _hold_invariant(eng, cfg):
    """load + drop == tokens x k x MoE layers over the lifetime and on
    every step record."""
    n = eng.moe.moe_layers(cfg.num_hidden_layers) * eng.moe.top_k
    total = int(eng.expert_load.sum() + eng.expert_drops.sum())
    assert eng.moe_tokens > 0 and total == eng.moe_tokens * n
    steps = [e for e in eng.metrics.events if "moe_tokens" in e]
    assert steps and sum(e["moe_tokens"] for e in steps) == eng.moe_tokens
    for e in steps:
        assert e["moe_routed"] + e["moe_dropped"] == e["moe_tokens"] * n


ENGINES = {
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=16, ragged=False),
    "paged-split-int8": dict(paged=16, ragged=False, kv_quant="int8"),
    "contiguous-split-spec2": dict(paged=False, ragged=False, spec=2),
    "paged-mixed": dict(paged=16, ragged=True),
    "paged-mixed-chunked": dict(paged=16, ragged=True, prefill_chunk=2),
    "contiguous-mixed": dict(paged=False, ragged=True),
}


@pytest.mark.parametrize("config", sorted(ENGINES))
def test_engine_matches_jax(jx, model, offline_ref, config):
    p, _, _, jcfg, tcfg = model
    kw = ENGINES[config]
    jeng = jx.Engine(p, jcfg, slots=4, name="moe", fast_path=False, **kw)
    jeng.run(_mk(jx.Request))
    teng = TServingEngine(p, tcfg, slots=4, name="moe", device="cpu", **kw)
    got = _tokens(teng.run(_mk(TRequest)))
    assert got == offline_ref
    assert teng.expert_load.tolist() == jeng.expert_load.tolist()
    assert teng.expert_drops.tolist() == jeng.expert_drops.tolist()
    assert teng.moe_tokens == jeng.moe_tokens
    assert teng.expert_drop_rate == 0.0
    assert teng.expert_imbalance == pytest.approx(jeng.expert_imbalance)
    _hold_invariant(teng, tcfg)


# prompts of 9-12 tokens: a group of three pads to four rows of 16 in
# the JAX engine, which sets a larger capacity than the 3 x 16 live rows
LONG_PROMPTS = [[5, 9, 2, 4, 6, 1, 3, 8, 7, 10],
                [7, 1, 4, 3, 8, 2, 2, 9, 11, 5, 6, 3],
                [11, 6, 1, 2, 3, 4, 5, 6, 7]]


@pytest.mark.parametrize("prompts", ["short", "long"])
@pytest.mark.parametrize("config",
                         ["paged-mixed", "paged-split", "contiguous-split"])
def test_binding_capacity(jx, model, monkeypatch, config, prompts):
    """capacity factor 0.25 ($HETU_MOE_CAPACITY) binds: tokens past
    capacity are dropped, the invariant holds on every step, and the
    counters and tokens equal the JAX engine's.  A phase-split prefill
    group or chunk carries no pad rows here; it passes the JAX engine's
    padded count (nb x P_b, or the chunk bucket) as the capacity count,
    so the phase-split engines are held to JAX's flash-prefill
    configuration (``fast_path=True``), whose padding that is."""
    monkeypatch.setenv("HETU_MOE_CAPACITY", "0.25")
    p, _, _, jcfg, tcfg = model
    pr = PROMPTS if prompts == "short" else LONG_PROMPTS
    kw = ENGINES[config]
    teng = TServingEngine(p, tcfg, slots=4, name="moe", device="cpu", **kw)
    assert teng.moe.capacity_factor == 0.25
    got = _tokens(teng.run(_mk(TRequest, pr)))
    assert int(teng.expert_drops.sum()) > 0 and teng.expert_drop_rate > 0
    _hold_invariant(teng, tcfg)
    jeng = jx.Engine(p, jcfg, slots=4, name="moe",
                     fast_path=config != "paged-mixed", **kw)
    want = _tokens(jeng.run(_mk(jx.Request, pr)))
    assert got == want
    assert teng.expert_load.tolist() == jeng.expert_load.tolist()
    assert teng.expert_drops.tolist() == jeng.expert_drops.tolist()
    assert teng.moe_tokens == jeng.moe_tokens


def test_draft_routes_nothing(model):
    p, _, _, _, tcfg = model
    eng = TServingEngine(p, tcfg, slots=4, name="moe", device="cpu", spec=2)
    assert eng.cfg_tuple[-1].draft is False
    assert eng.cfg_tuple_draft[-1].draft is True
    assert eng.cfg_tuple_draft[:5] == ("moe", eng.spec_draft_layers, H, Dh,
                                       eng.kv.s_max)
    assert tmd.moe_spec_of(tcfg, draft=True).draft is True
    # a draft's MoE block hands the residual stream through untouched
    h = torch.randn(3, H * Dh)
    assert tgd._ffn_block(model[2], "moe_h1", h, 1,
                          eng.cfg_tuple_draft[-1]) is h


def test_offline_spec_equals_spec0(model, offline_ref):
    p, _, _, _, tcfg = model
    for i, pr in enumerate(PROMPTS):
        a = tgd.generate_fast(p, tcfg, [pr], MAX_NEW, name="moe",
                              device="cpu")
        b = tgd.generate_fast(p, tcfg, [pr], MAX_NEW, name="moe", spec=2,
                              device="cpu")
        assert a[0].tolist() == b[0].tolist() == offline_ref[str(i)]


def _dense(seed=1, D=H * Dh, F=2 * H * Dh):
    rng = np.random.RandomState(seed)
    p = {"or_wte_table": rng.randn(V, D).astype(np.float32) * 0.05,
         "or_wpe": rng.randn(S, D).astype(np.float32) * 0.05,
         "or_ln_f_scale": np.ones(D, np.float32),
         "or_ln_f_bias": np.zeros(D, np.float32)}
    for i in range(2):
        us = f"or_h{i}"
        for w, shp in [("attn_q", (D, D)), ("attn_k", (D, D)),
                       ("attn_v", (D, D)), ("attn_proj", (D, D)),
                       ("ffn_wi", (D, F)), ("ffn_wo", (F, D))]:
            p[f"{us}_{w}_weight"] = rng.randn(*shp).astype(np.float32) * 0.05
            p[f"{us}_{w}_bias"] = rng.randn(shp[1]).astype(np.float32) * 0.01
        for ln in ("ln1", "ln2"):
            p[f"{us}_{ln}_scale"] = np.ones(D, np.float32)
            p[f"{us}_{ln}_bias"] = np.zeros(D, np.float32)
    return p


def test_dense_oracle():
    """Replicated experts with k = E at a capacity that cannot bind: the
    dense model's greedy tokens, and its teacher-forced logits within
    1e-4."""
    from hetu_tpu_torch.models import GPTConfig as TGPTConfig
    dense = TGPTConfig(vocab_size=V, hidden_size=H * Dh, num_hidden_layers=2,
                       num_attention_heads=H, ffn_mult=2,
                       max_position_embeddings=S, seq_len=S,
                       dropout_rate=0.0)
    moe = tmd.MoEDecodeConfig(**_kw(num_hidden_layers=2, top_k=4,
                                    capacity_factor=8.0, moe_every=1))
    p = _dense()
    mp = tmd.convert_dense_to_moe(p, dense, moe, name="or")
    for pr in PROMPTS:
        want = tgd.generate_fast(p, dense, [pr], MAX_NEW, device="cpu")
        got = tgd.generate_fast(mp, moe, [pr], MAX_NEW, device="cpu")
        assert got.tolist() == want.tolist()
    seq = np.random.RandomState(3).randint(0, V, 24)
    np.testing.assert_allclose(
        tgd.teacher_forced_logits(mp, moe, seq, device="cpu").numpy(),
        tgd.teacher_forced_logits(p, dense, seq, device="cpu").numpy(),
        atol=ATOL, rtol=0)


def test_dense_engine_has_no_expert_accounting():
    from hetu_tpu_torch.models import GPTConfig as TGPTConfig
    cfg = TGPTConfig(vocab_size=V, hidden_size=H * Dh, num_hidden_layers=2,
                     num_attention_heads=H, ffn_mult=2,
                     max_position_embeddings=S, seq_len=S, dropout_rate=0.0)
    eng = TServingEngine(_dense(), cfg, slots=2, device="cpu")
    assert eng.moe is None and len(eng.cfg_tuple) == 5
    assert eng.expert_imbalance is None and eng.expert_drop_rate is None
    eng.run([TRequest(prompt=[1, 2], max_new_tokens=3)])
    assert not [e for e in eng.metrics.events if "moe_tokens" in e]


# ------------------------------------------------------------------- #
# on the card
# ------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_moe_ffn_cuda_equals_cpu(cuda, ties):
    """T 2048 (a mixed wave of 8 x 256), E 4, top-2, capacity factor 2.0
    and 0.5 (binding), a valid mask: the card's y within 1e-5 of the
    CPU's, load and drop equal; zero gate weights make every gate 1/E."""
    rng = np.random.RandomState(11)
    E, D, F, T = 4, 64, 96, 2048
    p = {"m_h0_moe_gate_weight": (np.zeros((D, E), np.float32) if ties
                                  else rng.randn(D, E).astype(np.float32)),
         "m_h0_moe_expert_stack_w1":
             (rng.randn(E, D, F) * 0.05).astype(np.float32),
         "m_h0_moe_expert_stack_b1": (rng.randn(E, F) * 0.05).astype(
             np.float32),
         "m_h0_moe_expert_stack_w2":
             (rng.randn(E, F, D) * 0.05).astype(np.float32),
         "m_h0_moe_expert_stack_b2": (rng.randn(E, D) * 0.05).astype(
             np.float32)}
    x = rng.randn(T, D).astype(np.float32)
    valid = rng.rand(T) > 0.2
    for cf in (2.0, 0.5):
        spec = tmd.MoESpec(E, 2, cf, 1)
        out = {}
        for dev in ("cpu", cuda):
            st = {}
            y = tmd.moe_ffn({k: torch.from_numpy(v).to(dev)
                             for k, v in p.items()}, "m_h0",
                            torch.from_numpy(x).to(dev), spec,
                            valid=torch.from_numpy(valid).to(dev), stats=st)
            out[str(dev)] = (y.cpu().numpy(), st["load"].cpu().numpy(),
                             st["drop"].cpu().numpy())
        (yc, lc, dc), (yg, lg, dg) = out["cpu"], out[str(cuda)]
        np.testing.assert_allclose(yg, yc, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(lg, lc)
        np.testing.assert_array_equal(dg, dc)
        assert (yg[~valid] == 0).all()
        if cf < 1:
            assert dg.sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["paged-mixed", "paged-split",
                                    "contiguous-split", "contiguous-mixed"])
def test_moe_engine_launches_the_dense_kernels(cuda, config):
    """The MoE model and its dense twin (the same attention weights, a
    dense FFN on every block) through one layout: the same attention
    kernels, launched as often (the schedules are the same: routing
    changes no shape)."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    kw = dict(ENGINES[config])
    cfg = tmd.MoEDecodeConfig(**_kw(vocab_size=128, hidden_size=128,
                                    num_attention_heads=2,
                                    max_position_embeddings=128,
                                    seq_len=128))
    p = tmd.init_moe_params(cfg, name="moe", seed=0)
    dense = {k: v for k, v in p.items() if "_moe_" not in k}
    for i in range(L):
        if tmd.moe_spec_of(cfg).is_moe_layer(i):
            us = f"moe_h{i}"
            dense[f"{us}_ffn_wi_weight"] = p[f"{us}_moe_expert_stack_w1"][0]
            dense[f"{us}_ffn_wi_bias"] = p[f"{us}_moe_expert_stack_b1"][0]
            dense[f"{us}_ffn_wo_weight"] = p[f"{us}_moe_expert_stack_w2"][0]
            dense[f"{us}_ffn_wo_bias"] = p[f"{us}_moe_expert_stack_b2"][0]
    from hetu_tpu_torch.models import GPTConfig as TGPTConfig
    dcfg = TGPTConfig(vocab_size=128, hidden_size=128, num_hidden_layers=L,
                      num_attention_heads=2, ffn_mult=2,
                      max_position_embeddings=128, seq_len=128,
                      dropout_rate=0.0)
    prompts = np.random.RandomState(5).randint(0, 128, (6, 40))
    counts = []
    for params, c in ((p, cfg), (dense, dcfg)):
        eng = TServingEngine(params, c, slots=4, **kw)
        reqs = [TRequest(prompt=pr.tolist()[:10 + 5 * i], max_new_tokens=12,
                         request_id=str(i)) for i, pr in enumerate(prompts)]
        reset_launches()
        eng.run(reqs)
        torch.cuda.synchronize()
        counts.append((launch_counts(), eng.steps))
    assert counts[0] == counts[1]
    assert sum(counts[0][0].values()) > 0
