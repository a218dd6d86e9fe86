"""Speculative decoding in the PyTorch port against the JAX package's, on
the CPU, same numpy weights and inputs on both sides (2 layers, 2 heads,
head dim 16):

- the verify kernels' plain versions (K6 ``paged_verify_attention``, K7
  ``paged_block_verify_attention``) against the JAX kernels run in
  interpret mode, with a q_len-0 slot, a length-0 slot and a permuted
  pool: f32 within 1e-5, bf16 within 2e-2 (the JAX side keeps bf16
  operands);
- ``_verify_step`` against JAX's on the live rows, over the contiguous
  cache and the pool: logits within 1e-4, the live cache region within
  1e-5; and against the port's own sequential ``_decode_step`` calls
  within 1e-5 (not bitwise: the kernels sum in other orders);
- ``_spec_propose``'s draft tokens equal JAX's from the same cache;
- the engine with ``spec=3, spec_draft_layers=1`` against the JAX
  engine in every configuration the port has: identical greedy tokens,
  and equal ``spec_waves``/``spec_proposed``/``spec_accepted``/
  ``spec_draft_prefills`` with adaptive k off and on.

Inside the port (ports of the JAX package's own speculation tests): spec
vs non-spec sampled identity in every configuration, an EOS inside the
accepted span, offline ``generate_fast(spec=)`` identity, EOS,
``num_tokens=1`` and its per-row streams, the high-acceptance fixture
(late layers output-zeroed) and its per-request attribution, adaptive k
ramping up and backing off, the ``$HETU_SPEC_*`` knobs, and rollback
equal to replay on both KV managers.
"""

import json

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu.models import GPTConfig
from hetu_tpu.models import gpt_decode as jgd
from hetu_tpu.serving import Request, ServingEngine
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.models import GPTConfig as TGPTConfig
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TServingEngine
from hetu_tpu_torch.serving.kv_manager import (
    KVCacheManager as TKVCacheManager, PagedKVManager as TPagedKVManager)
from hetu_tpu_torch.weights import params_from_numpy

NAME, L, H, Dh, V, S = "sp", 2, 2, 16, 61, 64
CFG = (NAME, L, H, Dh, S)
ATOL = 1e-4


def rand_gpt(seed=0):
    """Random GPT weights as float64 numpy with both packages' configs."""
    rng = np.random.RandomState(seed)
    hd = H * Dh
    p = {f"{NAME}_wte_table": rng.randn(V, hd) * 0.05,
         f"{NAME}_wpe": rng.randn(S, hd) * 0.05,
         f"{NAME}_ln_f_scale": np.ones(hd),
         f"{NAME}_ln_f_bias": np.zeros(hd)}
    for i in range(L):
        us = f"{NAME}_h{i}"
        for w, shp in [("attn_q", (hd, hd)), ("attn_k", (hd, hd)),
                       ("attn_v", (hd, hd)), ("attn_proj", (hd, hd)),
                       ("ffn_wi", (hd, 4 * hd)), ("ffn_wo", (4 * hd, hd))]:
            p[f"{us}_{w}_weight"] = rng.randn(*shp) * 0.05
            p[f"{us}_{w}_bias"] = np.zeros(shp[1])
        for ln in ("ln1", "ln2"):
            p[f"{us}_{ln}_scale"] = np.ones(hd)
            p[f"{us}_{ln}_bias"] = np.zeros(hd)
    kw = dict(vocab_size=V, hidden_size=hd, num_hidden_layers=L,
              num_attention_heads=H, max_position_embeddings=S,
              batch_size=1, seq_len=S, dropout_rate=0.0)
    return p, GPTConfig(**kw), TGPTConfig(**kw)


def zero_late_layers(p, first=1):
    """Output-zero the blocks from ``first`` on (the JAX package's
    high-acceptance fixture): the truncated draft's logits then equal
    the target's, so every draft is accepted."""
    hp = dict(p)
    for i in range(first, L):
        for wn in ("attn_proj_weight", "attn_proj_bias", "ffn_wo_weight",
                   "ffn_wo_bias"):
            hp[f"{NAME}_h{i}_{wn}"] = np.zeros_like(p[f"{NAME}_h{i}_{wn}"])
    return hp


@pytest.fixture(scope="module")
def model():
    p, jcfg, tcfg = rand_gpt()
    jp = {k: jgd._prep_param(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    return p, jp, tp, jcfg, tcfg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- #
# K6 / K7 plain versions against the JAX kernels (interpret mode)
# ------------------------------------------------------------------- #


def _verify_data(B=5, Q=4, S_=64, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Q, H, Dh).astype(np.float32)
    k = rng.randn(B, S_, H, Dh).astype(np.float32)
    v = rng.randn(B, S_, H, Dh).astype(np.float32)
    # a full block, a shorter one, one row, a q_len-0 slot WITH a length,
    # a length-0 slot
    lens = np.array([17, 33, 5, 9, 0], np.int32)
    qlens = np.array([Q, Q - 1, 1, 0, 0], np.int32)
    return q, k, v, lens, qlens


def _pool_data(B=4, Q=3, bs=8, T=6, seed=1):
    rng = np.random.RandomState(seed)
    N = B * T + 1
    pk = rng.randn(N, bs, H, Dh).astype(np.float32)
    pv = rng.randn(N, bs, H, Dh).astype(np.float32)
    q = rng.randn(B, Q, H, Dh).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[:B * T].reshape(B, T)
    tables = tables.astype(np.int32)
    lens = np.array([bs * 2 + 3, bs * T, 2, 0], np.int32)
    qlens = np.array([Q, Q - 1, 0, 0], np.int32)
    return q, pk, pv, lens, qlens, tables


TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_reference_matches_jax_kernel(dtype):
    q, k, v, lens, qlens = _verify_data()
    jd = getattr(jnp, dtype)
    want = jda.paged_verify_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(lens), jnp.asarray(qlens), block_k=16)
    td = getattr(torch, dtype)
    got = tda.paged_verify_attention(_t(q).to(td), _t(k).to(td),
                                     _t(v).to(td), _t(lens), _t(qlens))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOLS[dtype], rtol=0)
    assert (got[4] == 0).all()          # length 0
    ref = tda.masked_verify_reference(_t(q), _t(k), _t(v), _t(lens),
                                      _t(qlens))
    jref = jda.masked_verify_reference(q, k, v, lens, qlens)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_verify_reference_matches_jax_kernel(dtype):
    q, pk, pv, lens, qlens, tab = _pool_data()
    jd = getattr(jnp, dtype)
    want = jda.paged_block_verify_attention(
        jnp.asarray(q, jd), jnp.asarray(pk, jd), jnp.asarray(pv, jd),
        jnp.asarray(lens), jnp.asarray(qlens), jnp.asarray(tab))
    td = getattr(torch, dtype)
    got = tda.paged_block_verify_attention(
        _t(q).to(td), _t(pk).to(td), _t(pv).to(td), _t(lens), _t(qlens),
        _t(tab))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOLS[dtype], rtol=0)
    assert (got[3] == 0).all()
    ref = tda.paged_block_verify_reference(_t(q), _t(pk), _t(pv), _t(lens),
                                           _t(qlens), _t(tab))
    jref = jda.paged_block_verify_reference(q, pk, pv, lens, qlens, tab)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)


def test_verify_q1_equals_decode():
    """A one-row verify block scores what the decode wrapper scores."""
    q, k, v, lens, _ = _verify_data()
    ones = np.ones_like(lens)
    got = tda.paged_verify_attention(_t(q[:, :1]), _t(k), _t(v), _t(lens),
                                     _t(ones))
    want = tda.paged_decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("Q", [17, 33])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_groups_equal_the_whole_block(Q, paged):
    """The 16-row groups the CUDA verify wrappers launch, each through the
    plain version, give the unsplit plain version's rows wherever a row
    is live (a full block, a block ending inside a group, one ending on
    a group edge, one row, an inert slot, a length-0 slot); fully dead
    groups give zeros and read nothing."""
    rng = np.random.RandomState(Q)
    B, bs, T = 6, 8, 10
    lens = np.array([Q + 9, Q + 2, 16 + 4, 5, 7, 0], np.int32)
    qlens = np.array([Q, Q - 1, 16, 1, 0, 0], np.int32)
    q = _t(rng.randn(B, Q, H, Dh).astype(np.float32))
    if paged:
        N = B * T + 1
        pk, pv = (_t(rng.randn(N, bs, H, Dh).astype(np.float32))
                  for _ in range(2))
        tab = _t(rng.permutation(np.arange(1, N))[:B * T].reshape(B, T)
                 .astype(np.int32))

        def plain(q, lens, qlens):
            return tda.paged_block_verify_reference(q, pk, pv, lens, qlens,
                                                    tab)
    else:
        k, v = (_t(rng.randn(B, T * bs, H, Dh).astype(np.float32))
                for _ in range(2))

        def plain(q, lens, qlens):
            return tda.masked_verify_reference(q, k, v, lens, qlens)
    groups = tda.verify_groups(q, _t(lens), _t(qlens))
    assert len(groups) == -(-Q // 16)
    assert all(g[0].shape[1] <= 16 and g[0].is_contiguous()
               for g in groups)
    got = torch.cat([plain(*g) for g in groups], dim=1)
    want = plain(q, _t(lens), _t(qlens))
    for b in range(B):
        n = int(qlens[b])
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n].numpy(),
                                   atol=1e-6, rtol=0)
    for c, (_, gl, gn) in enumerate(groups):
        assert ((gn == 0) == (gl == 0)).all()
        assert (gl <= _t(lens)).all()
        dead = (gn == 0).nonzero().flatten()
        assert (got[dead, 16 * c:16 * (c + 1)] == 0).all()


# ------------------------------------------------------------------- #
# the cores
# ------------------------------------------------------------------- #


def _verify_case(paged, seed=3, B=3, Q=4, bs=8, T=8):
    """Slots at positions {6, 11, 0} of a random cache (stale data
    everywhere), verify blocks of q_len {4, 2, 0}: a full block, a short
    one, and an inert slot.  Paged: a permuted pool [2, L, 1+B*T, bs, H,
    Dh] with the block tables; else slot rows [2, L, B, S, H, Dh]."""
    rng = np.random.RandomState(seed)
    pos = np.array([6, 11, 0], np.int32)
    q_len = np.array([4, 2, 0], np.int32)
    tokens = rng.randint(0, V, (B, Q)).astype(np.int32)
    if paged:
        N = 1 + B * T
        tables = rng.permutation(np.arange(1, N)).reshape(B, T)
        tables = tables.astype(np.int32)
        cache = rng.randn(2, L, N, bs, H, Dh).astype(np.float32)
    else:
        tables = None
        cache = rng.randn(2, L, B, S, H, Dh).astype(np.float32)
    return cache, tables, pos, q_len, tokens


def _live_rows(cache_k, tables, b, n):
    """Slot b's first n positions of every layer: [L, n, H, Dh]."""
    c = np.asarray(cache_k)
    if tables is None:
        return c[:, b, :n]
    bs = c.shape[2]
    p = np.arange(n)
    return c[:, tables[b, p // bs], p % bs]


@pytest.mark.parametrize("attn", ["ragged", "masked"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_verify_step_matches_jax(model, paged, attn):
    """The port's one path against each JAX attention path: the verify
    kernels (interpret mode) and the masked einsum."""
    _, jp, tp, _, _ = model
    cache, tables, pos, q_len, tokens = _verify_case(paged)
    bt = None if tables is None else jnp.asarray(tables)
    jl, jk, jv = jgd._verify_step(
        jp, CFG, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
        jnp.asarray(pos), jnp.asarray(tokens), jnp.asarray(q_len),
        attn=attn, block_tables=bt)
    ck, cv = _t(cache[0].copy()), _t(cache[1].copy())
    tl = tgd._verify_step(tp, CFG, ck, cv, _t(pos), _t(tokens).long(),
                          _t(q_len), None if tables is None else _t(tables))
    live = np.arange(tokens.shape[1])[None, :] < q_len[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=0)
    for b in range(len(pos)):
        n = int(pos[b] + q_len[b])
        for got, want in ((ck, jk), (cv, jv)):
            np.testing.assert_allclose(_live_rows(got, tables, b, n),
                                       _live_rows(want, tables, b, n),
                                       atol=1e-5, rtol=0)
    # the inert slot wrote nothing
    if tables is None:
        assert torch.equal(ck[:, 2], _t(cache[0][:, 2]))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_bf16_verify_step_matches_jax(model, paged):
    """``_verify_step`` logits with bf16 params and caches against the JAX
    core's (the verify kernels in interpret mode): two bf16 ulps of the
    largest |logit| (measured at most 1.14 ulps, 7.8e-3 on logits up to
    0.88, on the contiguous cache)."""
    from test_torch_gpt_decode import bf16_close, bf16_params
    jp, tp = bf16_params(model[0])
    cache, tables, pos, q_len, tokens = _verify_case(paged)
    bt = None if tables is None else jnp.asarray(tables)
    jk, jv = (jnp.asarray(c, jnp.bfloat16) for c in cache[:2])
    jl, _, _ = jgd._verify_step(jp, CFG, jk, jv, jnp.asarray(pos),
                                jnp.asarray(tokens), jnp.asarray(q_len),
                                attn="ragged", block_tables=bt)
    tk, tv = (_t(c).to(torch.bfloat16) for c in cache[:2])
    tl = tgd._verify_step(tp, CFG, tk, tv, _t(pos), _t(tokens).long(),
                          _t(q_len), None if tables is None else _t(tables))
    assert tl.dtype == torch.float32
    bf16_close(tl, jl, np.arange(tokens.shape[1])[None, :] < q_len[:, None])


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_verify_step_matches_sequential_decode(model, paged):
    """One verify step == q_len sequential ``_decode_step`` calls on the
    live rows, logits and cache, within 1e-5."""
    _, _, tp, _, _ = model
    cache, tables, pos, q_len, tokens = _verify_case(paged, seed=4)
    bt = None if tables is None else _t(tables)
    ck, cv = _t(cache[0].copy()), _t(cache[1].copy())
    lv = tgd._verify_step(tp, CFG, ck, cv, _t(pos), _t(tokens).long(),
                          _t(q_len), bt).numpy()
    ck2, cv2 = _t(cache[0].copy()), _t(cache[1].copy())
    for j in range(tokens.shape[1]):
        live = j < q_len
        ls = tgd._decode_step(tp, CFG, ck2, cv2, _t(pos + j),
                              _t(tokens[:, j]).long(), block_tables=bt,
                              live_mask=_t(live)).numpy()
        np.testing.assert_allclose(lv[live, j], ls[live], atol=1e-5, rtol=0)
    for b in range(len(pos)):
        n = int(pos[b] + q_len[b])
        np.testing.assert_allclose(_live_rows(ck, tables, b, n),
                                   _live_rows(ck2, tables, b, n),
                                   atol=1e-5, rtol=0)


def test_spec_propose_matches_jax(model):
    """The draft's proposals from one cache state, and the draft K/V it
    writes at the proposal positions."""
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(5)
    B, k = 3, 3
    cfg_d = (NAME, 1, H, Dh, S)
    cache = rng.randn(2, 1, B, S, H, Dh).astype(np.float32)
    pos = np.array([4, 9, 20], np.int32)
    tok = rng.randint(0, V, B).astype(np.int32)
    jdraft, jk, _ = jgd._spec_propose(
        jp, cfg_d, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
        jnp.asarray(pos), jnp.asarray(tok), k=k)
    ck, cv = _t(cache[0].copy()), _t(cache[1].copy())
    draft = tgd._spec_propose(tp, cfg_d, ck, cv, _t(pos),
                              _t(tok).long(), k, np.ones(B, bool))
    assert draft.tolist() == np.asarray(jdraft).tolist()
    for b in range(B):
        n = int(pos[b]) + k + 1
        np.testing.assert_allclose(ck[:, b, :n].numpy(),
                                   np.asarray(jk)[:, b, :n], atol=1e-5,
                                   rtol=0)


def test_spec_propose_writes_only_live_rows(model):
    """Rows outside ``live`` (free or mid-prefill slots) keep their draft
    cache; a step past the cache's last position writes nothing."""
    _, _, tp, _, _ = model
    rng = np.random.RandomState(6)
    cfg_d = (NAME, 1, H, Dh, S)
    cache = rng.randn(2, 1, 3, S, H, Dh).astype(np.float32)
    ck, cv = _t(cache[0].copy()), _t(cache[1].copy())
    pos = np.array([S - 2, 3, 7], np.int32)
    tgd._spec_propose(tp, cfg_d, ck, cv, _t(pos), _t(np.array([1, 2, 3])),
                      4, np.array([True, False, True]))
    assert torch.equal(ck[:, 1], _t(cache[0][:, 1]))
    assert torch.equal(ck[:, 0, :S - 2], _t(cache[0][:, 0, :S - 2]))
    assert not torch.equal(ck[:, 0, S - 2:], _t(cache[0][:, 0, S - 2:]))
    assert not torch.equal(ck[:, 2, 7:12], _t(cache[0][:, 2, 7:12]))


def test_spec_sample_states_replay_the_stream():
    """Restoring the state after row j's draw continues the stream as if
    only rows 0..j had been drawn."""
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(1, 4, V).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    toks, after = tgd._spec_sample(logits, [0.9], [5], [gen], [0], [4])
    ref = torch.Generator().manual_seed(7)
    seq = [tgd._sample_slot(logits[0, j], 0.9, 5, ref) for j in range(2)]
    assert toks[0, :2].tolist() == seq
    gen.set_state(after[0][1])
    assert torch.equal(gen.get_state(), ref.get_state())
    greedy, none = tgd._spec_sample(logits, [0.0], [0], [None], [0], [4])
    assert none == [None]
    assert greedy[0].tolist() == torch.argmax(logits[0], -1).tolist()


# ------------------------------------------------------------------- #
# the engine against the JAX engine
# ------------------------------------------------------------------- #

PREFIX = list(range(20, 32))
# greedy requests (sampled streams differ between the packages, and with
# them acceptance): queueing on 2 slots, prompts past the chunk, a
# shared prefix, a one-token request
GREEDY = [([7, 8, 9], 6), ([3, 4], 8), (PREFIX + [1, 2, 3], 7),
          ([1, 2, 3, 4, 5], 4), ([11], 7), (PREFIX + [5, 6], 5),
          ([13, 14], 1)]
CONFIGS = {
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=True, kv_block=8, ragged=False,
                        prefill_chunk=4, prefix_share=True),
    "paged-mixed": dict(paged=True, kv_block=8, ragged=True,
                        prefill_chunk=4, prefix_share=True),
    "contiguous-mixed": dict(paged=False, ragged=True),
}
SPEC = dict(spec=3, spec_draft_layers=1)


def _run(Eng, Req, p, cfg, trace, slots=2, **kw):
    eng = Eng(p, cfg, slots=slots, queue_limit=64, **kw)
    res = eng.run([Req(prompt=t[0], max_new_tokens=t[1],
                       temperature=t[2] if len(t) > 2 else 0.0,
                       top_k=t[3] if len(t) > 3 else 0,
                       seed=t[4] if len(t) > 4 else i, request_id=f"r{i}")
                   for i, t in enumerate(trace)])
    return {k: v.tokens.tolist() for k, v in res.items()}, eng


def _spec_counters(eng):
    return dict(waves=eng.spec_waves, proposed=eng.spec_proposed,
                accepted=eng.spec_accepted,
                draft_prefills=eng.spec_draft_prefills,
                mean_k=eng.spec_mean_k)


@pytest.mark.parametrize("adapt", [False, True], ids=["pinned", "adapt"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_spec_matches_jax(model, config, adapt):
    p, _, _, jcfg, tcfg = model
    kw = dict(CONFIGS[config], spec_adapt=adapt, **SPEC)
    want, jeng = _run(ServingEngine, Request, p, jcfg, GREEDY,
                      fast_path=False, **kw)
    got, teng = _run(TServingEngine, TRequest, p, tcfg, GREEDY,
                     device="cpu", **kw)
    assert (teng.paged, teng.ragged) == (jeng.paged, jeng.ragged)
    assert got == want
    assert _spec_counters(teng) == _spec_counters(jeng)
    assert teng.spec_waves > 0 and teng.spec_accepted > 0
    assert teng.spec_draft_prefills == len(GREEDY)


# ------------------------------------------------------------------- #
# the port's own contracts
# ------------------------------------------------------------------- #

SAMPLED = [([3, 4], 6, 0.9, 5, 11), ([7, 8, 9], 6, 0.7, 3, 22),
           ([11], 6, 1.1, 0, 33), ([5, 6], 6, 0.8, 4, 44),
           (PREFIX + [1], 7, 0.0, 0, 55)]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_sampled_identity(model, config):
    """Accepted tokens are the target's own sequential samples and every
    request's generator is drawn once per emitted token, so sampled
    outputs equal the non-speculative engine's token for token."""
    p, _, _, _, tcfg = model
    plain, _ = _run(TServingEngine, TRequest, p, tcfg, SAMPLED,
                    device="cpu", **CONFIGS[config])
    spec, eng = _run(TServingEngine, TRequest, p, tcfg, SAMPLED,
                     device="cpu", spec_adapt=False, **SPEC,
                     **CONFIGS[config])
    assert plain == spec
    assert eng.spec_waves > 0


@pytest.mark.parametrize("config", ["contiguous-split", "paged-mixed"])
def test_eos_mid_wave(model, config):
    """An EOS inside the accepted span cuts the emission there and rolls
    the cache back to the cut."""
    p, _, _, _, tcfg = model
    hp = zero_late_layers(p)        # every draft accepted: long spans
    plain0 = tgd.generate_fast(hp, tcfg, [[7, 8, 9]], 8, device="cpu")[0]
    eos = int(plain0[6])

    def one(**kw):
        eng = TServingEngine(hp, tcfg, slots=2, device="cpu",
                             **CONFIGS[config], **kw)
        return next(iter(eng.run([TRequest(prompt=[7, 8, 9],
                                           max_new_tokens=8,
                                           eos_id=eos)]).values()))

    pl, sp = one(), one(spec_adapt=False, **SPEC)
    assert sp.tokens.tolist() == pl.tokens.tolist()
    assert sp.finish_reason == pl.finish_reason == "eos"


def test_generate_fast_spec_identity(model):
    p, _, _, jcfg, tcfg = model
    prompts = [[7, 8, 9], [3, 4, 5]]
    want = tgd.generate_fast(p, tcfg, prompts, 8, device="cpu")
    got = tgd.generate_fast(p, tcfg, prompts, 8, spec=3,
                            spec_draft_layers=1, device="cpu")
    assert got.tolist() == want.tolist()
    jgot = jgd.generate_fast(p, jcfg, prompts, num_tokens=8, spec=3,
                             spec_draft_layers=1)
    assert got.tolist() == np.asarray(jgot).tolist()


def test_generate_fast_spec_eos(model):
    p, _, _, _, tcfg = model
    plain0 = tgd.generate_fast(p, tcfg, [[7, 8, 9]], 8, device="cpu")[0]
    eos = int(plain0[5])
    want = tgd.generate_fast(p, tcfg, [[7, 8, 9], [3, 4, 5]], 8,
                             eos_id=eos, pad_id=0, device="cpu")
    got = tgd.generate_fast(p, tcfg, [[7, 8, 9], [3, 4, 5]], 8, eos_id=eos,
                            pad_id=0, spec=3, spec_draft_layers=1,
                            device="cpu")
    assert got.tolist() == want.tolist()


def test_generate_fast_spec_num_tokens_1(model):
    p, _, _, _, tcfg = model
    want = tgd.generate_fast(p, tcfg, [[7, 8, 9]], 1, device="cpu")
    got = tgd.generate_fast(p, tcfg, [[7, 8, 9]], 1, spec=3,
                            spec_draft_layers=1, device="cpu")
    assert got.tolist() == want.tolist()


def test_generate_fast_spec_sampled_rows_equal_engine(model):
    """Offline speculative sampling draws one generator per row seeded
    ``seed + row``: each row equals an engine request seeded alike."""
    p, _, _, _, tcfg = model
    prompts = [[7, 8, 9], [3, 4, 5]]
    out = tgd.generate_fast(p, tcfg, prompts, 6, temperature=0.8, top_k=5,
                            seed=10, spec=3, spec_draft_layers=1,
                            device="cpu")
    eng, _ = _run(TServingEngine, TRequest, p, tcfg,
                  [(pr, 6, 0.8, 5, 10 + r) for r, pr in enumerate(prompts)],
                  device="cpu", **CONFIGS["contiguous-split"])
    assert [eng["r0"], eng["r1"]] == out.tolist()


@pytest.mark.parametrize("config", ["paged-split", "paged-mixed"])
def test_high_acceptance_waves_and_attribution(model, config, tmp_path):
    """With the post-draft layers output-zeroed every draft is accepted:
    fewer waves than tokens, and each request's accepted + bonus + 1
    equals its generated count, on the Result and the retire event."""
    p, _, _, _, tcfg = model
    hp = zero_late_layers(p)
    trace = [(pr, n) for pr, n in GREEDY]
    plain, _ = _run(TServingEngine, TRequest, hp, tcfg, trace,
                    device="cpu", **CONFIGS[config])
    log = str(tmp_path / "spec.jsonl")
    eng = TServingEngine(hp, tcfg, slots=2, queue_limit=64, device="cpu",
                         spec_adapt=False, log_path=log, **SPEC,
                         **CONFIGS[config])
    res = eng.run([TRequest(prompt=pr, max_new_tokens=n,
                            request_id=f"r{i}")
                   for i, (pr, n) in enumerate(trace)])
    assert {k: v.tokens.tolist() for k, v in res.items()} == plain
    total = sum(r.n_generated for r in res.values())
    assert eng.spec_accepted == eng.spec_proposed > 0
    assert eng.spec_acceptance == 1.0 and eng.spec_mean_k == 3.0
    assert eng.spec_waves < total
    assert eng.metrics.snapshot()["tokens_per_step_mean"] > 1.0
    for r in res.values():
        assert r.spec_proposed >= r.spec_accepted >= 0
        assert r.spec_accepted <= r.n_generated - 1
    with open(log) as f:
        recs = [json.loads(ln) for ln in f]
    steps = [r for r in recs if r["event"] == "serve_step"]
    assert sum(r.get("spec_accepted", 0) for r in steps) \
        == eng.spec_accepted
    retires = [r for r in recs if r["event"] == "req_retire"]
    assert len(retires) == len(trace)
    for r in retires:
        assert r["spec_accepted"] + r["spec_bonus"] + 1 == r["n_generated"]


def test_adaptive_k_ramps_and_backs_off(model):
    p, _, _, _, tcfg = model
    eng = TServingEngine(zero_late_layers(p), tcfg, slots=2,
                         queue_limit=64, spec=4, spec_adapt=True,
                         spec_draft_layers=1, device="cpu")
    assert eng._spec_kcur == 2    # ramp-up start: spec_k // 2
    eng.run([TRequest(prompt=[i % 50 + 1], max_new_tokens=18, seed=i)
             for i in range(6)])
    assert eng._spec_kcur == 4
    # near-zero acceptance: hot sampling against a greedy draft
    eng2 = TServingEngine(p, tcfg, slots=2, queue_limit=64, spec=4,
                          spec_adapt=True, spec_draft_layers=1,
                          device="cpu")
    eng2.run([TRequest(prompt=[i % 50 + 1], max_new_tokens=12,
                       temperature=2.0, seed=i) for i in range(6)])
    assert eng2._spec_kcur == 1
    assert eng2.spec_mean_k < 4


def test_spec_env_knobs(model, monkeypatch):
    """$HETU_SPEC_K / $HETU_SPEC_DRAFT_LAYERS / $HETU_SPEC_ADAPT drive the
    engine, offline generation and the resolvers; explicit arguments
    win."""
    p, _, _, _, tcfg = model
    monkeypatch.setenv("HETU_SPEC_K", "3")
    monkeypatch.setenv("HETU_SPEC_DRAFT_LAYERS", "1")
    monkeypatch.setenv("HETU_SPEC_ADAPT", "0")
    assert tgd.resolve_spec_k(None) == 3
    assert tgd.resolve_spec_k(5) == 5
    assert tgd.resolve_draft_layers(None, 8) == 1
    assert tgd.resolve_draft_layers(3, 8) == 3
    monkeypatch.delenv("HETU_SPEC_DRAFT_LAYERS")
    assert tgd.resolve_draft_layers(None, 8) == 2     # auto: L // 4
    assert tgd.resolve_draft_layers(99, 8) == 8       # clamped
    assert tgd.resolve_draft_layers(None, 2) == 1
    eng = TServingEngine(p, tcfg, slots=2, device="cpu")
    assert eng.spec_k == 3 and eng.spec_draft_layers == 1
    assert not eng.spec_adapt and eng._spec_kcur == 3
    env_run = eng.run([TRequest(prompt=pr, max_new_tokens=n,
                                request_id=f"r{i}")
                       for i, (pr, n) in enumerate(GREEDY[:3])])
    assert eng.spec_waves > 0
    env_off = tgd.generate_fast(p, tcfg, [[7, 8, 9]], 6, device="cpu")
    monkeypatch.setenv("HETU_SPEC_K", "0")
    plain = TServingEngine(p, tcfg, slots=2, device="cpu")
    assert plain.spec_k == 0
    want = plain.run([TRequest(prompt=pr, max_new_tokens=n,
                               request_id=f"r{i}")
                      for i, (pr, n) in enumerate(GREEDY[:3])])
    assert {k: v.tokens.tolist() for k, v in env_run.items()} \
        == {k: v.tokens.tolist() for k, v in want.items()}
    assert env_off.tolist() == tgd.generate_fast(
        p, tcfg, [[7, 8, 9]], 6, device="cpu").tolist()


WRAPPERS = ("flash_attention", "ragged_paged_attention", "ragged_attention",
            "paged_decode_attention", "paged_block_decode_attention",
            "paged_verify_attention", "paged_block_verify_attention")


@pytest.mark.parametrize("entry", sorted(CONFIGS) + ["generate_fast"])
def test_spec_cores_attend_through_the_kernels(model, monkeypatch, entry):
    """Every speculative core calls its kernel wrapper once per layer (on
    a card, one launch each), as chip_smoke counts them: the draft the
    contiguous decode wrapper per draft layer per step (k + 1 a wave) and
    the flash wrapper per draft layer per admission; a phase-split wave
    the verify wrapper of its layout per layer, a mixed wave the ragged
    wrapper of its layout."""
    p, _, _, _, tcfg = model
    calls = {}
    for n in WRAPPERS:
        fn = getattr(tgd, n)

        def counted(*a, _fn=fn, _n=n, **kw):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tgd, n, counted)
    want = dict.fromkeys(WRAPPERS, 0)
    if entry == "generate_fast":
        tgd.generate_fast(p, tcfg, [[1, 2, 3], [4, 5, 6]], 9, spec=3,
                          spec_draft_layers=1, device="cpu")
        waves = calls.get("paged_verify_attention", 0) // L
        assert waves > 0
        want.update(flash_attention=L + 1, paged_verify_attention=L * waves,
                    paged_decode_attention=4 * waves)
    else:
        _, eng = _run(TServingEngine, TRequest, p, tcfg, GREEDY[:4],
                      device="cpu", **SPEC, **CONFIGS[entry])
        if eng.ragged:
            want["ragged_paged_attention" if eng.paged
                 else "ragged_attention"] = L * eng.steps
        else:
            want.update(flash_attention=L * (eng.prefill_dispatches
                                             - eng.prefill_chunks),
                        ragged_paged_attention=L * eng.prefill_chunks)
            want["paged_block_verify_attention" if eng.paged
                 else "paged_verify_attention"] = L * eng.steps
            assert eng.steps == eng.spec_waves
        want["paged_decode_attention"] += eng.spec_k_sum + eng.spec_waves
        want["flash_attention"] += eng.spec_draft_prefills
    assert {n: calls.get(n, 0) for n in WRAPPERS} == want


# ------------------------------------------------------------------- #
# KV rollback
# ------------------------------------------------------------------- #


def _mgr(paged):
    shape = dict(layers=1, heads=1, head_dim=4, slots=2, max_seq_len=64,
                 dtype=torch.float32, device="cpu")
    if paged:
        return TPagedKVManager(block=4, prefix_share=False, **shape)
    return TKVCacheManager(**shape)


def _write(m, slot, positions, values, paged):
    for pos, val in zip(positions, values):
        if paged:
            a, o = int(m.tables[slot, pos // m.block]), pos % m.block
        else:
            a, o = slot, pos
        m.cache_k[:, a, o] = val
        m.cache_v[:, a, o] = -val


def _live(m, slot, paged):
    n = int(m.lengths[slot])
    out = []
    for pos in range(n):
        if paged:
            a, o = int(m.tables[slot, pos // m.block]), pos % m.block
        else:
            a, o = slot, pos
        out.append((m.cache_k[:, a, o].tolist(), m.cache_v[:, a, o].tolist()))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_speculate_rollback_equals_replay(paged):
    """Randomized write-q / keep-some rounds leave the live cache region
    equal to a replay that only ever wrote what was kept."""
    rng = np.random.RandomState(7)
    spec, replay = _mgr(paged), _mgr(paged)
    if paged:
        s, _ = spec.alloc("r", [1, 2, 3], 40)
        r, _ = replay.alloc("r", [1, 2, 3], 40)
    else:
        s, r = spec.alloc("r", 0), replay.alloc("r", 0)
    n = 0
    for rnd in range(10):
        q = int(rng.randint(1, 5))
        if n + q > 40:
            break
        keep = int(rng.randint(1, q + 1))
        vals = [float(np.sin(n + j + 1)) if j < keep else 1e3 + rnd + j
                for j in range(q)]
        _write(spec, s, range(n, n + q), vals, paged)
        spec.advance(s, q)
        spec.truncate(s, n + keep)
        _write(replay, r, range(n, n + keep), vals[:keep], paged)
        replay.advance(r, keep)
        n += keep
    assert int(spec.lengths[s]) == n
    assert _live(spec, s, paged) == _live(replay, r, paged)
    if paged:
        assert spec.free_blocks == replay.free_blocks


def test_engine_rollback_leaves_pool_consistent(model):
    """A paged speculative run releases every block it reserved."""
    p, _, _, _, tcfg = model
    eng = TServingEngine(p, tcfg, slots=2, queue_limit=16, device="cpu",
                         spec_adapt=False, **SPEC,
                         **dict(CONFIGS["paged-split"], prefix_share=False))
    eng.run([TRequest(prompt=pr, max_new_tokens=n) for pr, n in GREEDY])
    assert eng.kv.free_blocks == eng.kv.n_blocks - 1
    assert int(np.sum(eng.kv.ref[1:])) == 0
