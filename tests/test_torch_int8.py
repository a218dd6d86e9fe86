"""The int8 KV cache of the PyTorch port against the JAX package's, on the
CPU, same numpy weights and inputs on both sides:

- ``quant.kv_encode`` / ``kv_decode`` exactly (payload and scales), for
  f32 and bf16 inputs and all-zero rows;
- the six int8 plain versions (K1/K8 ragged, K4/K5 decode, K6/K7
  verify, H 4, Dh 32) against the JAX int8 Pallas kernels in interpret
  mode, over permuted pools with a length-0 slot, a q_len-0 slot and
  dead verify rows, q f32 and bf16: 2e-5 (f32), 2e-2 (bf16, the JAX
  side keeps bf16 q);
- both managers after one sequence of writes, COW prefix forks,
  truncation and release: payload and scale planes exactly, plus
  ``cache_bytes`` and ``stats()["quant"]``;
- ``_decode_step``, ``_mixed_step`` and ``_verify_step`` over both
  layouts with int8 caches, against the JAX cores' kernel path: logits
  within 1e-4, live payloads within one quantization step;
- the chunk pass ``_serve_prefill_chunk``: within 1e-4 of the JAX mixed
  step's kernel path (the port's arithmetic: the chunk's K/V read back
  quantized), and within ``CHUNK_TOL`` of JAX's own chunk pass, which
  attends to the chunk's K/V before quantization (ROADMAP Queue C);
- ``teacher_forced_logits``, exact and fake-quantized, within 1e-4;
- the engine's greedy tokens against the JAX engine with
  ``kv_quant="int8"`` in all four configurations, with and without
  ``spec=2``, with chunked prefill and prefix sharing.

Inside the port: int8 engine tokens equal the offline f32
``generate_fast`` tokens on the JAX package's int8 prompts (its
``tests/test_quant.py``), ``$HETU_KV_QUANT`` selects int8, sampled
tokens with ``spec`` equal those without, and the int8 footprint is
what the shapes give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from hetu_tpu import quant as jquant
from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu.kernels import ragged_attention as jra
from hetu_tpu.models import GPTConfig
from hetu_tpu.models import gpt_decode as jgd
from hetu_tpu.serving import KVCacheManager, PagedKVManager
from hetu_tpu.serving import Request, ServingEngine
from hetu_tpu_torch import quant as tquant
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.models import GPTConfig as TGPTConfig
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TServingEngine
from hetu_tpu_torch.serving.kv_manager import (
    KVCacheManager as TKVCacheManager, PagedKVManager as TPagedKVManager)
from hetu_tpu_torch.weights import params_from_numpy

# the JAX package's int8 fixture (tests/test_quant.py:535): 2 layers,
# 2 heads, head dim 8, vocab 61, 32 positions
NAME, L, H, Dh, V, S = "qg", 2, 2, 8, 61, 32
CFG = (NAME, L, H, Dh, S)
ATOL = 1e-4
# the chunk pass against JAX's (fresh chunk K/V): the logit gaps
# measured in the two cases below are 2.4e-4 and 3.0e-4 (the int8
# round trip of the chunk's own K/V); the bound leaves 3x room
CHUNK_TOL = 1e-3


def rand_gpt(seed=0):
    """The JAX package's ``_rand_gpt`` weights (float64 numpy) with both
    packages' configs."""
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


@pytest.fixture(scope="module")
def model():
    p, jcfg, tcfg = rand_gpt()
    jp = {k: jgd._prep_param(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    return p, jp, tp, jcfg, tcfg


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _encode(x):
    """One float cache as the int8 pair: numpy (payload, scales) from the
    JAX encoder (equal to the port's, test_kv_encode_matches_jax)."""
    q, s = jquant.kv_encode(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


# ------------------------------------------------------------------- #
# the codec
# ------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["float32", "bfloat16", "zero-rows"])
def test_kv_encode_matches_jax(case):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 4, 32) * rng.uniform(0.01, 10, (3, 5, 4, 1)))
    x = x.astype(np.float32)
    if case == "zero-rows":
        x[1, 2] = 0.0
        x[0, :, 3] = 0.0
    jd = jnp.bfloat16 if case == "bfloat16" else jnp.float32
    td = torch.bfloat16 if case == "bfloat16" else torch.float32
    jq, js = jquant.kv_encode(jnp.asarray(x, jd))
    tq, ts = tquant.kv_encode(_t(x).to(td))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tquant.kv_decode(tq, ts).numpy(),
                                  np.asarray(jquant.kv_decode(jq, js)))
    if case == "zero-rows":
        assert (ts[1, 2] == 1.0).all() and (tq[1, 2] == 0).all()


# ------------------------------------------------------------------- #
# the six int8 plain versions against the JAX int8 kernels
# ------------------------------------------------------------------- #

KH, KDh = 4, 32


def _kernel_case(Q, seed):
    """Six slots over a permuted pool [N, 8, 4, 32] and the same slots as
    contiguous rows [6, 64, 4, 32], int8-encoded: a full q-block, a
    shorter one, one row, a q_len-0 slot with a length, a length-0 slot,
    and a slot of 40 positions."""
    rng = np.random.RandomState(seed)
    bs, T = 8, 8
    lens = np.array([17, 33, 5, 9, 0, 40], np.int32)
    q_lens = np.minimum(np.array([Q, Q - 1, 1, 0, 0, Q], np.int32), lens)
    B = len(lens)
    N = 1 + B * T
    tables = rng.permutation(np.arange(1, N))[:B * T].reshape(B, T)
    tables = tables.astype(np.int32)
    pool = rng.randn(2, N, bs, KH, KDh).astype(np.float32)
    rows = pool[:, tables].reshape(2, B, T * bs, KH, KDh)
    q = rng.randn(B, Q, KH, KDh).astype(np.float32)
    return q, _encode(pool), _encode(rows), lens, q_lens, tables


KINDS = ["ragged_paged", "ragged", "decode", "block_decode", "verify",
         "block_verify"]


def _call(kind, mod, q, enc, lens, q_lens, tables, jax_side):
    """One int8 wrapper of ``mod`` (the JAX or the port's (ragged,
    decode) modules) on an encoded cache ``enc`` = (payloads [2, ...],
    scales [2, ...]), K first; returns its output."""
    conv = jnp.asarray if jax_side else _t
    (k, v), (ks, vs) = ((conv(x[0]), conv(x[1])) for x in enc)
    sc = dict(k_scale=ks, v_scale=vs)
    if jax_side:
        sc["interpret"] = True
    L_, QL, TB = conv(lens), conv(q_lens), conv(tables)
    if kind == "ragged_paged":
        return mod[0].ragged_paged_attention(q, k, v, L_, QL, TB, **sc)
    if kind == "ragged":
        return mod[0].ragged_attention(q, k, v, L_, QL, **sc)
    if kind == "decode":
        return mod[1].paged_decode_attention(q[:, 0], k, v, L_, **sc)
    if kind == "block_decode":
        return mod[1].paged_block_decode_attention(q[:, 0], k, v, L_, TB,
                                                   **sc)
    if kind == "verify":
        return mod[1].paged_verify_attention(q, k, v, L_, QL, **sc)
    return mod[1].paged_block_verify_attention(q, k, v, L_, QL, TB, **sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_int8_plain_versions_match_jax_kernels(kind, dtype):
    Q = 1 if kind.endswith("decode") else 5
    q, pool, rows, lens, q_lens, tables = _kernel_case(Q, seed=3)
    enc = pool if kind.startswith(("ragged_paged", "block")) else rows
    want = _call(kind, (jra, jda), jnp.asarray(q, getattr(jnp, dtype)),
                 enc, lens, q_lens, tables, jax_side=True)
    got = _call(kind, (tra, tda), _t(q).to(getattr(torch, dtype)), enc,
                lens, q_lens, tables, jax_side=False)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=2e-5 if dtype == "float32" else 2e-2,
                               rtol=0)
    assert (got[4] == 0).all()                  # the length-0 slot


def test_int8_references_match_jax_references():
    """The port's gather-and-dequantize oracles against the JAX ones, and
    the four decode/verify references against the ragged ones they
    delegate to."""
    q, pool, rows, lens, q_lens, tables = _kernel_case(5, seed=4)
    (pk, pv), (ks, vs) = ((x[0], x[1]) for x in pool)
    got = tra.ragged_paged_reference(_t(q), _t(pk), _t(pv), _t(lens),
                                     _t(q_lens), _t(tables), _t(ks), _t(vs))
    want = jra.ragged_paged_reference(q, pk, pv, lens, q_lens, tables, ks,
                                      vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    (rk, rv), (rks, rvs) = ((x[0], x[1]) for x in rows)
    got = tda.masked_verify_reference(_t(q), _t(rk), _t(rv), _t(lens),
                                      _t(q_lens), _t(rks), _t(rvs))
    want = jda.masked_verify_reference(q, rk, rv, lens, q_lens, rks, rvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the gathered rows ARE the pool: both oracles agree exactly in kind
    pooled = tda.paged_block_decode_reference(
        _t(q[:, 0]), _t(pk), _t(pv), _t(lens), _t(tables), _t(ks), _t(vs))
    slotted = tda.masked_decode_reference(_t(q[:, 0]), _t(rk), _t(rv),
                                          _t(lens), _t(rks), _t(rvs))
    np.testing.assert_allclose(pooled.numpy(), slotted.numpy(), atol=1e-6,
                               rtol=0)


# ------------------------------------------------------------------- #
# the managers
# ------------------------------------------------------------------- #


def _planes(cache):
    return [np.asarray(x) for x in cache]


def _manager_ops(paged):
    """The same operations on both packages' int8 managers: each write
    encodes the same numpy K/V through the package's own scatter helper."""
    shape = dict(layers=2, heads=2, head_dim=8, slots=2, max_seq_len=32)
    if paged:
        jm = PagedKVManager(block=4, prefix_share=True, dtype="int8", **shape)
        tm = TPagedKVManager(block=4, prefix_share=True, dtype=torch.int8,
                             device="cpu", **shape)
    else:
        jm = KVCacheManager(dtype="int8", **shape)
        tm = TKVCacheManager(dtype="int8", device="cpu", **shape)
    rng = np.random.RandomState(9)

    def write(slot, positions):
        p = np.asarray(positions)
        kv = rng.randn(2, 2, len(p), 2, 8).astype(np.float32)
        if paged:
            a, o = jm.tables[slot, p // 4], p % 4
        else:
            a, o = np.full(len(p), slot), p
        for c, val in enumerate(kv):
            jc = jm.cache_k if c == 0 else jm.cache_v
            jc = jgd._kv_scatter(jc, (slice(None), jnp.asarray(a),
                                      jnp.asarray(o)), jnp.asarray(val))
            if c == 0:
                jm.cache_k = jc
            else:
                jm.cache_v = jc
            tc = tm.cache_k if c == 0 else tm.cache_v
            tgd._kv_write(tc, slice(None), (_t(a).long(), _t(o).long()),
                          _t(val))

    prompt = list(range(1, 11))                  # 10 tokens: 2.5 blocks
    if paged:
        sa, _ = jm.alloc("a", prompt, 16)
        assert tm.alloc("a", prompt, 16) == (sa, 0)
    else:
        sa = jm.alloc("a", 10)
        assert tm.alloc("a", 10) == sa
    write(sa, range(10))
    for m in (jm, tm):
        if paged:
            m.advance(sa, 10)
            m.register_prefix(prompt, sa)
    if paged:                                    # shares 2 blocks + COW
        sb, cached = jm.alloc("b", prompt[:10] + [40, 41], 20)
        assert tm.alloc("b", prompt[:10] + [40, 41], 20) == (sb, cached)
        assert cached == 10 and jm.cow_copies == tm.cow_copies == 1
        write(sb, range(10, 14))
        for m in (jm, tm):
            m.advance(sb, 4)
            m.truncate(sb, 11)
    else:
        sb = jm.alloc("b", 3)
        assert tm.alloc("b", 3) == sb
        write(sb, range(3))
        for m in (jm, tm):
            m.truncate(sb, 2)
    for m in (jm, tm):
        m.release(sa)
    return jm, tm


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_int8_managers_match_jax(paged):
    jm, tm = _manager_ops(paged)
    assert tm.quant == jm.quant == "int8"
    for jc, tc in ((jm.cache_k, tm.cache_k), (jm.cache_v, tm.cache_v)):
        assert isinstance(tc, tuple) and tc[0].dtype == torch.int8 \
            and tc[1].dtype == torch.float32
        for j, t in zip(_planes(jc), tc):
            np.testing.assert_array_equal(t.numpy(), j)
    assert tm.cache_bytes == jm.cache_bytes
    if paged:
        assert tm.stats()["quant"] == jm.stats()["quant"] == "int8"
        # the JAX pool also counts the fleet's exports, not ported (A7)
        assert tm.stats() == {k: jm.stats()[k] for k in tm.stats()}
        np.testing.assert_array_equal(tm.tables, jm.tables)
        np.testing.assert_array_equal(tm.ref, jm.ref)


def test_int8_footprint_from_the_shapes():
    """Payload + scales: (Dh + 4) / (4 * Dh) of the f32 bytes, 26.6% at
    GPT-2-small's Dh 64; the float pool reports "off"."""
    for Dh_, ratio in ((8, 12 / 32), (64, 68 / 256)):
        shape = dict(layers=3, heads=2, head_dim=Dh_, slots=4,
                     max_seq_len=64, block=16)
        q = TPagedKVManager(dtype="int8", device="cpu", **shape)
        f = TPagedKVManager(dtype=torch.float32, device="cpu", **shape)
        n = 2 * 3 * q.n_blocks * 16 * 2
        assert q.cache_bytes == n * (Dh_ + 4)
        assert f.cache_bytes == n * Dh_ * 4
        assert q.cache_bytes / f.cache_bytes == pytest.approx(ratio)
        assert f.stats()["quant"] == "off" and f.quant is None


# ------------------------------------------------------------------- #
# the cores
# ------------------------------------------------------------------- #


def _int8_cache(rng, paged, B=3, bs=8, T=4):
    """A random int8 cache, numpy ((k payload, k scales), (v payload, v
    scales)) over [L, 1+B*T, bs, H, Dh] with permuted tables, or over
    slot rows [L, B, S, H, Dh]."""
    if paged:
        N = 1 + B * T
        tables = rng.permutation(np.arange(1, N)).reshape(B, T)
        x = rng.randn(2, L, N, bs, H, Dh).astype(np.float32)
        return (_encode(x[0]), _encode(x[1])), tables.astype(np.int32)
    x = rng.randn(2, L, B, S, H, Dh).astype(np.float32)
    return (_encode(x[0]), _encode(x[1])), None


def _jc(c):
    return tuple(jnp.asarray(a) for a in c)


def _tc(c):
    return tuple(_t(a) for a in c)


def _assert_caches_close(got, want, tables, live_rows, rtol=1e-5):
    """Payloads within one quantization step and scales within ``rtol``
    (default: f32 rounding) wherever the port wrote (the JAX package
    also writes dead rows, into scratch block 0 or at clipped
    positions); everything else equal."""
    for (tq, ts), (jq, js) in zip(got, want):
        tq, ts = tq.numpy(), ts.numpy()
        jq, js = np.asarray(jq), np.asarray(js)
        if tables is not None:
            tq, ts, jq, js = tq[:, 1:], ts[:, 1:], jq[:, 1:], js[:, 1:]
        else:
            tq, ts, jq, js = (a[:, live_rows] for a in (tq, ts, jq, js))
        assert np.abs(tq.astype(np.int32) - jq.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(ts, js, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("core", ["decode", "mixed", "verify"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_int8_cores_match_jax(model, core, paged):
    """Three slots: a full block, a short one (or a decode token) and an
    inert slot, over a random int8 cache."""
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(11)
    (ck, cv), tables = _int8_cache(rng, paged)
    bt = None if tables is None else jnp.asarray(tables)
    tbt = None if tables is None else _t(tables)
    tk, tv = _tc(ck), _tc(cv)
    if core == "decode":
        pos = np.array([6, 11, 0], np.int32)
        live = np.array([True, True, False])
        tok = rng.randint(0, V, 3).astype(np.int32)
        jl, jk, jv = jgd._decode_step(
            jp, CFG, _jc(ck), _jc(cv), jnp.asarray(pos), jnp.asarray(tok),
            attn="ragged", block_tables=bt, live_mask=jnp.asarray(live))
        tl = tgd._decode_step(tp, CFG, tk, tv, _t(pos), _t(tok).long(),
                              block_tables=tbt, live_mask=_t(live))
        rows = live
        written = np.zeros((3, S), bool)
        written[[0, 1], pos[:2]] = True
    else:
        pos = np.array([6, 11, 0], np.int32)
        q_len = np.array([4, 2, 0], np.int32)
        toks = rng.randint(0, V, (3, 4)).astype(np.int32)
        fn = jgd._verify_step if core == "verify" else jgd._mixed_step
        extra = () if core == "verify" else (jnp.zeros(3, bool),)
        jl, jk, jv = fn(jp, CFG, _jc(ck), _jc(cv), jnp.asarray(pos),
                        jnp.asarray(toks), jnp.asarray(q_len), *extra,
                        attn="ragged", block_tables=bt)
        tfn = tgd._verify_step if core == "verify" else tgd._mixed_step
        tl = tfn(tp, CFG, tk, tv, _t(pos), _t(toks).long(), _t(q_len), tbt)
        rows = np.arange(4)[None, :] < q_len[:, None]
        written = np.zeros((3, S), bool)
        for b in range(3):
            written[b, pos[b]:pos[b] + q_len[b]] = True
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               atol=ATOL, rtol=0)
    _assert_caches_close((tk, tv), (jk, jv), tables, written)


def _chunk_case(rng, case):
    (ck, cv), tables = _int8_cache(rng, True)
    pos_off, n = (8, 5) if case == "prefix-tail" else (4, 4)
    toks = np.zeros(8, np.int32)
    toks[:n] = rng.randint(0, V, n)
    return ck, cv, tables[0], pos_off, n, toks


@pytest.mark.parametrize("case", ["prefix-tail", "mid-chunk"])
def test_int8_chunk_pass_is_the_mixed_kernel_path(model, case):
    """The port's chunk pass reads its own K/V back quantized through K1,
    as one slot of the JAX mixed step's kernel path: within 1e-4."""
    _, jp, tp, _, _ = model
    ck, cv, row, pos_off, n, toks = _chunk_case(np.random.RandomState(12),
                                                case)
    jl, jk, jv = jgd._mixed_step(
        jp, CFG, _jc(ck), _jc(cv), jnp.asarray([pos_off], jnp.int32),
        jnp.asarray(toks[None, :n]), jnp.asarray([n], jnp.int32),
        jnp.zeros(1, bool), attn="ragged",
        block_tables=jnp.asarray(row[None]))
    tk, tv = _tc(ck), _tc(cv)
    _, tl = tgd._serve_prefill_chunk(tp, CFG, tk, tv, _t(row),
                                     _t(toks[:n]).long(), pos_off)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[0, n - 1],
                               atol=ATOL, rtol=0)
    _assert_caches_close((tk, tv), (jk, jv), row[None], None)


@pytest.mark.parametrize("case", ["prefix-tail", "mid-chunk"])
def test_int8_chunk_pass_against_jax_chunk_pass(model, case):
    """JAX's own chunk pass attends to the chunk's K/V FRESH (its masked
    ``_mixed_step`` with ``self_fresh`` is that arithmetic): a difference
    by design, bounded by ``CHUNK_TOL``.  The blocks written are the same
    (both encode the same K/V), and so is the greedy first token."""
    _, jp, tp, _, _ = model
    ck, cv, row, pos_off, n, toks = _chunk_case(np.random.RandomState(13),
                                                case)
    bs = 8
    wblk = np.zeros(8, np.int32)
    woff = np.zeros(8, np.int32)
    for j in range(n):
        wblk[j], woff[j] = row[(pos_off + j) // bs], (pos_off + j) % bs
    first, jk, jv, _ = jgd.serve_prefill_chunk_fn(donate=False)(
        jp, CFG, _jc(ck), _jc(cv), jnp.asarray(row), jnp.asarray(toks),
        jnp.int32(pos_off), jnp.int32(n), jnp.float32(0.0), jnp.int32(0),
        jax.random.PRNGKey(0), jnp.asarray(wblk), jnp.asarray(woff))
    jl, _, _ = jgd._mixed_step(
        jp, CFG, _jc(ck), _jc(cv), jnp.asarray([pos_off], jnp.int32),
        jnp.asarray(toks[None]), jnp.asarray([n], jnp.int32),
        jnp.ones(1, bool), attn="masked",
        block_tables=jnp.asarray(row[None]), has_fresh=True)
    tk, tv = _tc(ck), _tc(cv)
    tok, tl = tgd._serve_prefill_chunk(tp, CFG, tk, tv, _t(row),
                                       _t(toks[:n]).long(), pos_off,
                                       sample=(0.0, 0, None))
    gap = np.abs(tl.numpy() - np.asarray(jl)[0, n - 1]).max()
    assert 0 < gap <= CHUNK_TOL
    # layer 0 encodes the same K/V; the later layers' K/V inherit the gap
    _assert_caches_close(((tk[0][:1], tk[1][:1]), (tv[0][:1], tv[1][:1])),
                         ((jk[0][:1], jk[1][:1]), (jv[0][:1], jv[1][:1])),
                         row[None], None)
    _assert_caches_close((tk, tv), (jk, jv), row[None], None,
                         rtol=CHUNK_TOL)
    assert tok == int(first)


@pytest.mark.parametrize("fake", [False, True], ids=["exact", "fake-quant"])
def test_teacher_forced_logits_match_jax(model, fake):
    p, _, _, jcfg, tcfg = model
    seq = np.asarray([7, 8, 9, 10, 11, 3, 1, 4, 2], np.int32)
    want = jgd.teacher_forced_logits(p, jcfg, seq, kv_fake_quant=fake)
    got = tgd.teacher_forced_logits(p, tcfg, seq, kv_fake_quant=fake,
                                    device="cpu")
    assert got.shape == (len(seq), V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ------------------------------------------------------------------- #
# the engine
# ------------------------------------------------------------------- #

PREFIX = list(range(20, 30))
# on 2 slots: queueing, prompts past the chunk, a shared 12-token prompt
# that a longer one extends mid-block (a COW fork of block 8), a
# one-token request
GREEDY = [([7, 8, 9], 6), ([3, 4], 8), (PREFIX + [1, 2], 6),
          ([1, 2, 3, 4, 5], 4), (PREFIX + [1, 2, 7], 5), ([13, 14], 1)]
CONFIGS = {
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=True, kv_block=8, ragged=False,
                        prefill_chunk=4, prefix_share=True),
    "paged-mixed": dict(paged=True, kv_block=8, ragged=True,
                        prefill_chunk=4, prefix_share=True),
    "contiguous-mixed": dict(paged=False, ragged=True),
}


def _run(Eng, Req, p, cfg, trace, slots=2, **kw):
    eng = Eng(p, cfg, slots=slots, queue_limit=64, **kw)
    res = eng.run([Req(prompt=t[0], max_new_tokens=t[1],
                       temperature=t[2] if len(t) > 2 else 0.0,
                       top_k=t[3] if len(t) > 3 else 0,
                       seed=t[4] if len(t) > 4 else i, request_id=f"r{i}")
                   for i, t in enumerate(trace)])
    return {k: v.tokens.tolist() for k, v in res.items()}, eng


@pytest.mark.parametrize("spec", [0, 2], ids=["plain", "spec2"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_int8_engine_matches_jax(model, config, spec):
    p, _, _, jcfg, tcfg = model
    kw = dict(CONFIGS[config], kv_quant="int8", spec=spec,
              spec_draft_layers=1, spec_adapt=False)
    want, jeng = _run(ServingEngine, Request, p, jcfg, GREEDY,
                      fast_path=True, **kw)
    got, teng = _run(TServingEngine, TRequest, p, tcfg, GREEDY,
                     device="cpu", **kw)
    assert got == want
    assert teng.kv_quant == teng.kv.quant == jeng.kv.quant == "int8"
    assert isinstance(teng.kv.cache_k, tuple)
    if teng.paged:
        assert teng.kv.prefix_hits == jeng.kv.prefix_hits > 0
        assert teng.kv.cow_copies == jeng.kv.cow_copies > 0
        assert teng.prefill_chunks == jeng.prefill_chunks > 0
    if spec:
        assert teng.spec_waves == jeng.spec_waves > 0
        assert teng.spec_accepted == jeng.spec_accepted
        assert teng._draft_ck.dtype == torch.float32


PROMPTS = [[7, 8, 9, 10], [3, 1, 4], [11, 12, 13, 14, 15]]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_int8_engine_equals_offline_f32(model, config):
    """The JAX package's gate (tests/test_quant.py): on these prompts the
    int8 engine's greedy tokens are the offline f32 ones."""
    p, _, _, _, tcfg = model
    got, eng = _run(TServingEngine, TRequest, p, tcfg,
                    [(pr, 6) for pr in PROMPTS], slots=4, device="cpu",
                    kv_quant="int8", **CONFIGS[config])
    for i, pr in enumerate(PROMPTS):
        off = tgd.generate_fast(p, tcfg, [pr], 6, device="cpu")
        assert got[f"r{i}"] == off[0].tolist(), i
    assert eng.kv.cache_k[0].dtype == torch.int8


def test_env_selects_int8(model, monkeypatch):
    p, _, _, _, tcfg = model
    monkeypatch.setenv("HETU_KV_QUANT", "int8")
    got, eng = _run(TServingEngine, TRequest, p, tcfg,
                    [(pr, 6) for pr in PROMPTS], slots=4, device="cpu",
                    **CONFIGS["paged-mixed"])
    assert eng.kv_quant == eng.kv.quant == "int8"
    assert eng.kv.stats()["quant"] == "int8"
    off = TServingEngine(p, tcfg, device="cpu", kv_quant="off")
    assert off.kv_quant is None and off.kv.quant is None
    monkeypatch.setenv("HETU_KV_QUANT", "0")
    plain, eng0 = _run(TServingEngine, TRequest, p, tcfg,
                       [(pr, 6) for pr in PROMPTS], slots=4, device="cpu",
                       **CONFIGS["paged-mixed"])
    assert eng0.kv_quant is None
    assert got == plain


SAMPLED = [([3, 4], 6, 0.9, 5, 11), ([7, 8, 9], 6, 0.7, 3, 22),
           ([11], 6, 1.1, 0, 33), (PREFIX + [1], 5, 0.8, 4, 44)]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_int8_spec_sampled_identity(model, config):
    """The verify kernels and the decode kernels dequantize the same
    bytes, so speculation changes no token under int8 either, sampled
    ones included."""
    p, _, _, _, tcfg = model
    kw = dict(CONFIGS[config], kv_quant="int8", device="cpu")
    plain, _ = _run(TServingEngine, TRequest, p, tcfg, SAMPLED, **kw)
    spec, eng = _run(TServingEngine, TRequest, p, tcfg, SAMPLED, spec=2,
                     spec_draft_layers=1, spec_adapt=False, **kw)
    assert plain == spec
    assert eng.spec_waves > 0
