"""The PyTorch port's GPT decode cores against the JAX package's, on the
CPU, same numpy weights and inputs on both sides: ``_prefill_forward``
logits and K/V; ``_decode_step`` at one position, at per-slot positions
and through block tables; ``_serve_prefill_chunk`` as a prefix tail and
as a mid-prompt chunk; one ``_mixed_step`` over the paged pool and over
the slot-contiguous cache (against both JAX attention paths, the kernel
and the masked reference); and greedy ``generate_fast`` tokens (against
both JAX prefills).  Plus the port's own contracts: the weights bridge
keeps dtypes, entry points refuse to run on the CPU unasked, every core
attends through its kernel wrapper whatever the environment says, and
importing the port loads neither JAX nor the JAX package.

Tolerance for logits and K/V: f32 ``atol 1e-4`` (the same arithmetic,
matmuls and softmax summed in another order).  With bf16 params and
caches, ``_decode_step`` and ``_mixed_step`` logits are held to two bf16
ulps of the largest |logit| (measured: at most 1.11).
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.models import GPTConfig
from hetu_tpu.models import gpt_decode as jgd
from hetu_tpu_torch.models import GPTConfig as TGPTConfig
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.weights import params_from_numpy

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
L, H, Dh, V, S = 2, 4, 16, 128, 128


def rand_gpt(name="rg", seed=0):
    """Random GPT weights as float64 numpy (the ``_rand_gpt`` recipe of
    tests/test_ragged_kernel.py) with both packages' configs: 2 layers,
    hidden 64, 4 heads, vocab 128, 128 positions."""
    rng = np.random.RandomState(seed)
    hd = H * Dh
    p = {f"{name}_wte_table": rng.randn(V, hd) * 0.05,
         f"{name}_wpe": rng.randn(S, hd) * 0.05,
         f"{name}_ln_f_scale": np.ones(hd),
         f"{name}_ln_f_bias": np.zeros(hd)}
    for i in range(L):
        us = f"{name}_h{i}"
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


CFG = ("rg", L, H, Dh, S)


def test_prefill_forward_matches_jax(model):
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, V, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 1], np.int32)
    jl, jk, jv = jgd._prefill_forward(jp, CFG, jnp.asarray(tokens),
                                      jnp.asarray(lens))
    tl, tk, tv = tgd._prefill_forward(
        tp, CFG, torch.from_numpy(tokens).long(), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=0)


def _mixed_wave(seed=2, bs=8, T=4):
    """Four slots over a permuted pool: a 5-token prompt chunk at
    position 3, a decode token at 10, an inert slot, a first decode token
    at 0 — in one Q=8 wave."""
    rng = np.random.RandomState(seed)
    N = 1 + 4 * T
    tables = rng.permutation(np.arange(1, N)).reshape(4, T).astype(np.int32)
    pool = rng.randn(2, L, N, bs, H, Dh).astype(np.float32)
    pos = np.array([3, 10, 0, 0], np.int32)
    q_len = np.array([5, 1, 0, 1], np.int32)
    tokens = np.zeros((4, 8), np.int32)
    for b in range(4):
        tokens[b, :q_len[b]] = rng.randint(0, V, q_len[b])
    fresh = np.array([True, False, False, False])
    return pool, tables, pos, q_len, tokens, fresh


@pytest.mark.parametrize("attn", ["ragged", "masked"])
def test_mixed_step_matches_jax(model, attn):
    """The port's one path against each JAX attention path: the ragged
    kernel (interpret mode off-TPU) and the masked reference with its
    fresh-self softmax."""
    _, jp, tp, _, _ = model
    pool, tables, pos, q_len, tokens, fresh = _mixed_wave()
    jl, jk, jv = jgd._mixed_step(
        jp, CFG, jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        jnp.asarray(pos), jnp.asarray(tokens), jnp.asarray(q_len),
        jnp.asarray(fresh), block_tables=jnp.asarray(tables), attn=attn,
        has_fresh=attn == "masked")
    ck = torch.from_numpy(pool[0].copy())
    cv = torch.from_numpy(pool[1].copy())
    tl = tgd._mixed_step(
        tp, CFG, ck, cv, torch.from_numpy(pos),
        torch.from_numpy(tokens).long(), torch.from_numpy(q_len),
        torch.from_numpy(tables))
    live = np.arange(8)[None, :] < q_len[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=0)
    # the pool writes, scratch block 0 aside
    np.testing.assert_allclose(ck.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(cv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               atol=ATOL, rtol=0)


def _pool_and_tables(rng, bs=8, T=4, B=4):
    """A random pool [2, L, 1 + B*T, bs, H, Dh] (K and V) with B
    permuted table rows: stale data everywhere, context for the cores
    below."""
    N = 1 + B * T
    tables = rng.permutation(np.arange(1, N)).reshape(B, T).astype(np.int32)
    return rng.randn(2, L, N, bs, H, Dh).astype(np.float32), tables


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, *static):
    """A JAX core compiled once (faster here than running it op by op)."""
    import jax
    return jax.jit(fn, static_argnames=("cfg_tuple", "attn") + static)


@pytest.mark.parametrize("layout", ["scalar", "slots", "paged-kernel",
                                    "paged-masked"])
def test_decode_step_matches_jax(model, layout):
    """One decode position in each layout.  The port's inert slots (a
    free contiguous row, a paged slot mid-prefill) write nothing and
    attend to nothing; the JAX package writes the free row and sends the
    inert paged write to scratch block 0."""
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(5)
    token = rng.randint(0, V, 4).astype(np.int32)
    live = np.array([True, False, True, True])
    tables = None
    if layout.startswith("paged"):
        cache, tables = _pool_and_tables(rng)
        pos = np.array([3, 0, 16, 31], np.int32)     # a block edge, a brim
        jl, jk, jv = _jit(jgd._decode_step)(
            jp, CFG, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
            jnp.asarray(pos), jnp.asarray(token),
            attn="ragged" if layout == "paged-kernel" else "masked",
            block_tables=jnp.asarray(tables), live_mask=jnp.asarray(live))
        tpos, tmask = _t(pos), _t(live)
    else:
        cache = rng.randn(2, L, 4, S, H, Dh).astype(np.float32)
        pos = np.array([9, 0, 40, S - 1], np.int32)
        jpos = 9 if layout == "scalar" else jnp.asarray(pos)
        jl, jk, jv = _jit(jgd._decode_step)(
            jp, CFG, jnp.asarray(cache[0]), jnp.asarray(cache[1]), jpos,
            jnp.asarray(token))
        tpos = 9 if layout == "scalar" else _t(pos)
        tmask = None if layout == "scalar" else _t(live)
        if layout == "scalar":
            live[:] = True
    ck, cv = _t(cache[0]), _t(cache[1])
    tl = tgd._decode_step(tp, CFG, ck, cv, tpos, _t(token).long(),
                          block_tables=None if tables is None
                          else _t(tables), live_mask=tmask)
    rows = slice(None) if layout == "paged-kernel" else live
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               atol=ATOL, rtol=0)
    for got, want, old in ((ck, jk, cache[0]), (cv, jv, cache[1])):
        got, want = got.numpy(), np.asarray(want)
        if tables is not None:      # the pool, scratch block 0 aside
            np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=ATOL,
                                       rtol=0)
        else:                       # live rows as JAX; the free row as was
            np.testing.assert_allclose(got[:, live], want[:, live],
                                       atol=ATOL, rtol=0)
            np.testing.assert_array_equal(got[:, ~live], old[:, ~live])


@pytest.mark.parametrize("case", ["prefix-tail", "mid-chunk"])
def test_serve_prefill_chunk_matches_jax(model, case):
    """One slot's chunk over its table row: a final 5-token tail after 8
    shared positions, and a 4-token chunk at 4 that samples nothing.
    The logits after the chunk equal the JAX chunk arithmetic (the masked
    ``_mixed_step`` with the chunk's fresh K/V); the blocks written and
    the greedy first token equal ``_serve_prefill_chunk``'s."""
    import jax
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(6)
    cache, tables = _pool_and_tables(rng)
    row, bs = tables[0], cache.shape[3]
    pos_off, n = (8, 5) if case == "prefix-tail" else (4, 4)
    final = case == "prefix-tail"
    C_b = 8
    toks = np.zeros(C_b, np.int32)
    toks[:n] = rng.randint(0, V, n)
    wblk = np.zeros(C_b, np.int32)
    woff = np.zeros(C_b, np.int32)
    for j in range(n):
        wblk[j], woff[j] = row[(pos_off + j) // bs], (pos_off + j) % bs
    first, jk, jv, _ = jgd.serve_prefill_chunk_fn(donate=False)(
        jp, CFG, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
        jnp.asarray(row), jnp.asarray(toks), jnp.int32(pos_off),
        jnp.int32(n), jnp.float32(0.0), jnp.int32(0),
        jax.random.PRNGKey(0), jnp.asarray(wblk), jnp.asarray(woff))
    jl, _, _ = _jit(jgd._mixed_step, "has_fresh")(
        jp, CFG, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
        jnp.asarray([pos_off], jnp.int32), jnp.asarray(toks[None]),
        jnp.asarray([n], jnp.int32), jnp.asarray([True]), attn="masked",
        block_tables=jnp.asarray(row[None]), has_fresh=True)
    ck, cv = _t(cache[0]), _t(cache[1])
    tok, tl = tgd._serve_prefill_chunk(
        tp, CFG, ck, cv, _t(row), _t(toks[:n]).long(), pos_off,
        sample=(0.0, 0, None) if final else None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[0, n - 1],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ck.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(cv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               atol=ATOL, rtol=0)
    assert tok == (int(first) if final else None)


@pytest.mark.parametrize("attn", ["ragged", "masked"])
def test_mixed_step_contiguous_matches_jax(model, attn):
    """A contiguous mixed wave (Q = 8): a 5-token prompt q-block at 3, a
    decode token at 10, a free slot, and a decode token at the LAST
    position, where the JAX package's clipped dead rows land too (it
    writes them first so the live row wins).  The port writes live rows
    only: every live position equals JAX's, every other position keeps
    what it held."""
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(7)
    cache = rng.randn(2, L, 4, S, H, Dh).astype(np.float32)
    pos = np.array([3, 10, 0, S - 1], np.int32)
    q_len = np.array([5, 1, 0, 1], np.int32)
    tokens = np.zeros((4, 8), np.int32)
    for b in range(4):
        tokens[b, :q_len[b]] = rng.randint(0, V, q_len[b])
    jl, jk, jv = _jit(jgd._mixed_step, "has_fresh")(
        jp, CFG, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
        jnp.asarray(pos), jnp.asarray(tokens), jnp.asarray(q_len),
        jnp.zeros(4, bool), attn=attn)
    ck, cv = _t(cache[0]), _t(cache[1])
    tl = tgd._mixed_step(tp, CFG, ck, cv, _t(pos), _t(tokens).long(),
                         _t(q_len))
    valid = np.arange(8)[None, :] < q_len[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=ATOL, rtol=0)
    written = np.zeros((4, S), bool)
    for b in range(4):
        written[b, pos[b]:pos[b] + q_len[b]] = True
    for got, want, old in ((ck, jk, cache[0]), (cv, jv, cache[1])):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[:, written], want[:, written],
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got[:, ~written], old[:, ~written])


# bf16 params and caches: the cores' f32 logits within two bf16 ulps of
# the largest |logit| (2^-6 of it); measured here at most 1.11 ulps
# (1.17e-2 on logits up to 1.35, the contiguous mixed wave): the two
# sides round the same bf16 products at other points (the port's plain
# attention keeps P in f32).
BF16_ULPS = 2


def bf16_close(got, want, rows):
    want = np.asarray(jnp.asarray(want, jnp.float32))[rows]
    tol = BF16_ULPS * 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy()[rows], want, atol=tol,
                               rtol=0)


def bf16_params(p):
    """The numpy weights as bf16 on both sides."""
    jp = {k: jnp.asarray(np.asarray(v, np.float32), jnp.bfloat16)
          for k, v in p.items()}
    tp = {k: v.to(torch.bfloat16)
          for k, v in params_from_numpy(p, device="cpu").items()}
    return jp, tp


def _bf(a):
    return (jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("core", ["decode-slots", "decode-paged",
                                  "mixed-paged", "mixed-contiguous"])
def test_bf16_cores_match_jax(model, core):
    """``_decode_step`` and ``_mixed_step`` logits with bf16 params and
    caches against the JAX cores' (their kernels in interpret mode)."""
    p = model[0]
    jp, tp = bf16_params(p)
    rng = np.random.RandomState(5)
    if core.startswith("decode"):
        token = rng.randint(0, V, 4).astype(np.int32)
        live = np.array([True, False, True, True])
        if core == "decode-paged":
            cache, tables = _pool_and_tables(rng)
            pos = np.array([3, 0, 16, 31], np.int32)
            kw = dict(attn="ragged", block_tables=jnp.asarray(tables),
                      live_mask=jnp.asarray(live))
            tkw = dict(block_tables=_t(tables))
        else:
            cache = rng.randn(2, L, 4, S, H, Dh).astype(np.float32)
            pos = np.array([9, 0, 40, S - 1], np.int32)
            kw, tkw = {}, {}
        (jk, tk), (jv, tv) = _bf(cache[0]), _bf(cache[1])
        jl, _, _ = _jit(jgd._decode_step)(jp, CFG, jk, jv, jnp.asarray(pos),
                                          jnp.asarray(token), **kw)
        tl = tgd._decode_step(tp, CFG, tk, tv, _t(pos), _t(token).long(),
                              live_mask=_t(live), **tkw)
        rows = live
    else:
        if core == "mixed-paged":
            cache, tables, pos, q_len, tokens, _ = _mixed_wave()
            kw = dict(block_tables=jnp.asarray(tables))
            tkw = (_t(tables),)
        else:
            cache = rng.randn(2, L, 4, S, H, Dh).astype(np.float32)
            pos = np.array([3, 10, 0, S - 1], np.int32)
            q_len = np.array([5, 1, 0, 1], np.int32)
            tokens = np.zeros((4, 8), np.int32)
            for b in range(4):
                tokens[b, :q_len[b]] = rng.randint(0, V, q_len[b])
            kw, tkw = {}, ()
        (jk, tk), (jv, tv) = _bf(cache[0]), _bf(cache[1])
        jl, _, _ = _jit(jgd._mixed_step, "has_fresh")(
            jp, CFG, jk, jv, jnp.asarray(pos), jnp.asarray(tokens),
            jnp.asarray(q_len), jnp.zeros(4, bool), attn="ragged", **kw)
        tl = tgd._mixed_step(tp, CFG, tk, tv, _t(pos), _t(tokens).long(),
                             _t(q_len), *tkw)
        rows = np.arange(8)[None, :] < q_len[:, None]
    assert tl.dtype == torch.float32
    bf16_close(tl, jl, rows)


@pytest.mark.parametrize("prefill", ["flash", "scan"])
@pytest.mark.parametrize("eos", [False, True])
def test_generate_fast_greedy_matches_jax(model, prefill, eos):
    """The port's flash prefill against each JAX prefill."""
    p, _, tp, jcfg, tcfg = model
    prompts = np.random.RandomState(3).randint(0, V, (3, 7))
    want = jgd.generate_fast(p, jcfg, prompts, 12, prefill=prefill)
    eos_id = None
    if eos:
        eos_id = int(want[0, 7 + 3])      # a token the greedy run emits
        want = jgd.generate_fast(p, jcfg, prompts, 12, prefill=prefill,
                                 eos_id=eos_id, pad_id=5)
    got = tgd.generate_fast(tp, tcfg, prompts, 12, eos_id=eos_id,
                            pad_id=5, device="cpu")
    assert got.dtype == np.int32 and got.shape == (3, 19)
    np.testing.assert_array_equal(got, want)


def test_generate_fast_sampling_is_seeded(model):
    _, _, tp, _, tcfg = model
    prompts = np.random.RandomState(4).randint(0, V, (2, 5))

    def run(seed):
        return tgd.generate_fast(tp, tcfg, prompts, 16, temperature=0.9,
                                 top_k=8, seed=seed, device="cpu")
    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < V)).all()


def test_weights_bridge_keeps_dtypes():
    src = {"f64": np.arange(4, dtype=np.float64),
           "f32": np.arange(4, dtype=np.float32),
           "bf16": np.asarray(jnp.arange(4, dtype=jnp.bfloat16)),
           "i64": np.arange(4, dtype=np.int64)}
    got = params_from_numpy(src, device="cpu")
    assert set(got) == set(src)
    assert got["f64"].dtype == torch.float32
    assert got["f32"].dtype == torch.float32
    assert got["bf16"].dtype == torch.bfloat16
    assert got["i64"].dtype == torch.int32
    for k, v in got.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(src[k], np.float32))
    cast = params_from_numpy(src, device="cpu", dtype=torch.bfloat16)
    assert cast["f32"].dtype == torch.bfloat16


def test_entry_points_refuse_cpu_unasked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from hetu_tpu_torch.serving import ServingEngine
    p, _, _, _, tcfg = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgd.generate_fast(p, tcfg, [[1, 2, 3]], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(p, tcfg, paged=True, ragged=True)


@pytest.mark.parametrize("val,want", [("mixed", True), ("phase", False)])
def test_resolution_rules(monkeypatch, val, want):
    monkeypatch.setenv("HETU_SERVE_RAGGED", val)
    assert tgd.resolve_serve_ragged() is want
    # an explicit argument wins
    assert tgd.resolve_serve_ragged(not want) is (not want)
    monkeypatch.setenv("HETU_SERVE_RAGGED", "auto")
    assert tgd.resolve_serve_ragged() is torch.cuda.is_available()


def _counting(monkeypatch, name):
    """Replace the core's reference to kernel wrapper ``name`` with one
    that counts its calls."""
    calls = []
    fn = getattr(tgd, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(tgd, name, wrapped)
    return calls


KERNEL_WRAPPERS = ("flash_attention", "ragged_paged_attention",
                   "ragged_attention", "paged_decode_attention",
                   "paged_block_decode_attention")
# engine entry -> (layout and scheduler arguments)
ENGINES = {"engine": dict(paged=True, kv_block=8, ragged=True),
           "contiguous-split": dict(paged=False, ragged=False),
           "paged-split": dict(paged=True, kv_block=8, ragged=False,
                               prefill_chunk=4),
           "contiguous-mixed": dict(paged=False, ragged=True)}


@pytest.mark.parametrize("fast", ["0", "1"])
@pytest.mark.parametrize("entry", ["engine", "generate_fast",
                                   "contiguous-split", "paged-split",
                                   "contiguous-mixed"])
def test_cores_attend_through_the_kernels(model, monkeypatch, fast,
                                          entry):
    """The JAX package's ``$HETU_SERVE_FAST=0`` picks its masked/scan
    reference; the port has no such path, so every core calls its kernel
    wrapper once per layer, whatever the variable says (on a card every
    call is a kernel launch): the paged mixed engine the ragged paged
    wrapper per step, the contiguous mixed one the contiguous ragged
    wrapper; the phase-split engines the flash wrapper per prefill group,
    the paged one the ragged paged wrapper per chunk pass, and the
    decode wrapper of their layout per decode wave; ``generate_fast``
    the flash wrapper once and the contiguous decode wrapper per decode
    position."""
    from hetu_tpu_torch.serving import Request, ServingEngine
    p, _, _, _, tcfg = model
    monkeypatch.setenv("HETU_SERVE_FAST", fast)
    calls = {n: _counting(monkeypatch, n) for n in KERNEL_WRAPPERS}
    want = dict.fromkeys(KERNEL_WRAPPERS, 0)
    if entry == "generate_fast":
        tgd.generate_fast(p, tcfg, [[1, 2, 3]], 4, device="cpu")
        want.update(flash_attention=L, paged_decode_attention=3 * L)
    else:
        eng = ServingEngine(p, tcfg, slots=2, device="cpu", **ENGINES[entry])
        eng.run([Request(prompt=[1, 2, 3], max_new_tokens=3),
                 Request(prompt=[4] * 11, max_new_tokens=2)])
        assert eng.steps > 0
        if eng.ragged:
            want["ragged_paged_attention" if eng.paged
                 else "ragged_attention"] = L * eng.steps
        else:
            groups = eng.prefill_dispatches - eng.prefill_chunks
            assert groups > 0 and (eng.prefill_chunks > 0) == eng.paged
            want.update(flash_attention=L * groups,
                        ragged_paged_attention=L * eng.prefill_chunks)
            want["paged_block_decode_attention" if eng.paged
                 else "paged_decode_attention"] = L * eng.steps
    assert {n: len(c) for n, c in calls.items()} == want


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|hetu_tpu)(\.|\s|$)",
                        re.MULTILINE)


def test_port_sources_import_no_jax():
    files = sorted((REPO / "hetu_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT_RE.finditer(f.read_text())]
    assert not bad, bad


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import hetu_tpu_torch, hetu_tpu_torch.serving.engine\n"
        "import hetu_tpu_torch.kernels.flash_attention\n"
        "import hetu_tpu_torch.kernels.decode_attention\n"
        "import hetu_tpu_torch.kernels.ragged_attention\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'hetu_tpu' or "
        "m.startswith('hetu_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
