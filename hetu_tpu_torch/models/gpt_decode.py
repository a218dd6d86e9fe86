"""KV-cached GPT decoding in PyTorch: the port of the JAX package's
``models/gpt_decode.py`` for dense GPT models and their MoE variant.

Weights come as the named-parameter dict of the JAX package (the
executor / HF-importer contract, ``<name>_wte_table``,
``<name>_h<i>_attn_q_weight``, ...), turned into tensors by
``weights.params_from_numpy``:

    out = generate_fast(params, cfg, prompts, num_tokens=50,
                        temperature=0.8, top_k=40, seed=0)

The cores, each attending through one kernel wrapper per layer:

- ``_prefill_forward``: one batched full-prompt pass through the flash
  kernel (offline ``generate_fast`` and the phase-split schedulers'
  admission groups, ``_serve_prefill_batch``);
- ``_decode_step``: one position per slot through the decode kernels,
  over the contiguous ``[L, B, S_max, H, Dh]`` cache at one position
  (offline) or at per-slot positions, or over the block-table pool
  (the phase-split decode waves, ``_serve_decode_step``);
- ``_serve_prefill_chunk``: one prompt chunk of one slot through the
  ragged paged kernel (the paged phase-split scheduler's chunked
  prefill and prefix-tail pass);
- ``_mixed_step``: the mixed scheduler's ONE core per step: every slot's
  ragged q-block (prompt, decode token or speculative verify block) is
  written into the cache and attended by the ragged kernel of its layout
  (``_serve_mixed``);
- ``_verify_step``: the same body on the verify kernels, the phase-split
  schedulers' speculative verify wave (``_serve_verify``) and offline
  speculative ``generate_fast``; its draft proposes through
  ``_decode_step`` over its own contiguous cache (``_spec_propose``).

A serving cache may be int8 (an ``(int8 payload, f32 scales)`` pair, see
``_kv_write``): the cores then attend through the int8 twins of the same
kernels.  ``teacher_forced_logits`` is the oracle of int8's margin gate.

An MoE model (``moe_decode.MoEDecodeConfig``) runs through the same
cores: its ``MoESpec`` rides ``cfg_tuple`` as a sixth element, and
``_ffn_block`` routes every position of a call through
``moe_decode.moe_ffn`` on the MoE blocks.  Each core takes ``stats``, a
dict in which the MoE layers accumulate their per-expert load and drop
counts as device tensors.

PyTorch idiom: plain functions on tensors and dicts of tensors, an
explicit device (the one the params live on), explicit
``torch.Generator``s for sampling, and in-place index writes into the KV
caches where the JAX package donated the buffers.  Sampled tokens are a
pure function of (prompt, seed, settings) inside the port; they do not
match JAX's threefry streams.  Greedy tokens match.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import envvars
from ..device import resolve_device
from ..kernels.decode_attention import (paged_block_decode_attention,
                                        paged_block_verify_attention,
                                        paged_decode_attention,
                                        paged_verify_attention)
from ..kernels.flash_attention import flash_attention
from ..kernels.ragged_attention import (ragged_attention,
                                        ragged_paged_attention)
from ..quant import kv_decode, kv_encode
from ..weights import prep_param
from .moe_decode import moe_ffn, moe_spec_of

NEG_INF = -1e30


# ----------------------- the int8 cache ----------------------- #
#
# An int8 KV cache (``kv_quant="int8"``, $HETU_KV_QUANT) travels as an
# ``(int8 payload, f32 scales)`` pair wherever a float cache tensor
# travels: the payload has the float cache's shape, the scales drop its
# Dh axis.  These helpers are the only places where the two forks meet:
# a write encodes through ``quant.kv_encode`` (one scale per position and
# head), and each layer hands the payload and its scale planes to the
# kernel wrapper, whose int8 twin dequantizes inside its loop.


def _kv_q(cache):
    """True when ``cache`` is the int8 (payload, scales) pair."""
    return isinstance(cache, (tuple, list))


def _kv_payload(cache):
    """The cache tensor whose shape and device the cores read: the int8
    payload, or the float cache itself."""
    return cache[0] if _kv_q(cache) else cache


def _kv_layer(cache, i):
    """Layer ``i``'s (K or V, scales or None), as the wrappers take it."""
    if _kv_q(cache):
        return cache[0][i], cache[1][i]
    return cache[i], None


def _kv_write(cache, i, idx, val):
    """``cache[i][idx] = val`` in place, ``i`` a layer or ``slice(None)``
    for all of them and ``idx`` a tuple of index tensors (or slices and
    ints) over the next axes; ``val`` is the float K or V slab.  An int8
    cache encodes it and writes payload and scales through the SAME
    index: the scale planes lack only the trailing Dh axis."""
    if _kv_q(cache):
        q, s = kv_encode(val)
        cache[0][(i, *idx)] = q
        cache[1][(i, *idx)] = s
    else:
        cache[(i, *idx)] = val.to(cache.dtype)


def _pow2(n, floor=1):
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def resolve_serve_ragged(mode=None):
    """Mixed-mode ragged dispatch selection: an explicit argument wins;
    else ``$HETU_SERVE_RAGGED``; else auto — mixed when
    ``torch.cuda.is_available()``, the phase-split scheduler
    elsewhere."""
    if mode is None:
        mode = envvars.get_str("HETU_SERVE_RAGGED")
    if isinstance(mode, bool):
        return mode
    s = str(mode).strip().lower()
    if s in ("1", "on", "true", "mixed", "ragged"):
        return True
    if s in ("0", "off", "false", "phase", "split", "phased"):
        return False
    return torch.cuda.is_available()


def resolve_spec_k(spec=None):
    """Speculative-decoding depth: explicit ``spec`` wins, else
    ``$HETU_SPEC_K``; 0 = off."""
    if spec is None:
        spec = envvars.get_int("HETU_SPEC_K")
    return max(int(spec or 0), 0)


def resolve_draft_layers(layers, total_layers):
    """Truncated-layer draft depth: explicit ``layers`` wins, then
    ``$HETU_SPEC_DRAFT_LAYERS``, then max(1, L // 4).  The draft is the
    target's first ``layers`` blocks plus the shared final LN and tied
    head: no weights of its own."""
    if not layers:
        layers = envvars.get_int("HETU_SPEC_DRAFT_LAYERS")
    if not layers or int(layers) <= 0:
        layers = max(1, int(total_layers) // 4)
    return min(int(layers), int(total_layers))


def _ln(x, scale, bias, eps=1e-5):
    # statistics in f32 regardless of the compute dtype: bf16 mean/var
    # over outlier channels (GPT-2 residual streams have them) loses
    # enough mantissa to flip close argmax decisions
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = ((x32 - m) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - m) * torch.rsqrt(v + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _gelu_tanh(x):
    # tanh approximation (HF gelu_new)
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x ** 3)))


def _moe_of(cfg_tuple):
    """The cfg_tuple's optional sixth element: a ``MoESpec``, or None for
    a dense GPT."""
    return cfg_tuple[5] if len(cfg_tuple) > 5 else None


def _draft_cfg(cfg_tuple, draft_layers):
    """The truncated-layer draft's cfg_tuple: ``draft_layers`` of the
    target's blocks, and an MoE target's spec with ``draft=True``, so
    that the draft's MoE blocks route nothing."""
    cfg_d = (cfg_tuple[0], draft_layers) + tuple(cfg_tuple[2:5])
    moe = _moe_of(cfg_tuple)
    return cfg_d if moe is None else cfg_d + (moe._replace(draft=True),)


def _ffn_block(params, us, h, i, moe=None, valid=None, stats=None,
               moe_rows=None):
    """LN2 then the FFN of block ``i``, residual added: the dense wi ->
    gelu -> wo, or on an MoE block (``moe`` set and block ``i`` routed)
    ``moe_ffn`` over every position of the call flattened into one
    routing block (capacity counts them all, or ``moe_rows`` when the
    caller passes the reference's padded count).  A draft spec returns
    ``h`` untouched.  ``valid`` (bool, h's leading shape, or None for
    all) keeps pad and inert positions out of routing; ``stats``
    accumulates the per-expert load and drop counts."""
    if moe is not None and moe.is_moe_layer(i):
        if moe.draft:
            return h
        x = _ln(h, params[f"{us}_ln2_scale"], params[f"{us}_ln2_bias"])
        shp = x.shape
        vf = None if valid is None else valid.expand(shp[:-1]).reshape(-1)
        y = moe_ffn(params, us, x.reshape(-1, shp[-1]), moe, valid=vf,
                    stats=stats, rows=moe_rows)
        return h + y.reshape(shp)
    x = _ln(h, params[f"{us}_ln2_scale"], params[f"{us}_ln2_bias"])
    f = _gelu_tanh(x @ params[f"{us}_ffn_wi_weight"]
                   + params[f"{us}_ffn_wi_bias"])
    f = f @ params[f"{us}_ffn_wo_weight"] + params[f"{us}_ffn_wo_bias"]
    return h + f


def _qkv(params, us, x, shape):
    q = (x @ params[f"{us}_attn_q_weight"]
         + params[f"{us}_attn_q_bias"]).reshape(shape)
    k = (x @ params[f"{us}_attn_k_weight"]
         + params[f"{us}_attn_k_bias"]).reshape(shape)
    v = (x @ params[f"{us}_attn_v_weight"]
         + params[f"{us}_attn_v_bias"]).reshape(shape)
    return q, k, v


def _logits(params, name, h):
    """Final LN and the tied head; logits in f32 whatever the compute
    dtype (sampling compares and exponentiates them)."""
    h = _ln(h, params[f"{name}_ln_f_scale"], params[f"{name}_ln_f_bias"])
    logits = (h @ params[f"{name}_wte_table"].T).float()
    bias = params.get(f"{name}_head_bias")
    return logits if bias is None else logits + bias


def _kv_index(cache_k, block_tables, slots, posns):
    """Where positions ``posns`` of slots ``slots`` (1-D long tensors of
    one length) live in one layer of the cache, as index tensors into
    its axes 0 and 1: the slot row and position for the slot-contiguous
    cache (``block_tables`` None), the block through the slot's table
    row and the offset in it for the block-table pool."""
    if block_tables is None:
        return slots, posns
    bs = _kv_payload(cache_k).shape[2]
    return block_tables.long()[slots, posns // bs], posns % bs


def _decode_step(params, cfg_tuple, cache_k, cache_v, pos, token,
                 block_tables=None, live_mask=None, stats=None):
    """One position per slot: ``token`` [B] int64 consumed at ``pos`` —
    a Python int (offline: the whole batch at one position) or a [B]
    tensor (serving: every slot at its own filled length).  Returns
    logits [B, V] f32.

    Layouts, each with one attention path:

    - int ``pos`` over the contiguous cache ``[L, B, S_max, H, Dh]``:
      ``paged_decode_attention`` with lengths ``pos + 1``;
    - tensor ``pos`` over the contiguous cache: the same kernel over the
      slot rows, lengths ``pos[b] + 1``;
    - tensor ``pos`` with ``block_tables`` [B, T] int32 over the pool
      ``[L, N_blocks, bs, H, Dh]``: ``paged_block_decode_attention``.

    Either cache may be the int8 (payload, scales) pair (``_kv_write``):
    the same wrappers then launch their int8 twins.

    ``live_mask`` ([B] bool, tensor ``pos`` only; default all live)
    marks the slots decoding this wave: the others ride along inert,
    with length 0 (zeros attended, logits discarded by the caller) and
    no cache write, so a slot mid-prefill keeps the prompt K/V it holds,
    and routes nothing through an MoE block (an int ``pos`` routes every
    row).  Each layer writes the live slots' K/V in place (the JAX
    package donates the cache here) before it attends."""
    name, L, H, Dh = cfg_tuple[:4]
    moe = _moe_of(cfg_tuple)
    B = token.shape[0]
    hdim = H * Dh
    dev = token.device
    if torch.is_tensor(pos):
        pos = pos.long()
        if live_mask is None:
            live_mask = torch.ones(B, dtype=torch.bool, device=dev)
        lens = torch.where(live_mask, pos + 1, 0).to(torch.int32)
        rows = live_mask.nonzero()[:, 0]
        wa, wo = _kv_index(cache_k, block_tables, rows, pos[rows])
    else:
        lens = torch.full((B,), int(pos) + 1, dtype=torch.int32, device=dev)
        rows = slice(None)
        wa, wo = slice(None), int(pos)
    h = params[f"{name}_wte_table"][token] + params[f"{name}_wpe"][pos]
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (B, H, Dh))
        _kv_write(cache_k, i, (wa, wo), k[rows])
        _kv_write(cache_v, i, (wa, wo), v[rows])
        ks, ksc = _kv_layer(cache_k, i)
        vs, vsc = _kv_layer(cache_v, i)
        if block_tables is None:
            o = paged_decode_attention(q, ks, vs, lens, k_scale=ksc,
                                       v_scale=vsc)
        else:
            o = paged_block_decode_attention(q, ks, vs, lens, block_tables,
                                             k_scale=ksc, v_scale=vsc)
        o = o.reshape(B, hdim) @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o, i, moe, live_mask, stats)
    return _logits(params, name, h)


def _gumbel_argmax(scaled, generator):
    """A categorical sample over the last axis of ``scaled`` (logits
    divided by the temperature, masked entries at NEG_INF): the argmax
    of scaled + Gumbel noise drawn from ``generator``."""
    u = torch.rand(scaled.shape, generator=generator,
                   device=scaled.device, dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(scaled + g, dim=-1)


def _sample(logits, temperature, top_k, generator):
    """Offline batch sampling: logits [B, V] f32, one generator for the
    batch.  temperature 0 is greedy; top_k > 0 masks all but the k
    largest scaled logits."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature <= 0.0:
        return greedy
    scaled = logits / max(float(temperature), 1e-6)
    if top_k:
        kth = torch.topk(scaled, int(top_k), dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF),
                             scaled)
    return _gumbel_argmax(scaled, generator)


def _sample_slot(logits, temperature, top_k, generator):
    """One slot's token from logits [V] f32 with its own settings and
    generator (serving mixes settings freely in one wave)."""
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    scaled = logits / max(float(temperature), 1e-6)
    if top_k > 0:
        k = min(int(top_k), scaled.shape[-1])
        kth = torch.topk(scaled, k).values[-1]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF),
                             scaled)
    return int(_gumbel_argmax(scaled, generator))


def _spec_sample(logits, temperature, top_k, generators, first_row,
                 q_len):
    """Per-slot sampling over a wave's logits [B, Q, V]: slot b draws
    from its generator only at rows ``first_row[b] <= j < q_len[b]`` —
    row 0 of a decode slot, every row of a verify block, the last row of
    a prompt's FINAL chunk, none for a mid-prompt chunk — in row order,
    each row exactly as the row's own sequential step would.  Other rows
    (and greedy slots) get the argmax.

    Returns (tokens [B, Q] int64 numpy, after): ``after[b]`` is None for
    a slot that drew nothing, else {row j: ``generator.get_state()``
    right after row j's draw}.  A verify wave that emits n tokens puts
    the generator back at ``after[b][n - 1]`` (the JAX package's
    ``keys_after``), so a request's stream is consumed exactly once per
    EMITTED token and sampled outputs equal the non-speculative ones."""
    toks = torch.argmax(logits, dim=-1).cpu().numpy()
    after = [None] * len(generators)
    for b, gen in enumerate(generators):
        if gen is None or temperature[b] <= 0.0:
            continue
        rows = range(int(first_row[b]), int(q_len[b]))
        if rows:
            after[b] = {}
        for j in rows:
            toks[b, j] = _sample_slot(logits[b, j], float(temperature[b]),
                                      int(top_k[b]), gen)
            after[b][j] = gen.get_state()
    return toks, after


def _sample_slots(logits, temperature, top_k, generators, live=None):
    """One token per row of logits [B, V] f32: row b draws once from
    ``generators[b]`` when it is sampled and ``live[b]`` (default all
    live), else takes the argmax.  Host arrays as for
    :func:`_spec_sample`.  Returns [B] int64 numpy."""
    B = logits.shape[0]
    q_len = np.ones(B, np.int32) if live is None \
        else np.asarray(live, np.int32)
    return _spec_sample(logits[:, None], temperature, top_k, generators,
                        np.zeros(B, np.int32), q_len)[0][:, 0]


def _prefill_forward(params, cfg_tuple, tokens, kv_lens, stats=None,
                     moe_rows=None):
    """ONE full-prompt forward over a bucket-padded token block: every
    layer's K/V for all positions in one batched pass, attention through
    the flash kernel (causal + kv_lens).  tokens [N, P_b] (positions >=
    kv_lens[n] are pad, kept out of MoE routing); kv_lens [N] int32;
    moe_rows: the position count that sets MoE capacity (default
    N x P_b; ``_ffn_block``).
    Returns (logits [N, V] f32 at each row's kv_lens-1, ks, vs [L, N,
    P_b, H, Dh])."""
    name, L, H, Dh = cfg_tuple[:4]
    moe = _moe_of(cfg_tuple)
    N, P_b = tokens.shape
    hdim = H * Dh
    dev = tokens.device
    valid = (None if moe is None else
             torch.arange(P_b, device=dev)[None, :] < kv_lens[:, None])
    h = params[f"{name}_wte_table"][tokens] \
        + params[f"{name}_wpe"][:P_b][None]
    ks, vs = [], []
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (N, P_b, H, Dh))
        o = flash_attention(q, k, v, causal=True, kv_lens=kv_lens)
        o = o.reshape(N, P_b, hdim) @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o, i, moe, valid, stats, moe_rows)
        ks.append(k)
        vs.append(v)
    last = h[torch.arange(N, device=dev),
             torch.clamp(kv_lens.long() - 1, min=0)]
    return _logits(params, name, last), torch.stack(ks), torch.stack(vs)


def _prefill_into(params, cfg_tuple, cache_k, cache_v, slots, prompts,
                  prompt_lens, block_tables=None, stats=None, moe_rows=None):
    """ONE ``_prefill_forward`` over a group of prompts, each prompt's
    live positions written into its slot's cache row, or through its
    table row into its blocks.  Host arrays: slots [N], prompts [N, P_b]
    (pad past prompt_lens), prompt_lens [N]; block_tables [B, T] int32 on
    the device.  Attention runs on the fresh K/V (flash); an int8 cache
    stores them encoded.  Returns the logits [N, V] f32 after each
    prompt."""
    dev = _kv_payload(cache_k).device
    N, P_b = prompts.shape
    lens = np.asarray(prompt_lens, np.int32)
    logits, ks, vs = _prefill_forward(
        params, cfg_tuple,
        torch.from_numpy(np.asarray(prompts, np.int64)).to(dev),
        torch.from_numpy(lens).to(dev), stats, moe_rows)
    rows, cols = np.nonzero(np.arange(P_b)[None, :] < lens[:, None])
    r, c = (torch.from_numpy(a).to(dev) for a in (rows, cols))
    wa, wo = _kv_index(cache_k, block_tables,
                       torch.from_numpy(np.asarray(slots)[rows]).to(dev), c)
    _kv_write(cache_k, slice(None), (wa, wo), ks[:, r, c])
    _kv_write(cache_v, slice(None), (wa, wo), vs[:, r, c])
    return logits


def _serve_prefill_batch(params, cfg_tuple, cache_k, cache_v, slots,
                         prompts, prompt_lens, temperature, top_k,
                         generators, block_tables=None, stats=None,
                         moe_rows=None):
    """Flash prefill of a group of same-bucket admissions
    (``_prefill_into``; the JAX package's ``_serve_prefill_batch`` and,
    with ``block_tables``, ``_serve_prefill_batch_paged``), then each row
    samples its first token from its own generator.  Host arrays as for
    ``_prefill_into``, plus temperature / top_k [N] and generators (None
    for greedy).  The group needs no pad rows: torch compiles no shape
    ladder, so nothing writes a position twice nor routes one.  The
    JAX package's pad rows do count in its MoE capacity: the engine
    passes that padded count as ``moe_rows`` (nb x P_b).  Returns first
    tokens [N] int64 numpy."""
    logits = _prefill_into(params, cfg_tuple, cache_k, cache_v, slots,
                           prompts, prompt_lens, block_tables, stats,
                           moe_rows)
    return _sample_slots(logits, temperature, top_k, generators)


def _serve_decode_step(params, cfg_tuple, cache_k, cache_v, pos, token,
                       live, temperature, top_k, generators,
                       block_tables=None, stats=None):
    """One decode wave over all slots plus per-slot sampling (the JAX
    package's ``_serve_decode_step`` and, with ``block_tables``,
    ``_serve_decode_paged``): slot b consumes ``token[b]`` at ``pos[b]``
    when ``live[b]`` and draws its next token from its own generator,
    once; the other slots ride along inert (see ``_decode_step``).
    Device tensors: pos [B] int32, token [B] int64, block_tables; host
    arrays: live [B] bool, temperature, top_k, generators.  Returns
    sampled [B] int64 numpy (meaningful for live slots)."""
    logits = _decode_step(
        params, cfg_tuple, cache_k, cache_v, pos, token,
        block_tables=block_tables,
        live_mask=torch.from_numpy(np.asarray(live, bool)).to(pos.device),
        stats=stats)
    return _sample_slots(logits, temperature, top_k, generators, live)


def _serve_prefill_chunk(params, cfg_tuple, cache_k, cache_v, table_row,
                         tokens, pos_off, sample=None, stats=None,
                         moe_rows=None):
    """One CHUNK of one slot's prompt into its blocks: ``tokens`` [C]
    int64 at positions ``pos_off .. pos_off+C-1``, attending to the
    slot's earlier positions and causally to itself.  This is both the
    chunked prefill (a long prompt fills its blocks one chunk per step)
    and the prefix-tail pass (a prompt whose first ``pos_off`` positions
    came from shared blocks forwards only the rest).

    The JAX package computes it with a masked einsum over the gathered
    context plus the chunk's FRESH K/V.  Here each layer writes the
    chunk's K/V into its blocks first and attends through
    ``ragged_paged_attention`` as one slot (q_lens [C], lengths
    [pos_off + C], the table row): the same numbers over a pool of the
    compute dtype (f32 or bf16), whose K/V read back equal the fresh
    ones.  An int8 pool reads the chunk's K/V back quantized, as the
    JAX mixed step's kernel path does (``_mixed_step(attn="ragged")``):
    a difference by design from the JAX chunk pass, within the
    quantization error (ROADMAP Queue C).  table_row: [T] int32 on the
    device.

    ``sample`` is ``(temperature, top_k, generator)`` on the FINAL chunk,
    None on a mid-prompt one, which draws nothing: a request's generator
    is drawn once for its first token, as in the other paths.  Returns
    (first token int or None, logits [V] f32 after the chunk's last
    position).  ``moe_rows``: the position count that sets MoE capacity
    (default C; the engine passes the JAX package's chunk bucket C_b,
    since that engine pads the chunk to it)."""
    name, L, H, Dh = cfg_tuple[:4]
    moe = _moe_of(cfg_tuple)
    C = tokens.shape[0]
    dev = tokens.device
    posns = int(pos_off) + torch.arange(C, device=dev)
    h = params[f"{name}_wte_table"][tokens] + params[f"{name}_wpe"][posns]
    tables = table_row[None]
    lens = torch.tensor([int(pos_off) + C], dtype=torch.int32, device=dev)
    q_len = torch.tensor([C], dtype=torch.int32, device=dev)
    wa, wo = _kv_index(cache_k, tables, torch.zeros_like(posns), posns)
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (1, C, H, Dh))
        _kv_write(cache_k, i, (wa, wo), k[0])
        _kv_write(cache_v, i, (wa, wo), v[0])
        ks, ksc = _kv_layer(cache_k, i)
        vs, vsc = _kv_layer(cache_v, i)
        o = ragged_paged_attention(q, ks, vs, lens, q_len, tables,
                                   k_scale=ksc, v_scale=vsc)
        o = o.reshape(C, H * Dh) @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o, i, moe, stats=stats,
                       moe_rows=moe_rows)
    logits = _logits(params, name, h[C - 1])
    if sample is None:
        return None, logits
    temperature, top_k, generator = sample
    return _sample_slot(logits, float(temperature), int(top_k),
                        generator), logits


def _mixed_step(params, cfg_tuple, cache_k, cache_v, pos, tokens, q_len,
                block_tables=None, verify=False, stats=None):
    """One MIXED wave: slot b consumes ``tokens[b, :q_len[b]]`` at
    positions ``pos[b] .. pos[b]+q_len[b]-1`` — a prompt, a prompt chunk,
    one decode token or a verify block, all in one call.  Returns logits
    [B, Q, V] f32; row ``[b, j]`` is the next-token distribution after
    input j.  A slot with q_len 0 rides along inert: length 0, no write,
    its rows discarded.

    The cache is the contiguous ``[L, B, S_max, H, Dh]`` pair, or with
    ``block_tables`` [B, T] int32 the block-table pool ``[L, N_blocks,
    bs, H, Dh]``, either of them possibly the int8 (payload, scales)
    pair.  Each layer writes the live (slot, row) pairs' K/V IN
    PLACE (the JAX package donates the cache) and hands the wave to
    ``ragged_attention`` or ``ragged_paged_attention`` — with ``verify``
    the verify kernels ``paged_verify_attention`` or
    ``paged_block_verify_attention`` (``_verify_step``) — which read
    everything back.  Only live rows write: the JAX package also
    scatters dead rows, at clipped positions in an order that lets the
    live row win, or into scratch block 0; an unordered CUDA scatter
    has no such order, and nothing reads those writes.  Only live rows
    route through an MoE block.  pos/q_len [B] int32, tokens [B, Q]
    int64, all on the params' device."""
    name, L, H, Dh = cfg_tuple[:4]
    moe = _moe_of(cfg_tuple)
    B, Q = tokens.shape
    hdim = H * Dh
    dev = tokens.device
    posns = pos.long()[:, None] + torch.arange(Q, device=dev)[None, :]
    valid = torch.arange(Q, device=dev)[None, :] < q_len[:, None]
    # filled after the writes; 0 for an inert slot
    lens = torch.where(q_len > 0, pos + q_len, 0).to(torch.int32)
    wpe = params[f"{name}_wpe"]
    h = params[f"{name}_wte_table"][tokens] \
        + wpe[torch.clamp(posns, 0, wpe.shape[0] - 1)]           # [B,Q,hd]
    wb, wj = valid.nonzero(as_tuple=True)
    wa, wo = _kv_index(cache_k, block_tables, wb, posns[wb, wj])
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (B, Q, H, Dh))
        _kv_write(cache_k, i, (wa, wo), k[wb, wj])
        _kv_write(cache_v, i, (wa, wo), v[wb, wj])
        ks, ksc = _kv_layer(cache_k, i)
        vs, vsc = _kv_layer(cache_v, i)
        sc = dict(k_scale=ksc, v_scale=vsc)
        if verify and block_tables is None:
            o = paged_verify_attention(q, ks, vs, lens, q_len, **sc)
        elif verify:
            o = paged_block_verify_attention(q, ks, vs, lens, q_len,
                                             block_tables, **sc)
        elif block_tables is None:
            o = ragged_attention(q, ks, vs, lens, q_len, **sc)
        else:
            o = ragged_paged_attention(q, ks, vs, lens, q_len, block_tables,
                                       **sc)
        o = o.reshape(B, Q, hdim) @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o, i, moe, valid, stats)
    return _logits(params, name, h)


def _verify_step(params, cfg_tuple, cache_k, cache_v, pos, tokens, q_len,
                 block_tables=None, stats=None):
    """Multi-position verify (the JAX package's ``_verify_step``): slot b
    consumes ``tokens[b, :q_len[b]]`` at ``pos[b] ..`` in ONE step, row
    ``[b, j]`` of the logits [B, Q, V] f32 being what ``j + 1``
    sequential ``_decode_step`` calls give (within a tolerance: the
    kernels sum in another order).  ``_mixed_step``'s body on the verify
    kernels: a slot with q_len 0 (free, mid-prefill, or a finished
    offline row) writes nothing and attends nothing."""
    return _mixed_step(params, cfg_tuple, cache_k, cache_v, pos, tokens,
                       q_len, block_tables, verify=True, stats=stats)


def _serve_mixed(params, cfg_tuple, cache_k, cache_v, pos, tokens, q_len,
                 first_row, temperature, top_k, generators,
                 block_tables=None, stats=None):
    """One fused MIXED wave plus each slot's sampling window (the JAX
    package's ``_serve_mixed`` and, with ``block_tables``,
    ``_serve_mixed_paged``).  Device tensors: pos, tokens, q_len,
    block_tables; host arrays: first_row, temperature, top_k, and the
    per-slot generators (None for a free or greedy slot).  Returns
    ``_spec_sample``'s (sampled [B, Q] int64 numpy, generator states);
    the host reads each slot's window and discards the rest."""
    logits = _mixed_step(params, cfg_tuple, cache_k, cache_v, pos, tokens,
                         q_len, block_tables, stats=stats)
    return _spec_sample(logits, temperature, top_k, generators,
                        first_row, q_len.cpu().numpy())


def _serve_verify(params, cfg_tuple, cache_k, cache_v, pos, tokens, q_len,
                  temperature, top_k, generators, block_tables=None,
                  stats=None):
    """One VERIFY wave over all slots plus sampling at every live row (the
    JAX package's ``_serve_verify`` and, with ``block_tables``,
    ``_serve_verify_paged``).  Device tensors: pos [B] int32, tokens [B,
    Q] int64, block_tables; host arrays: q_len [B], temperature, top_k,
    generators.  Returns ``_spec_sample``'s (sampled [B, Q], states)."""
    q_len = np.asarray(q_len, np.int32)
    logits = _verify_step(params, cfg_tuple, cache_k, cache_v, pos, tokens,
                          torch.from_numpy(q_len).to(pos.device),
                          block_tables, stats)
    return _spec_sample(logits, temperature, top_k, generators,
                        np.zeros_like(q_len), q_len)


def _spec_propose(params, cfg_tuple, cache_k, cache_v, pos, token, k, live):
    """``k`` greedy draft tokens per slot: ``k + 1`` ``_decode_step``
    calls of the truncated-layer draft (``cfg_tuple``'s depth) over its
    own contiguous cache, each feeding its argmax forward on the device
    and one host copy at the end.  The last step exists only to write the
    k-th draft token's K/V (after a fully accepted wave the draft's
    history has no hole); its proposal is discarded.  pos [B] int32 /
    token [B] int64 device tensors; live [B] bool host array, the
    decoding slots: the others (free, mid-prefill, finished) write
    nothing, nor does a step past the cache's last position.  The draft's
    cache is never quantized, whatever the target's (the JAX engine's
    rule).  Returns draft tokens [B, k] int64 numpy."""
    assert not _kv_q(cache_k), "the draft's cache is never quantized"
    S = cache_k.shape[2]
    dev = pos.device
    live = torch.from_numpy(np.asarray(live, bool)).to(dev)
    p = pos.long()
    tok = token
    toks = []
    for i in range(k + 1):
        pi = p + i
        logits = _decode_step(params, cfg_tuple, cache_k, cache_v,
                              torch.clamp(pi, max=S - 1), tok,
                              live_mask=live & (pi < S))
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks[:k], 1).cpu().numpy()


def _accept_span(sampled, tokens, q_len, eos_id):
    """Longest-prefix acceptance of one slot's verify block: ``tokens``
    the block fed (the carried token, then the draft), ``sampled`` the
    target's token after each row.  Draft j + 1 is accepted while it
    equals sampled j; the target's token at the first mismatch is the
    bonus.  An EOS in the span cuts it there.  Returns (emitted tokens,
    accepted draft count)."""
    a = 0
    while a < q_len - 1 and sampled[a] == tokens[a + 1]:
        a += 1
    emit = [int(t) for t in sampled[:a + 1]]
    if eos_id is not None and eos_id in emit:
        emit = emit[:emit.index(eos_id) + 1]
    return emit, min(a, len(emit))


def _infer_name(params, name=None):
    """The model's parameter-name prefix; explicit ``name`` wins, else
    inferred when exactly one ``*_wte_table`` is present."""
    if name is not None:
        return name
    tables = [k[:-len("_wte_table")] for k in params
              if k.endswith("_wte_table")]
    if len(tables) != 1:
        raise ValueError(
            f"params hold {len(tables)} *_wte_table entries ({tables}); "
            f"pass name= to pick the model")
    return tables[0]


def _model_params(params, name, device, dtype):
    return {k: prep_param(v, device, dtype) for k, v in params.items()
            if k.startswith(name + "_")}


def teacher_forced_logits(params, config, seq, kv_fake_quant=False,
                          name=None, dtype=None, device=None):
    """Per-position next-token logits [P, V] f32 of ONE sequence ``seq``
    under teacher forcing (the JAX package's ``teacher_forced_logits``),
    attending through the flash kernel (its plain version on the CPU);
    with ``kv_fake_quant`` every layer's K/V pass through
    ``kv_decode(kv_encode(.))`` first.

    Storing K/V as int8 and dequantizing inside the attention kernels is
    arithmetically the fake-quantized K/V here, so this is the margin
    gate's oracle for ``kv_quant="int8"``: with ``delta`` the largest
    |fake-quant - exact| logit gap over a sequence, a position whose
    exact top-2 margin exceeds ``2 * delta`` keeps its top-1 token under
    int8 KV.  An MoE config routes every position of ``seq`` as one
    block.  device: CUDA unless ``"cpu"`` is passed."""
    dev = resolve_device(device)
    moe = moe_spec_of(config)
    name = _infer_name(params, name)
    params = _model_params(params, name, dev, dtype)
    c = config
    L, H = c.num_hidden_layers, c.num_attention_heads
    Dh = c.hidden_size // H
    seq = torch.as_tensor(np.asarray(seq, np.int64), device=dev)
    P = seq.shape[0]
    h = params[f"{name}_wte_table"][seq] + params[f"{name}_wpe"][:P]
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (1, P, H, Dh))
        if kv_fake_quant:
            k = kv_decode(*kv_encode(k)).to(k.dtype)
            v = kv_decode(*kv_encode(v)).to(v.dtype)
        o = flash_attention(q, k, v, causal=True)
        o = o.reshape(P, H * Dh) @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o, i, moe)
    return _logits(params, name, h)


def _generate_spec(params, cfg_tuple, draft_layers, prompts, num_tokens,
                   temperature, top_k, seed, eos_id, pad_id, spec_k, dev):
    """Offline speculative generation (the JAX package's
    ``_generate_spec``): flash prefill of the target and of the draft's
    own cache, then propose (``_spec_propose``, K4) and verify
    (``_serve_verify``, K6) in lockstep over the whole batch; rows whose
    acceptance differs sit at different positions, and finished rows ride
    along with q_len 0.  Greedy outputs equal the non-speculative
    ``generate_fast``'s; sampling draws one generator per row seeded
    ``seed + row``, so sampled rows equal the serving engine's requests
    seeded alike, not the batch-seeded offline path.  An MoE draft routes
    nothing (``_draft_cfg``)."""
    name, L, H, Dh, S_max = cfg_tuple[:5]
    cfg_d = _draft_cfg(cfg_tuple, draft_layers)
    B, P = prompts.shape
    Q = spec_k + 1
    cdtype = params[f"{name}_wte_table"].dtype
    ck = torch.zeros((L, B, S_max, H, Dh), dtype=cdtype, device=dev)
    cv = torch.zeros_like(ck)
    dck = torch.zeros((draft_layers, B, S_max, H, Dh), dtype=cdtype,
                      device=dev)
    dcv = torch.zeros_like(dck)
    P_b = min(_pow2(P, floor=8), S_max)
    padb = np.zeros((B, P_b), np.int64)
    padb[:, :P] = prompts
    slots = np.arange(B)
    lens = np.full(B, P, np.int32)
    temps = np.full(B, temperature, np.float32)
    topks = np.full(B, top_k, np.int32)
    gens = [None] * B
    if temperature > 0:
        for r in range(B):
            gens[r] = torch.Generator(device=dev)
            gens[r].manual_seed(int(seed) + r)
    first = _serve_prefill_batch(params, cfg_tuple, ck, cv, slots, padb,
                                 lens, temps, topks, gens)
    _prefill_into(params, cfg_d, dck, dcv, slots, padb, lens)
    pos = np.full(B, P, np.int32)
    tok = first.astype(np.int64)
    total = P + int(num_tokens)
    out = np.full((B, total), pad_id, np.int64)
    out[:, :P] = prompts
    out[:, P] = first
    emitted = np.ones(B, np.int32)
    done = emitted >= num_tokens
    if eos_id is not None:
        done |= first == eos_id
    while not done.all():
        pos_d = torch.from_numpy(pos).to(dev)
        draft = _spec_propose(params, cfg_d, dck, dcv, pos_d,
                              torch.from_numpy(tok).to(dev), spec_k, ~done)
        tokens = np.concatenate([tok[:, None], draft], 1)
        qlen = np.where(done, 0, np.minimum(Q, num_tokens - emitted))
        tgt, after = _serve_verify(params, cfg_tuple, ck, cv, pos_d,
                                   torch.from_numpy(tokens).to(dev), qlen,
                                   temps, topks, gens)
        for b in np.flatnonzero(~done):
            emit, _ = _accept_span(tgt[b], tokens[b], int(qlen[b]), eos_id)
            n = len(emit)
            out[b, P + emitted[b]:P + emitted[b] + n] = emit
            emitted[b] += n
            pos[b] += n
            tok[b] = emit[-1]
            if after[b] is not None:
                gens[b].set_state(after[b][n - 1])
            if emitted[b] >= num_tokens or \
                    (eos_id is not None and emit[-1] == eos_id):
                done[b] = True
    return out.astype(np.int32)


def generate_fast(params, config, prompts, num_tokens, temperature=0.0,
                  top_k=0, seed=0, name=None, dtype=None, eos_id=None,
                  pad_id=0, spec=None, spec_draft_layers=None,
                  device=None):
    """KV-cached generation: the prompt runs as ONE batched pass through
    the flash kernel (pow2-bucketed prompt length), then one position at
    a time over the contiguous cache through the decode kernel.  The JAX
    package's scan prefill (``prefill="scan"``) has no counterpart here;
    its greedy tokens are the same.

    params: {name: array or tensor} (the JAX package's named params);
    config: GPTConfig or ``MoEDecodeConfig``; prompts: a [B, P] array or list of equal-length
    token lists; dtype: e.g. ``torch.bfloat16`` casts weights AND cache,
    default FOLLOWS the params; eos_id: a row that samples it past its
    prompt emits it, then ``pad_id``.  Sampling draws from one
    ``torch.Generator`` seeded with ``seed``.  device: CUDA unless
    ``"cpu"`` is passed.  spec: > 0 (default ``$HETU_SPEC_K``) decodes
    speculatively (``_generate_spec``): a draft of ``spec_draft_layers``
    of the model's own blocks (``resolve_draft_layers``) proposes
    ``spec`` tokens per wave through the decode kernel and the verify
    kernel scores them in one step; greedy outputs are the same, sampled
    ones draw one generator per row (``seed + row``), as the engine's
    requests do.  Returns [B, P + num_tokens] numpy int32."""
    dev = resolve_device(device)
    prompts = np.asarray(prompts, np.int64)
    if prompts.ndim == 1:
        prompts = prompts[None]
    B, P = prompts.shape
    if P < 1:
        raise ValueError("prompt must hold at least one token")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    total = P + int(num_tokens)
    c = config
    name = _infer_name(params, name)
    S_max = c.max_position_embeddings
    if total > S_max:
        raise ValueError(f"prompt + num_tokens = {total} exceeds "
                         f"max_position_embeddings {S_max}")
    L, H = c.num_hidden_layers, c.num_attention_heads
    Dh = c.hidden_size // H
    cfg_tuple = (name, L, H, Dh, S_max)
    moe = moe_spec_of(c)
    if moe is not None:
        cfg_tuple += (moe,)
    params = _model_params(params, name, dev, dtype)
    spec_k = resolve_spec_k(spec)
    if spec_k:
        return _generate_spec(
            params, cfg_tuple, resolve_draft_layers(spec_draft_layers, L),
            prompts, int(num_tokens), float(temperature), int(top_k),
            int(seed), eos_id, int(pad_id), spec_k, dev)
    cdtype = params[f"{name}_wte_table"].dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    use_eos = eos_id is not None
    cache_k = torch.zeros((L, B, S_max, H, Dh), dtype=cdtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    out = torch.full((B, total), int(pad_id), dtype=torch.int64, device=dev)
    out[:, :P] = torch.from_numpy(prompts).to(dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    def emit(t, logits):
        # the token at position t + 1 from the logits after input t
        nonlocal done
        sampled = _sample(logits, temperature, top_k, gen)
        out[:, t + 1] = torch.where(done, int(pad_id), sampled)
        if use_eos:
            done = done | (sampled == int(eos_id))

    P_b = min(_pow2(P, floor=8), S_max)
    padb = torch.zeros((B, P_b), dtype=torch.int64, device=dev)
    padb[:, :P] = out[:, :P]
    lens = torch.full((B,), P, dtype=torch.int32, device=dev)
    logits, ks, vs = _prefill_forward(params, cfg_tuple, padb, lens)
    cache_k[:, :, :P_b] = ks.to(cdtype)
    cache_v[:, :, :P_b] = vs.to(cdtype)
    emit(P - 1, logits)
    for t in range(P, total - 1):
        if use_eos and bool(done.all()):
            break           # the rest of every row is already pad
        logits = _decode_step(params, cfg_tuple, cache_k, cache_v, t,
                              out[:, t])
        emit(t, logits)
    return out.cpu().numpy().astype(np.int32)
