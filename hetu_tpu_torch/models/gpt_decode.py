"""KV-cached GPT decoding in PyTorch: the port of the JAX package's
``models/gpt_decode.py`` for dense GPT models.

Weights come as the named-parameter dict of the JAX package (the
executor / HF-importer contract, ``<name>_wte_table``,
``<name>_h<i>_attn_q_weight``, ...), turned into tensors by
``weights.params_from_numpy``:

    out = generate_fast(params, cfg, prompts, num_tokens=50,
                        temperature=0.8, top_k=40, seed=0)

Two cores serve two callers:

- ``_prefill_forward`` + ``_decode_step`` drive offline ``generate_fast``:
  one batched full-prompt pass through the flash kernel, then one
  position at a time over a contiguous ``[L, B, S_max, H, Dh]`` cache.
- ``_mixed_step`` is the serving engine's ONE core per scheduler step:
  every slot's ragged q-block (prompt chunk or decode token) is written
  into the block-table pool and attended by the ragged paged kernel.

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
from ..kernels.flash_attention import flash_attention
from ..kernels.ragged_attention import ragged_paged_attention
from ..weights import prep_param

NEG_INF = -1e30


def _pow2(n, floor=1):
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def resolve_serve_ragged(mode=None):
    """Mixed-mode ragged dispatch selection: an explicit argument wins;
    else ``$HETU_SERVE_RAGGED``; else auto — mixed when
    ``torch.cuda.is_available()``.  The port runs only the mixed
    scheduler so far; the engine refuses False (ROADMAP A4)."""
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


def _ffn_block(params, us, h):
    """LN2 then the dense wi -> gelu -> wo FFN, residual added.  The MoE
    branch is ROADMAP A6."""
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


def _decode_step(params, cfg_tuple, cache_k, cache_v, pos, token):
    """One position for the whole batch: ``token`` [B] at scalar
    position ``pos`` over the contiguous ``[L, B, S_max, H, Dh]`` cache
    pair.  Writes this position's K/V in place (the JAX package donates
    the cache to a dynamic_update_slice here) and returns logits [B, V]
    f32.  Attention reads positions [0, pos] — the masked path's live
    span; the masked-out tail contributes exactly zero there."""
    name, L, H, Dh = cfg_tuple[:4]
    B = token.shape[0]
    hdim = H * Dh
    h = params[f"{name}_wte_table"][token] + params[f"{name}_wpe"][pos]
    scale = Dh ** -0.5
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (B, H, Dh))
        # in place: the cache is donated in the JAX package
        cache_k[i, :, pos] = k.to(cache_k.dtype)
        cache_v[i, :, pos] = v.to(cache_v.dtype)
        ks = cache_k[i, :, :pos + 1]
        vs = cache_v[i, :, :pos + 1]
        s = torch.einsum("bhd,bshd->bhs", q, ks) * scale
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bshd->bhd", p, vs).reshape(B, hdim)
        o = o @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o)
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
    """Per-slot sampling over a mixed wave's logits [B, Q, V]: slot b
    draws from its generator only at rows ``first_row[b] <= j <
    q_len[b]`` — row 0 of a decode slot, the last row of a prompt's
    FINAL chunk, none for a mid-prompt chunk — so a request's stream is
    consumed exactly once per emitted token whatever the wave around it.
    Other rows (and greedy slots) get the argmax.  Returns [B, Q] int64
    numpy."""
    toks = torch.argmax(logits, dim=-1).cpu().numpy()
    for b, gen in enumerate(generators):
        if gen is None or temperature[b] <= 0.0:
            continue
        for j in range(int(first_row[b]), int(q_len[b])):
            toks[b, j] = _sample_slot(logits[b, j], float(temperature[b]),
                                      int(top_k[b]), gen)
    return toks


def _prefill_forward(params, cfg_tuple, tokens, kv_lens):
    """ONE full-prompt forward over a bucket-padded token block: every
    layer's K/V for all positions in one batched pass, attention through
    the flash kernel (causal + kv_lens).  tokens [N, P_b] (positions >=
    kv_lens[n] are pad); kv_lens [N] int32.  Returns (logits [N, V] f32
    at each row's kv_lens-1, ks, vs [L, N, P_b, H, Dh])."""
    name, L, H, Dh = cfg_tuple[:4]
    N, P_b = tokens.shape
    hdim = H * Dh
    dev = tokens.device
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
        h = _ffn_block(params, us, h + o)
        ks.append(k)
        vs.append(v)
    last = h[torch.arange(N, device=dev),
             torch.clamp(kv_lens.long() - 1, min=0)]
    return _logits(params, name, last), torch.stack(ks), torch.stack(vs)


def _mixed_step(params, cfg_tuple, cache_k, cache_v, pos, tokens, q_len,
                block_tables):
    """One MIXED wave over the block-table pool ``[L, N_blocks, bs, H,
    Dh]``: slot b consumes ``tokens[b, :q_len[b]]`` at positions
    ``pos[b] .. pos[b]+q_len[b]-1`` — a prompt chunk or one decode token,
    all in one call.  Returns logits [B, Q, V] f32; row ``[b, j]`` is the
    next-token distribution after input j.

    Each layer writes the q-block's K/V into the pool IN PLACE (the JAX
    package donates the pool) — dead rows and dead slots (``q_len`` 0)
    write scratch block 0 — and then hands the wave to
    ``ragged_paged_attention``, which reads everything back from the
    pool.  This is the only attention path: the JAX package's masked
    gather (``fast_path=False``) has no counterpart here, since the
    kernel's plain version already serves CPU tensors.  pos/q_len [B]
    int32, tokens [B, Q] int64, block_tables [B, T] int32, all on the
    params' device."""
    name, L, H, Dh, S_max = cfg_tuple[:5]
    B, Q = tokens.shape
    hdim = H * Dh
    dev = tokens.device
    posns = pos.long()[:, None] + torch.arange(Q, device=dev)[None, :]
    valid = torch.arange(Q, device=dev)[None, :] < q_len[:, None]
    lens = (pos + q_len).to(torch.int32)      # filled after the writes
    wpe = params[f"{name}_wpe"]
    h = params[f"{name}_wte_table"][tokens] \
        + wpe[torch.clamp(posns, 0, wpe.shape[0] - 1)]           # [B,Q,hd]
    bs = cache_k.shape[2]
    posc = torch.clamp(posns, 0, S_max - 1)
    wblk = torch.where(
        valid, torch.gather(block_tables.long(), 1, posc // bs), 0)
    woff = posc % bs
    for i in range(L):
        us = f"{name}_h{i}"
        x = _ln(h, params[f"{us}_ln1_scale"], params[f"{us}_ln1_bias"])
        q, k, v = _qkv(params, us, x, (B, Q, H, Dh))
        # in place: the pool is the engine's whole KV memory, donated
        # to the step in the JAX package
        ks, vs = cache_k[i], cache_v[i]
        ks[wblk, woff] = k.to(ks.dtype)
        vs[wblk, woff] = v.to(vs.dtype)
        o = ragged_paged_attention(q, ks, vs, lens, q_len, block_tables)
        o = o.reshape(B, Q, hdim) @ params[f"{us}_attn_proj_weight"] \
            + params[f"{us}_attn_proj_bias"]
        h = _ffn_block(params, us, h + o)
    return _logits(params, name, h)


def _serve_mixed_paged(params, cfg_tuple, cache_k, cache_v, tables, pos,
                       tokens, q_len, first_row, temperature, top_k,
                       generators):
    """One fused MIXED wave over the paged pool plus each slot's
    sampling window.  Device tensors: tables, pos, tokens, q_len; host
    arrays: first_row, temperature, top_k, and the per-slot generators
    (None for a free slot).  Returns sampled [B, Q] int64 numpy; the
    host reads each slot's window and discards the rest."""
    logits = _mixed_step(params, cfg_tuple, cache_k, cache_v, pos, tokens,
                         q_len, tables)
    return _spec_sample(logits, temperature, top_k, generators,
                        first_row, q_len.cpu().numpy())


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


def refuse_moe(config):
    """MoE configs ride the dense cores only in the JAX package so far
    (ROADMAP A6)."""
    if getattr(config, "num_experts", None):
        raise NotImplementedError(
            "MoE decoding is not ported yet (ROADMAP A6)")


def generate_fast(params, config, prompts, num_tokens, temperature=0.0,
                  top_k=0, seed=0, name=None, dtype=None, eos_id=None,
                  pad_id=0, spec=None, device=None):
    """KV-cached generation: the prompt runs as ONE batched pass through
    the flash kernel (pow2-bucketed prompt length), then one position at
    a time over the contiguous cache.  The JAX package's scan prefill
    (``prefill="scan"``) has no counterpart here; its greedy tokens are
    the same.

    params: {name: array or tensor} (the JAX package's named params);
    config: GPTConfig; prompts: a [B, P] array or list of equal-length
    token lists; dtype: e.g. ``torch.bfloat16`` casts weights AND cache,
    default FOLLOWS the params; eos_id: a row that samples it past its
    prompt emits it, then ``pad_id``.  Sampling draws from one
    ``torch.Generator`` seeded with ``seed``.  device: CUDA unless
    ``"cpu"`` is passed.  ``spec > 0`` (speculative decoding) is
    ROADMAP A5.  Returns [B, P + num_tokens] numpy int32."""
    dev = resolve_device(device)
    if resolve_spec_k(spec):
        raise NotImplementedError(
            "speculative decoding is not ported yet (ROADMAP A5)")
    refuse_moe(config)
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
    params = _model_params(params, name, dev, dtype)
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
