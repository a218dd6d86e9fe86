"""One decode query per slot over the serving engine's KV layouts, the
port of the JAX package's Pallas ``paged_decode_attention`` (the
slot-contiguous cache) and ``paged_block_decode_attention`` (the
block-table pool): the phase-split schedulers' decode wave and offline
``generate_fast``'s decode, one dispatch per layer.

Slot b's query attends to its positions ``[0, lengths[b])``, the
position just written included; a slot with length 0 returns zeros; the
output has q's dtype.  Both launch ``csrc/decode_attention.cu`` on CUDA
tensors and run their plain versions, the ``q_len = 1`` case of the
ragged references, on CPU tensors; nothing falls back from one to the
other.  The int8 twins (``k_scale``/``v_scale``) are ROADMAP's int8
slice.
"""

from __future__ import annotations

import torch

from .ragged_attention import (_check_args, _launch, _refuse_int8,
                               ragged_masked_reference,
                               ragged_paged_reference)


def masked_decode_reference(q, k, v, lengths):
    """Plain version of :func:`paged_decode_attention`: q [B, H, Dh] over
    the slot rows k, v [B, S_max, H, Dh].  Returns f32."""
    ones = torch.ones_like(lengths)
    return ragged_masked_reference(q[:, None], k, v, lengths, ones)[:, 0]


def paged_block_decode_reference(q, pool_k, pool_v, lengths, block_tables):
    """Plain version of :func:`paged_block_decode_attention`: q [B, H, Dh]
    over the pool through the block tables.  Returns f32."""
    ones = torch.ones_like(lengths)
    return ragged_paged_reference(q[:, None], pool_k, pool_v, lengths, ones,
                                  block_tables)[:, 0]


def _check(kind, q, k, v, lengths, index):
    """q [B, H, Dh]; the rest as the ragged kernels check it, at Q = 1."""
    if q.dim() != 3:
        raise ValueError(f"{kind}: q must be [B, H, Dh], got "
                         f"{tuple(q.shape)}")
    _check_args(kind, q[:, None], k, v, lengths, lengths, index)


def paged_decode_attention(q, k, v, lengths, *, k_scale=None, v_scale=None):
    """One decode position per slot over the slot-contiguous cache.

    q: [B, H, Dh]; k, v: [B, S_max, H, Dh] (one layer's cache rows);
    lengths: [B] int32, the slot's filled count including the position
    just written.  Returns o [B, H, Dh] in q's dtype.  CUDA tensors
    launch the kernel (f32 or bf16, head dim 32/64/128, contiguous,
    int32 lengths); CPU tensors run :func:`masked_decode_reference`."""
    _refuse_int8(k_scale, v_scale)
    _check("paged_decode_attention", q, k, v, lengths,
           {"lengths": lengths})
    if k.shape[0] != q.shape[0]:
        raise ValueError("paged_decode_attention: k/v must hold one row "
                         "per slot of q")
    if q.device.type == "cpu":
        return masked_decode_reference(q, k, v, lengths).to(q.dtype)
    B, H, Dh = q.shape
    return _launch("decode_attention", "hetu_paged_decode_attention",
                   "paged_decode_attention", q, (k, v, lengths),
                   (B, H, Dh, k.shape[1]))


def paged_block_decode_attention(q, pool_k, pool_v, lengths, block_tables,
                                 *, k_scale=None, v_scale=None):
    """One decode position per slot over the block-table pool.

    q: [B, H, Dh]; pool_k, pool_v: [N_blocks, bs, H, Dh] (one layer);
    lengths: [B] int32 filled counts (0 = inert slot, zeros out);
    block_tables: [B, T] int32, entry (b, j) the pool block of slot b's
    positions [j*bs, (j+1)*bs); entries past a slot's length may hold any
    valid block (the engine points them at scratch block 0).  Returns o
    [B, H, Dh] in q's dtype.  CUDA tensors launch the kernel; CPU tensors
    run :func:`paged_block_decode_reference`."""
    _refuse_int8(k_scale, v_scale)
    _check("paged_block_decode_attention", q, pool_k, pool_v, lengths,
           {"lengths": lengths, "block_tables": block_tables})
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError("paged_block_decode_attention: block_tables must "
                         "be [B, T]")
    if q.device.type == "cpu":
        return paged_block_decode_reference(q, pool_k, pool_v, lengths,
                                            block_tables).to(q.dtype)
    B, H, Dh = q.shape
    return _launch("decode_attention", "hetu_paged_block_decode_attention",
                   "paged_block_decode_attention", q,
                   (pool_k, pool_v, lengths, block_tables),
                   (B, H, Dh, pool_k.shape[1], block_tables.shape[1]))
