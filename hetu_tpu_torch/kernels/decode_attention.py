"""One decode query, or one speculative verify q-block, per slot over
the serving engine's KV layouts: the port of the JAX package's Pallas
``paged_decode_attention`` / ``paged_verify_attention`` (the
slot-contiguous cache) and ``paged_block_decode_attention`` /
``paged_block_verify_attention`` (the block-table pool).  The decode
pair serves the phase-split schedulers' decode waves, offline
``generate_fast``'s decode and every draft step of speculation; the
verify pair serves the phase-split verify waves and offline speculative
``generate_fast``.  One dispatch per layer.

Decode: slot b's query attends to its positions ``[0, lengths[b])``,
the position just written included.  Verify: query ``jq`` of slot b sits
at ``lengths[b] - q_lens[b] + jq`` and attends to the positions up to
itself; rows past ``q_lens[b]`` clip to the last live position (their
output is defined and discarded by the caller).  A slot with length 0
returns zeros; the output has q's dtype.  An int8 cache
(``quant.kv_encode``'s payload) passes ``k_scale``/``v_scale``, one f32
scale per (position, head), and launches the int8 twin of its kernel
(K4-int8 to K7-int8, counted under the wrapper's name with ``_int8``).
On CPU tensors the wrappers run their plain versions, the ragged
references (the ``q_len = 1`` case for decode); on CUDA tensors they
launch a kernel, and nothing falls back from one to the other:

- bf16 q, over a bf16 or an int8 cache, all four kernels: the
  tensor-core library ``csrc/decode_attention_bf16.cu``, split-K over
  128-position splits on mma.sync, then a merge (the narrow body of the
  bf16 K1/K8 and their int8 twins, a decode query as its one row);
  16-byte aligned q, caches and scales or a raise.  Over a bf16 cache
  the kernels round P to bf16 before P V, as the Pallas bodies do, and
  the plain versions do not: ``ragged_attention.ragged_rounding_bound``
  bounds the difference, as for the bf16 K1/K8.  Over an int8 cache the
  payload is widened to bf16 exactly and P is not rounded, so they hold
  one bf16 ulp of the Pallas int8 bodies, which compute in f32.
- f32 q, all four over an f32 or an int8 cache (K4-K7, K4-int8 to
  K7-int8): the split-K CUDA-core body of f32 K8/K1's narrow waves
  (``csrc/split_kv_f32.cuh``: ``decode_attention.cu`` for an f32
  cache, ``decode_attention_int8.cu`` for an int8 one, an int8 payload
  dequantized as it is read); 16-byte aligned q, caches and scales or a
  raise.  It limits a decode row and clips a verify row as K1/K8 do, so
  f32 K4 and K6 equal f32 K8 over the same slot rows, and K5 and K7
  equal K1 over the same pool, bit for bit (a decode call as a wave of
  one row, q_len 1).

The verify kernels take q-blocks of at most 16 rows; the wrappers serve
any Q on CUDA by cutting a longer block into groups of 16 rows, one
launch each (see :func:`verify_groups`).
"""

from __future__ import annotations

import torch

from .ragged_attention import (_check_args, _kv, _launch,
                               ragged_masked_reference,
                               ragged_paged_reference)


def masked_decode_reference(q, k, v, lengths, k_scale=None, v_scale=None):
    """Plain version of :func:`paged_decode_attention`: q [B, H, Dh] over
    the slot rows k, v [B, S_max, H, Dh] (int8 with their [B, S_max, H]
    scales, dequantized first).  Returns f32."""
    ones = torch.ones_like(lengths)
    return ragged_masked_reference(q[:, None], k, v, lengths, ones, k_scale,
                                   v_scale)[:, 0]


def paged_block_decode_reference(q, pool_k, pool_v, lengths, block_tables,
                                 k_scale=None, v_scale=None):
    """Plain version of :func:`paged_block_decode_attention`: q [B, H, Dh]
    over the pool through the block tables.  Returns f32."""
    ones = torch.ones_like(lengths)
    return ragged_paged_reference(q[:, None], pool_k, pool_v, lengths, ones,
                                  block_tables, k_scale, v_scale)[:, 0]


def masked_verify_reference(q, k, v, lengths, q_lens, k_scale=None,
                            v_scale=None):
    """Plain version of :func:`paged_verify_attention`: q [B, Q, H, Dh]
    over the slot rows k, v [B, S_max, H, Dh] (a verify wave is a ragged
    wave).  Returns f32."""
    return ragged_masked_reference(q, k, v, lengths, q_lens, k_scale,
                                   v_scale)


def paged_block_verify_reference(q, pool_k, pool_v, lengths, q_lens,
                                 block_tables, k_scale=None, v_scale=None):
    """Plain version of :func:`paged_block_verify_attention`: q [B, Q, H,
    Dh] over the pool through the block tables.  Returns f32."""
    return ragged_paged_reference(q, pool_k, pool_v, lengths, q_lens,
                                  block_tables, k_scale, v_scale)


def _check(kind, q, k, v, lengths, index, k_scale, v_scale):
    """q [B, H, Dh]; the rest as the ragged kernels check it, at Q = 1.
    Returns True for an int8 cache."""
    if q.dim() != 3:
        raise ValueError(f"{kind}: q must be [B, H, Dh], got "
                         f"{tuple(q.shape)}")
    return _check_args(kind, q[:, None], k, v, lengths, lengths, index,
                       k_scale, v_scale)


def paged_decode_attention(q, k, v, lengths, *, k_scale=None, v_scale=None):
    """One decode position per slot over the slot-contiguous cache.

    q: [B, H, Dh]; k, v: [B, S_max, H, Dh] (one layer's cache rows), int8
    with ``k_scale``/``v_scale`` [B, S_max, H] f32 for an int8 cache;
    lengths: [B] int32, the slot's filled count including the position
    just written.  Returns o [B, H, Dh] in q's dtype.  CUDA tensors
    launch the kernel (f32 or bf16 q; caches of q's dtype, or int8 with
    their scales; head dim 32/64/128, contiguous, int32 lengths; the
    split-K kernels in every dtype, on 16-byte aligned q, caches and
    scales); CPU tensors run :func:`masked_decode_reference`."""
    quant = _check("paged_decode_attention", q, k, v, lengths,
                   {"lengths": lengths}, k_scale, v_scale)
    if k.shape[0] != q.shape[0]:
        raise ValueError("paged_decode_attention: k/v must hold one row "
                         "per slot of q")
    if q.device.type == "cpu":
        return masked_decode_reference(q, k, v, lengths, k_scale,
                                       v_scale).to(q.dtype)
    B, H, Dh = q.shape
    S = k.shape[1]
    return _launch("decode_attention", "hetu_paged_decode_attention",
                   "paged_decode_attention", q[:, None],
                   _kv(k, v, k_scale, v_scale, quant), (lengths,),
                   (B, H, Dh, S), span=S)[:, 0]


def paged_block_decode_attention(q, pool_k, pool_v, lengths, block_tables,
                                 *, k_scale=None, v_scale=None):
    """One decode position per slot over the block-table pool.

    q: [B, H, Dh]; pool_k, pool_v: [N_blocks, bs, H, Dh] (one layer),
    int8 with ``k_scale``/``v_scale`` [N_blocks, bs, H] f32 for an int8
    pool; lengths: [B] int32 filled counts (0 = inert slot, zeros out);
    block_tables: [B, T] int32, entry (b, j) the pool block of slot b's
    positions [j*bs, (j+1)*bs); entries past a slot's length may hold any
    valid block (the engine points them at scratch block 0).  Returns o
    [B, H, Dh] in q's dtype.  CUDA tensors launch the kernel (as
    :func:`paged_decode_attention`'s); CPU tensors run
    :func:`paged_block_decode_reference`."""
    quant = _check("paged_block_decode_attention", q, pool_k, pool_v,
                   lengths, {"lengths": lengths,
                             "block_tables": block_tables},
                   k_scale, v_scale)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError("paged_block_decode_attention: block_tables must "
                         "be [B, T]")
    if q.device.type == "cpu":
        return paged_block_decode_reference(q, pool_k, pool_v, lengths,
                                            block_tables, k_scale,
                                            v_scale).to(q.dtype)
    B, H, Dh = q.shape
    bs, T = pool_k.shape[1], block_tables.shape[1]
    return _launch("decode_attention", "hetu_paged_block_decode_attention",
                   "paged_block_decode_attention", q[:, None],
                   _kv(pool_k, pool_v, k_scale, v_scale, quant),
                   (lengths, block_tables), (B, H, Dh, bs, T),
                   span=T * bs)[:, 0]


# the verify kernels' q-block: the split-K bodies' rows, one m16 tile in
# bf16, at most 16 rows in f32 (split_kv_f32.cuh)
_MAX_Q = 16


def verify_groups(q, lengths, q_lens):
    """A verify q-block [B, Q, H, Dh] cut into groups of at most 16 rows,
    as (q_c, lengths_c, q_lens_c) per group: group c of slot b holds
    rows [16c, 16c + n_c), n_c = clamp(q_len - 16c, 0, 16), over its
    lengths - q_len + 16c + n_c filled positions, so each live row sees
    exactly the positions it sees in the whole block.  A group with
    n_c = 0 is inert (length 0, zeros out) and reads nothing; a dead row
    of a live group clips to the slot's last live position as before."""
    out = []
    for c0 in range(0, q.shape[1], _MAX_Q):
        n = (q_lens - c0).clamp(0, _MAX_Q)
        lens = torch.where(n > 0, lengths - q_lens + c0 + n, 0)
        out.append((q[:, c0:c0 + _MAX_Q].contiguous(),
                    lens.to(lengths.dtype), n.to(q_lens.dtype)))
    return out


def _verify(q, lengths, q_lens, run):
    """``run(q, lengths, q_lens)`` on the whole block when it fits the
    kernel, else on each of :func:`verify_groups`, the outputs joined."""
    if q.shape[1] <= _MAX_Q:
        return run(q, lengths, q_lens)
    return torch.cat([run(*g) for g in verify_groups(q, lengths, q_lens)],
                     dim=1)


def paged_verify_attention(q, k, v, lengths, q_lens, *, k_scale=None,
                           v_scale=None):
    """One verify q-block per slot over the slot-contiguous cache.

    q: [B, Q, H, Dh], the carried token and the draft's proposals, whose
    K/V the caller has written; k, v: [B, S_max, H, Dh] (one layer's
    cache rows), int8 with ``k_scale``/``v_scale`` [B, S_max, H] f32 for
    an int8 cache; lengths: [B] int32, the filled count INCLUDING the
    q-block's live positions (0 = inert slot, zeros out); q_lens: [B]
    int32 live queries per slot.  Returns o [B, Q, H, Dh] in q's dtype.
    CUDA tensors launch the kernel (f32 or bf16 q; caches of q's dtype,
    or int8 with their scales; head dim 32/64/128, contiguous, int32
    lengths; the split-K kernels in every dtype, on 16-byte aligned q,
    caches and scales; a block of more than 16 rows launches it once per
    group of :func:`verify_groups`, whose dead groups give zeros); CPU
    tensors run :func:`masked_verify_reference`."""
    quant = _check_args("paged_verify_attention", q, k, v, lengths,
                        q_lens, {"lengths": lengths, "q_lens": q_lens},
                        k_scale, v_scale)
    if k.shape[0] != q.shape[0]:
        raise ValueError("paged_verify_attention: k/v must hold one row "
                         "per slot of q")
    if q.device.type == "cpu":
        return masked_verify_reference(q, k, v, lengths, q_lens, k_scale,
                                       v_scale).to(q.dtype)
    kv = _kv(k, v, k_scale, v_scale, quant)
    return _verify(q, lengths, q_lens, lambda qc, lc, nc: _launch(
        "decode_attention", "hetu_paged_verify_attention",
        "paged_verify_attention", qc, kv, (lc, nc),
        (*qc.shape, k.shape[1]), span=k.shape[1]))


def paged_block_verify_attention(q, pool_k, pool_v, lengths, q_lens,
                                 block_tables, *, k_scale=None,
                                 v_scale=None):
    """One verify q-block per slot over the block-table pool.

    q: [B, Q, H, Dh]; pool_k, pool_v: [N_blocks, bs, H, Dh] (one layer),
    int8 with ``k_scale``/``v_scale`` [N_blocks, bs, H] f32 for an int8
    pool; lengths / q_lens: [B] int32 as in
    :func:`paged_verify_attention`; block_tables: [B, T] int32 as in
    :func:`paged_block_decode_attention`.  Returns o [B, Q, H, Dh] in q's
    dtype.  CUDA tensors launch the kernel (as
    :func:`paged_verify_attention`'s, per group of :func:`verify_groups`
    past 16 rows, on 16-byte aligned q, pools and scales); CPU tensors
    run :func:`paged_block_verify_reference`."""
    quant = _check_args("paged_block_verify_attention", q, pool_k, pool_v,
                        lengths, q_lens,
                        {"lengths": lengths, "q_lens": q_lens,
                         "block_tables": block_tables}, k_scale, v_scale)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError("paged_block_verify_attention: block_tables must "
                         "be [B, T]")
    if q.device.type == "cpu":
        return paged_block_verify_reference(q, pool_k, pool_v, lengths,
                                            q_lens, block_tables, k_scale,
                                            v_scale).to(q.dtype)
    kv = _kv(pool_k, pool_v, k_scale, v_scale, quant)
    return _verify(q, lengths, q_lens, lambda qc, lc, nc: _launch(
        "decode_attention", "hetu_paged_block_verify_attention",
        "paged_block_verify_attention", qc, kv, (lc, nc, block_tables),
        (*qc.shape, pool_k.shape[1], block_tables.shape[1]),
        span=pool_k.shape[1] * block_tables.shape[1]))
