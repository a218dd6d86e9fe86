"""The mixed-wave ragged attention over the block-table paged pool, the
port of the JAX package's Pallas ``ragged_paged_attention``
(``_ragged_kernel``): the serving engine's one attention dispatch per
layer, whatever mix of prompt chunks and decode tokens a wave carries.

Slot b's query ``jq`` sits at ``lengths[b] - q_lens[b] + jq`` and sees
pool positions up to itself through its block-table row; rows past
``q_lens[b]`` clip to the last live position (their output is defined
and discarded by the caller); a slot with length 0 returns zeros; the
output has q's dtype.  The q-block's own K/V are read back from the pool,
so the caller writes them before it attends.

``ragged_paged_attention`` launches ``csrc/ragged_paged.cu`` on CUDA
tensors and runs :func:`ragged_paged_reference` on CPU tensors; nothing
falls back from one to the other.  The int8 twin (``k_scale``/
``v_scale``) and the slot-contiguous ``ragged_attention`` are later
slices (ROADMAP B1 int8, B3).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def ragged_masked_reference(q, k, v, lengths, q_lens=None):
    """The masked-gather oracle over a slot-contiguous [B, S, H, Dh]
    view, in f32: query ``jq`` of slot b admits kv positions up to
    ``clip(lengths[b] - q_lens[b] + jq, 0, lengths[b] - 1)``; a slot
    with length 0 returns zeros.  ``q_lens=None`` means every row is
    live.  Returns f32."""
    B, Q = q.shape[:2]
    dev = q.device
    lengths = lengths.to(dev).long()
    if q_lens is None:
        q_lens = torch.full((B,), Q, dtype=torch.long, device=dev)
    q_lens = q_lens.to(dev).long()
    S = k.shape[1]
    hi = torch.clamp(lengths - 1, min=0)[:, None]
    posq = torch.minimum(torch.clamp(
        (lengths - q_lens)[:, None] + torch.arange(Q, device=dev)[None, :],
        min=0), hi)                                        # [B, Q]
    s = torch.einsum("bqhd,bshd->bqhs", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    live = torch.arange(S, device=dev)[None, None, None, :] \
        <= posq[:, :, None, None]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhs,bshd->bqhd", p, v.float())
    return out * (lengths > 0)[:, None, None, None]


def ragged_paged_reference(q, pool_k, pool_v, lengths, q_lens,
                           block_tables):
    """Gather-then-mask oracle for the block-table kernel: materialize
    each slot's logical [T*bs] KV view from the pool and delegate to
    :func:`ragged_masked_reference`.  Returns f32."""
    B = q.shape[0]
    bs = pool_k.shape[1]
    T = block_tables.shape[1]
    idx = block_tables.to(q.device).long()
    k = pool_k[idx].reshape(B, T * bs, *pool_k.shape[2:])
    v = pool_v[idx].reshape(B, T * bs, *pool_v.shape[2:])
    return ragged_masked_reference(q, k, v, lengths, q_lens)


def _check_args(q, pool_k, pool_v, lengths, q_lens, block_tables):
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(f"q must be [B, Q, H, Dh] and the pools "
                         f"[N, bs, H, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(pool_k.shape)}")
    B, Q, H, Dh = q.shape
    if pool_k.shape != pool_v.shape or pool_k.shape[2:] != (H, Dh):
        raise ValueError(f"pools {tuple(pool_k.shape)}/"
                         f"{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lengths.shape != (B,) or q_lens.shape != (B,) \
            or block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("lengths/q_lens must be [B] and block_tables "
                         "[B, T]")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("lengths", lengths), ("q_lens", q_lens),
                    ("block_tables", block_tables)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def ragged_paged_attention(q, pool_k, pool_v, lengths, q_lens,
                           block_tables):
    """One mixed wave over one layer of the paged pool.

    q: [B, Q, H, Dh]; pool_k, pool_v: [N_blocks, bs, H, Dh]; lengths /
    q_lens: [B] int32 (filled count INCLUDING the q-block, live queries
    per slot); block_tables: [B, T] int32 — entry (b, j) is the pool
    block holding slot b's positions [j*bs, (j+1)*bs); entries past a
    slot's length may hold any valid block (the engine points them at
    scratch block 0).  Returns o [B, Q, H, Dh] in q's dtype.  CUDA
    tensors launch the kernel (f32 or bf16 with q and the pools of one
    dtype, head dim 32/64/128, all contiguous, int32 indices); CPU
    tensors run :func:`ragged_paged_reference`."""
    _check_args(q, pool_k, pool_v, lengths, q_lens, block_tables)
    if q.device.type == "cpu":
        return ragged_paged_reference(q, pool_k, pool_v, lengths, q_lens,
                                      block_tables).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Q, H, Dh = q.shape
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise ValueError(f"ragged kernel takes float32/bfloat16 q and "
                         f"pools of one dtype, got {q.dtype}/"
                         f"{pool_k.dtype}/{pool_v.dtype}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"ragged kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {Dh}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("lengths", lengths), ("q_lens", q_lens),
                    ("block_tables", block_tables)):
        if not t.is_contiguous():
            raise ValueError(f"ragged kernel takes a contiguous {name}")
    for name, t in (("lengths", lengths), ("q_lens", q_lens),
                    ("block_tables", block_tables)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    out = torch.empty_like(q)
    if B == 0 or Q == 0:
        return out
    lib = _build.library("ragged_paged")
    fn = lib.hetu_ragged_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                lengths.data_ptr(), q_lens.data_ptr(),
                block_tables.data_ptr(), out.data_ptr(), B, Q, H, Dh,
                pool_k.shape[1], block_tables.shape[1], _DTYPES[q.dtype],
                _build.stream_of(q))
    _build.check(lib, rc, "ragged_paged_attention launch")
    _build.LAUNCHES["ragged_paged_attention"] += 1
    return out
