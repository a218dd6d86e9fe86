"""Forward flash attention on [B, S, H, D], the port of the JAX package's
Pallas ``flash_attention`` forward (``_flash_fwd`` / ``_fwd_kernel``).

``flash_fwd`` launches ``csrc/flash_fwd.cu`` on CUDA tensors and runs
the plain PyTorch version, :func:`flash_fwd_reference`, on CPU tensors;
nothing falls back from one to the other.  Causal or not, with an
optional ``kv_lens [B]`` padding mask: a row with no live key outputs 0
and its logsumexp is +1e30, as the Pallas forward emits it for its
backward (the backward itself is ROADMAP B6).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _live_mask(S, Sk, causal, kv_lens, device):
    """[B or 1, 1, S, Sk] bool: key j is live for query i."""
    live = torch.ones((1, 1, S, Sk), dtype=torch.bool, device=device)
    if causal:
        live = torch.tril(live[0, 0])[None, None]
    if kv_lens is not None:
        kv = torch.arange(Sk, device=device)[None, :] \
            < kv_lens.to(device)[:, None]                     # [B, Sk]
        live = live & kv[:, None, None, :]
    return live


def mha_reference(q, k, v, *, causal=False, kv_lens=None):
    """Exact attention on [B, S, H, D], in f32, output in q's dtype.
    Rows of a sequence with ``kv_lens == 0`` output 0 (the kernels' value
    there; a softmax over no live key is undefined)."""
    return flash_fwd_reference(q, k, v, causal=causal, kv_lens=kv_lens)[0]


def flash_fwd_reference(q, k, v, *, causal=False, kv_lens=None):
    """The plain version of the forward kernel: (o [B, S, H, D] in q's
    dtype, lse [B, H, S] f32 with +1e30 on rows with no live key)."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    live = _live_mask(S, Sk, causal, kv_lens, q.device)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    row_live = live.any(dim=-1)                               # [B|1,1,S]
    p = p * row_live[..., None]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(row_live.expand_as(lse), lse,
                      torch.full_like(lse, -NEG_INF))
    return o.to(q.dtype), lse


def _check_args(q, k, v, kv_lens):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv_lens is not None and (kv_lens.shape != (B,)
                                or kv_lens.device != q.device):
        raise ValueError(f"kv_lens must be [B={B}] on {q.device}")


def flash_fwd(q, k, v, *, causal=False, kv_lens=None):
    """(o [B, S, H, D], lse [B, H, S] f32).  CUDA tensors launch the
    kernel (f32 or bf16, head dim 32/64/128, contiguous, kv_lens int32);
    CPU tensors run :func:`flash_fwd_reference`."""
    _check_args(q, k, v, kv_lens)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, kv_lens=kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32/bfloat16, got "
                         f"{q.dtype}")
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q, k, v")
    if kv_lens is not None and (kv_lens.dtype != torch.int32
                                or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 tensor")
    if B == 0 or S == 0:
        return (torch.empty_like(q),
                torch.empty((B, H, S), dtype=torch.float32,
                            device=q.device))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd")
    fn = lib.hetu_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_lens.data_ptr() if kv_lens is not None else None,
                o.data_ptr(), lse.data_ptr(), B, S, Sk, H, D,
                int(bool(causal)), _DTYPES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_fwd launch")
    _build.LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention(q, k, v, *, causal=False, kv_lens=None):
    """Flash attention on [B, S, H, D] (the JAX package's layout); the
    output has q's dtype.  See :func:`flash_fwd`."""
    return flash_fwd(q, k, v, causal=causal, kv_lens=kv_lens)[0]
