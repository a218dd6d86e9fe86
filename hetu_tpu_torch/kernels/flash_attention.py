"""Flash attention on [B, S, H, D], the port of the JAX package's Pallas
``flash_attention``: the forward (``_flash_fwd`` / ``_fwd_kernel``, K2),
its carried form (``_flash_fwd(carry=...)``, K2-carry, ring attention's
per-rotation step) and the FlashAttention-2 backward (``_flash_bwd``:
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``, K3).

``flash_fwd`` and ``flash_fwd_carry`` launch ``csrc/flash_fwd.cu``
(f32, the tensor cores in three TF32 passes: each product a_hi b_hi +
a_hi b_lo + a_lo b_hi of the operands' TF32 parts, f32-accurate as the
Pallas body's Precision.HIGHEST) or ``csrc/flash_fwd_bf16.cu`` (bf16,
wgmma);
``flash_bwd_dkv`` and ``flash_bwd_dq`` launch the two kernels of
``csrc/flash_bwd.cu`` (f32, the tensor cores in three TF32 passes, as
the forward) or ``csrc/flash_bwd_bf16.cu`` (bf16, mma.sync); each
runs its plain PyTorch version (``*_reference``) on CPU tensors, and
nothing falls back from one to the other.  The plain versions round
where the Pallas bodies round: P to the input dtype before P V (the
denominator from the unrounded P), P and dS before the backward's
products.  Causal or not, with an optional ``kv_lens [B]`` padding
mask: a row with no live key outputs 0 and its logsumexp is +1e30, as
the Pallas forward emits it, so the backward recomputes P = 0 there.
``flash_attention`` is differentiable in q, k and v through
:class:`FlashAttention` (K2 forward, K3 backward); called with no grad,
it launches K2 alone.  ``flash_attention_with_lse`` (K2 + K3 with an
lse cotangent) and ``flash_attention_with_carry`` (K2-carry + K3 and
the carry's elementwise terms) also return the logsumexp and are
differentiable in every tensor argument.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
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
    """Exact attention on [B, S, H, D], in f32 with no rounding inside,
    output in q's dtype.  Rows of a sequence with ``kv_lens == 0`` output
    0 (the kernels' value there; a softmax over no live key is
    undefined)."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    live = _live_mask(S, Sk, causal, kv_lens, q.device)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * live.any(dim=-1)[..., None]
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _softmax_parts(s, live):
    """The Pallas forward's softmax over a whole row at once: (p =
    exp(s - m) on live scores, else 0, with m the row max clamped to 0
    while nothing is live; l = sum of p; lse = m + log l, +1e30 where l
    is 0)."""
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(live, torch.exp(s - safe_m), torch.zeros_like(s))
    l = p.sum(dim=-1)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l),
                      torch.full_like(l, -NEG_INF))
    return p, l, lse


def flash_fwd_reference(q, k, v, *, causal=False, kv_lens=None):
    """The plain version of the forward kernel: (o [B, S, H, D] in q's
    dtype, lse [B, H, S] f32 with +1e30 on rows with no live key).  P is
    rounded to v's dtype before P V, as ``_fwd_kernel`` rounds it, and
    the denominator sums the unrounded P: o = sum(rnd(p) v) / sum(p)
    (no rounding in f32)."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    live = _live_mask(S, Sk, causal, kv_lens, q.device).expand_as(s)
    p, l, lse = _softmax_parts(s, live)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    denom = torch.where(l == 0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype), lse


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


def _check_kernel(q, tensors, names):
    """The flash kernels' terms for CUDA tensors: f32 or bf16, head dim
    32/64/128, ``tensors`` contiguous.  Raises ValueError."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32/bfloat16, got "
                         f"{q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"flash kernel takes contiguous {names}")


def _library(q, name):
    """(library, suffix of its C entries) of kernel ``name`` for q's
    dtype: the f32 source ``name``.cu, or the bf16 tensor-core one
    ``name``_bf16.cu, whose entries end in ``_bf16``."""
    suffix = "_bf16" if q.dtype == torch.bfloat16 else ""
    return _build.library(name + suffix), suffix


def flash_fwd(q, k, v, *, causal=False, kv_lens=None):
    """(o [B, S, H, D], lse [B, H, S] f32).  CUDA tensors launch the
    kernel (f32 or bf16, head dim 32/64/128, contiguous and 16-byte
    aligned, kv_lens int32); CPU tensors run
    :func:`flash_fwd_reference`."""
    _check_args(q, k, v, kv_lens)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, kv_lens=kv_lens)
    _check_kernel(q, (q, k, v), "q, k, v")
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if kv_lens is not None and (kv_lens.dtype != torch.int32
                                or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 tensor")
    if B == 0 or S == 0:
        return (torch.empty_like(q),
                torch.empty((B, H, S), dtype=torch.float32,
                            device=q.device))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _build.check_aligned((q, k, v, o), "q, k, v")
    lib, suffix = _library(q, "flash_fwd")
    fn = getattr(lib, "hetu_flash_fwd" + suffix)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_lens.data_ptr() if kv_lens is not None else None,
                o.data_ptr(), lse.data_ptr(), B, S, Sk, H, D,
                int(bool(causal)), _build.stream_of(q))
    _build.check(lib, rc, "flash_fwd launch")
    _build.LAUNCHES["flash_attention"] += 1
    return o, lse


def _carry_live(lse_c):
    """[B, H, S] bool: the carried partial has a live key there."""
    return lse_c > NEG_INF / 2


def flash_fwd_carry_reference(q, k, v, o_c, lse_c, *, causal=False):
    """The plain version of the carried forward kernel, in f32: attention
    over the union of the carried keys (one virtual key per row with
    score ``lse_c`` and value ``o_c``, present where lse_c > NEG_INF / 2)
    and these (k, v).  The P of these keys is rounded to v's dtype before
    P V, as ``_fwd_kernel`` rounds it; the carry's term (the kernel's
    seed of its f32 accumulator) and the denominator are not.  Returns
    (o [B, S, H, D] f32, lse [B, H, S] f32, +1e30 on rows with no live
    key in either part)."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    live = _live_mask(S, Sk, causal, None, q.device).expand_as(s)
    c_live = _carry_live(lse_c)[..., None]                     # [B,H,S,1]
    s = torch.cat([s, lse_c.float()[..., None]], dim=-1)
    live = torch.cat([live, c_live], dim=-1)
    p, l, lse = _softmax_parts(s, live)
    o = torch.einsum("bhqk,bkhd->bqhd", p[..., :Sk].to(v.dtype).float(),
                     v.float()) \
        + p[..., Sk].transpose(1, 2)[..., None] * o_c.float()
    denom = torch.where(l == 0, torch.ones_like(l), l)
    return o / denom.transpose(1, 2)[..., None], lse


def bf16_rounding_bound(q, k, v, *, causal=False, kv_lens=None, lse_c=None):
    """[B, S, H, D] f32: how far two bf16 forwards that round P = exp(s -
    m) against different maxima may put each element of o apart, before
    o's own rounding.  The kernels round against their running max at
    each key tile, the plain versions against the row's final max: each
    rounding is within 2^-8 of p, so the two P differ by at most 2^-7 p
    and o_d by at most 2^-7 sum(p |v_d|) / l, which is 2^-7 times the f32
    plain forward of (q, k, |v|).  With a carry (``lse_c``) the carry's
    term is not rounded, so o_c is 0 there and only l counts it.  Runs
    one head at a time, so the f32 scores of one head are the peak."""
    q, k, va = q.float(), k.float(), v.float().abs()
    heads = []
    for h in range(q.shape[2]):
        hs = slice(h, h + 1)
        if lse_c is None:
            w, _ = flash_fwd_reference(q[:, :, hs], k[:, :, hs],
                                       va[:, :, hs], causal=causal,
                                       kv_lens=kv_lens)
        else:
            w, _ = flash_fwd_carry_reference(
                q[:, :, hs], k[:, :, hs], va[:, :, hs],
                torch.zeros_like(q[:, :, hs]), lse_c[:, hs], causal=causal)
        heads.append(w)
    return 2.0 ** -7 * torch.cat(heads, dim=2)


def _check_carry(q, o_c, lse_c):
    B, S, H, D = q.shape
    if o_c.shape != q.shape or o_c.dtype != torch.float32 \
            or o_c.device != q.device:
        raise ValueError(f"o_carry must be float32 {tuple(q.shape)} on "
                         f"{q.device}, got {o_c.dtype} "
                         f"{tuple(o_c.shape)} on {o_c.device}")
    if lse_c.shape != (B, H, S) or lse_c.dtype != torch.float32 \
            or lse_c.device != q.device:
        raise ValueError(f"lse_carry must be float32 [B={B}, H={H}, "
                         f"S={S}] on {q.device}, got {lse_c.dtype} "
                         f"{tuple(lse_c.shape)} on {lse_c.device}")


def flash_fwd_carry(q, k, v, o_c, lse_c, *, causal=False):
    """(o [B, S, H, D] f32, lse [B, H, S] f32): flash attention over
    (k, v) continuing the partial (o_c f32 [B, S, H, D], normalised;
    lse_c f32 [B, H, S], NEG_INF where empty).  CUDA tensors launch the
    carried kernel (q, k, v f32 or bf16, head dim 32/64/128, all
    contiguous and 16-byte aligned); CPU tensors run
    :func:`flash_fwd_carry_reference`.
    It takes no ``kv_lens``: the Pallas kernel does not combine one with
    a carry either."""
    _check_args(q, k, v, None)
    _check_carry(q, o_c, lse_c)
    if q.device.type == "cpu":
        return flash_fwd_carry_reference(q, k, v, o_c, lse_c,
                                         causal=causal)
    _check_kernel(q, (q, k, v, o_c, lse_c),
                  "q, k, v, o_carry and lse_carry")
    B, S, H, D = q.shape
    Sk = k.shape[1]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return o, lse
    _build.check_aligned((q, k, v, o_c, o), "q, k, v, o_carry")
    lib, suffix = _library(q, "flash_fwd")
    fn = getattr(lib, "hetu_flash_fwd_carry" + suffix)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_c.data_ptr(),
                lse_c.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, Sk,
                H, D, int(bool(causal)), _build.stream_of(q))
    _build.check(lib, rc, "flash_fwd_carry launch")
    _build.LAUNCHES["flash_attention_carry"] += 1
    return o, lse


# ------------------------------------------------------------------ #
# the backward (K3)
# ------------------------------------------------------------------ #


def bwd_delta(o, do, g_lse=None):
    """delta [B, H, S] f32 = rowsum(dO * O), minus the lse cotangent
    ``g_lse`` [B, H, S] when given (the JAX package's XLA reduction
    beside its backward kernels: d lse / d s = P, so an lse cotangent
    shifts dS = P * (dP - delta + g_lse))."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def _bwd_p_ds(q, k, v, kv_lens, lse, delta, do, causal):
    """P and dS [B, H, S, Sk] in f32, as ``_recompute_p`` and the Pallas
    bodies form them: P = exp(s * scale - lse) on live pairs, else 0;
    dS = P * (dP - delta) * scale with dP = dO V^T."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    live = _live_mask(S, Sk, causal, kv_lens, q.device)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkv_reference(q, k, v, kv_lens, lse, delta, do, *,
                            causal=False):
    """The plain version of the dK/dV kernel: (dk, dv) [B, Sk, H, D] in
    q's dtype; P rounded to that dtype before P^T dO, dS before dS^T Q
    (the Pallas body's rounding points), sums in f32."""
    dt = q.dtype
    p, ds = _bwd_p_ds(q, k, v, kv_lens, lse, delta, do, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float())
    return dk.to(dt), dv.to(dt)


def flash_bwd_dq_reference(q, k, v, kv_lens, lse, delta, do, *,
                           causal=False):
    """The plain version of the dQ kernel: dq [B, S, H, D] in q's dtype,
    dS rounded to that dtype before dS K."""
    dt = q.dtype
    _, ds = _bwd_p_ds(q, k, v, kv_lens, lse, delta, do, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(dt).float(),
                        k.float()).to(dt)


def flash_bwd_reference(q, k, v, kv_lens, o, lse, do, *, causal=False,
                        g_lse=None):
    """The plain version of :func:`flash_bwd`: (dq, dk, dv)."""
    delta = bwd_delta(o, do, g_lse)
    dk, dv = flash_bwd_dkv_reference(q, k, v, kv_lens, lse, delta, do,
                                     causal=causal)
    dq = flash_bwd_dq_reference(q, k, v, kv_lens, lse, delta, do,
                                causal=causal)
    return dq, dk, dv


def _check_bwd(q, k, v, kv_lens, lse, delta, do):
    _check_args(q, k, v, kv_lens)
    B, S, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} on {do.device} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 [B={B}, H={H}, "
                             f"S={S}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.device.type == "cpu":
        return False
    _check_kernel(q, (q, k, v, do, lse, delta),
                  "q, k, v, dO, lse and delta")
    if kv_lens is not None and (kv_lens.dtype != torch.int32
                                or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 tensor")
    return True


def _bwd_launch(entry, what, q, k, v, kv_lens, lse, delta, do, outs,
                causal):
    B, S, H, D = q.shape
    _build.check_aligned((q, k, v, do) + tuple(outs), "q, k, v, dO")
    lib, suffix = _library(q, "flash_bwd")
    fn = getattr(lib, entry + suffix)
    fn.argtypes = [ctypes.c_void_p] * (7 + len(outs)) \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                kv_lens.data_ptr() if kv_lens is not None else None,
                *(t.data_ptr() for t in outs), B, S, k.shape[1], H, D,
                int(bool(causal)), _build.stream_of(q))
    _build.check(lib, rc, f"{what} launch")


def flash_bwd_dkv(q, k, v, kv_lens, lse, delta, do, *, causal=False):
    """(dk, dv) [B, Sk, H, D]: the dK/dV kernel on CUDA tensors (f32 or
    bf16, head dim 32/64/128, contiguous, lse and delta f32 [B, H, S],
    kv_lens int32 [B]; q, k, v and dO 16-byte aligned, or a raise);
    :func:`flash_bwd_dkv_reference` on CPU tensors."""
    if not _check_bwd(q, k, v, kv_lens, lse, delta, do):
        return flash_bwd_dkv_reference(q, k, v, kv_lens, lse, delta, do,
                                       causal=causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[0] == 0 or k.shape[1] == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _bwd_launch("hetu_flash_bwd_dkv", "flash_bwd dK/dV", q, k, v, kv_lens,
                lse, delta, do, (dk, dv), causal)
    _build.LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, kv_lens, lse, delta, do, *, causal=False):
    """dq [B, S, H, D]: the dQ kernel on CUDA tensors (on the terms of
    :func:`flash_bwd_dkv`, 16-byte aligned data or a raise);
    :func:`flash_bwd_dq_reference` on CPU tensors."""
    if not _check_bwd(q, k, v, kv_lens, lse, delta, do):
        return flash_bwd_dq_reference(q, k, v, kv_lens, lse, delta, do,
                                      causal=causal)
    dq = torch.empty_like(q)
    if q.shape[0] == 0 or q.shape[1] == 0:
        return dq
    if k.shape[1] == 0:
        return dq.zero_()
    _bwd_launch("hetu_flash_bwd_dq", "flash_bwd dQ", q, k, v, kv_lens, lse,
                delta, do, (dq,), causal)
    _build.LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_bwd(q, k, v, kv_lens, o, lse, do, *, causal=False, g_lse=None):
    """(dq, dk, dv) of flash attention from the forward's (o, lse) and
    the output cotangent ``do``, with an optional lse cotangent
    ``g_lse`` [B, H, S]: delta by :func:`bwd_delta`, then the dK/dV and
    the dQ kernel (their plain versions on CPU tensors)."""
    delta = bwd_delta(o, do, g_lse)
    dk, dv = flash_bwd_dkv(q, k, v, kv_lens, lse, delta, do, causal=causal)
    dq = flash_bwd_dq(q, k, v, kv_lens, lse, delta, do, causal=causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(o, lse) of flash attention of (q, k, v): K2 forward, saving (q,
    k, v, kv_lens, o, lse); K3 backward with the lse cotangent, when
    there is one, folded into delta (the JAX package's ``_flash`` and
    ``_flash_stats`` custom VJPs).  lse is K2's raw one (+1e30 on empty
    rows).  kv_lens and causal take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal):
        ctx.set_materialize_grads(False)
        o, lse = flash_fwd(q, k, v, causal=causal, kv_lens=kv_lens)
        ctx.save_for_backward(q, k, v, kv_lens, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(q.dtype)
        dq, dk, dv = flash_bwd(q, k, v, kv_lens, o, lse, do.contiguous(),
                               causal=ctx.causal, g_lse=g_lse)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=False, kv_lens=None):
    """Flash attention on [B, S, H, D] (the JAX package's layout); the
    output has q's dtype.  Differentiable in q, k and v
    (:class:`FlashAttention`); with no grad it runs the forward alone and
    keeps nothing, as the serving cores call it."""
    return FlashAttention.apply(q, k, v, kv_lens, causal)[0]


def _empty_to_neg(lse):
    """The kernels' +1e30 on a row with no live key, read as an empty
    partial (-1e30) for the cross-block combine (the JAX wrappers'
    ``jnp.where``, so the lse cotangent of such a row is 0)."""
    return torch.where(lse >= -NEG_INF / 2,
                       torch.full_like(lse, NEG_INF), lse)


class FlashAttentionCarry(torch.autograd.Function):
    """(o f32, lse) of flash attention continuing a carried partial
    (o_c, lse_c): K2-carry forward; backward (the JAX package's
    ``_flash_stats_carry_bwd_rule``) K3 on (q, k, v) with the total lse
    and the lse cotangent, plus the carry's terms as one virtual key row
    of value o_c and score lse_c:

        w_c      = exp(lse_c - lse)   (0 where the carry is empty)
        d o_c    = w_c * dO
        d lse_c  = w_c * (dO . o_c - rowsum(dO * o) + g_lse)
    """

    @staticmethod
    def forward(ctx, q, k, v, o_c, lse_c, causal):
        o, lse = flash_fwd_carry(q, k, v, o_c, lse_c, causal=causal)
        ctx.save_for_backward(q, k, v, o_c, lse_c, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o_c, lse_c, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, None, o, lse,
                               do.to(q.dtype).contiguous(),
                               causal=ctx.causal, g_lse=g_lse)
        do32 = do.float()
        w_c = torch.where(_carry_live(lse_c), torch.exp(lse_c - lse),
                          torch.zeros_like(lse_c))             # [B, H, S]
        d_o_c = w_c.transpose(1, 2)[..., None] * do32
        delta = (do32 * o).sum(-1).transpose(1, 2)
        dot_c = (do32 * o_c).sum(-1).transpose(1, 2)
        d_lse_c = w_c * (dot_c - delta + g_lse.float())
        return dq, dk, dv, d_o_c, d_lse_c, None


def flash_attention_with_lse(q, k, v, *, causal=False):
    """Flash attention on [B, S, H, D] returning (o in q's dtype, lse
    [B, H, S] f32, -1e30 on rows with no live key).  Differentiable in
    q, k and v through both outputs (:class:`FlashAttention`)."""
    o, lse = FlashAttention.apply(q, k, v, None, causal)
    return o, _empty_to_neg(lse)


def flash_attention_with_carry(q, k, v, o_carry, lse_carry, *,
                               causal=False):
    """Flash attention on [B, S, H, D] continuing a previous partial:
    ``o_carry`` [B, S, H, D] f32 (normalised) and ``lse_carry`` [B, H, S]
    f32 (-1e30 where the carry is empty).  Returns (o [B, S, H, D] f32,
    lse [B, H, S] f32, -1e30 on rows with no live key): attention over
    the carried keys and this (k, v) together, exactly.
    Differentiable in all five tensors (:class:`FlashAttentionCarry`)."""
    o, lse = FlashAttentionCarry.apply(q, k, v, o_carry, lse_carry, causal)
    return o, _empty_to_neg(lse)
