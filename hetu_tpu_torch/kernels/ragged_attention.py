"""The mixed-wave ragged attention over either KV layout of the serving
engine, the port of the JAX package's Pallas ``ragged_paged_attention``
(the block-table pool, K1) and ``ragged_attention`` (the slot-contiguous
cache, K8), one Pallas body ``_ragged_kernel``: the mixed scheduler's
one attention dispatch per layer, whatever mix of prompt q-blocks and
decode tokens a wave carries.

Slot b's query ``jq`` sits at ``lengths[b] - q_lens[b] + jq`` and sees
the slot's positions up to itself; rows past ``q_lens[b]`` clip to the
last live position (their output is defined and discarded by the
caller); a slot with length 0 returns zeros; the output has q's dtype.
The q-block's own K/V are read back from the cache, so the caller writes
them before it attends.

The cache is f32/bf16 of q's dtype, or int8 (``quant.kv_encode``'s
payload) with ``k_scale``/``v_scale``, one f32 scale per (position,
head): the int8 twins (K1-int8, K8-int8).  On CUDA tensors both launch
``csrc/ragged_paged.cu`` for f32 q over an f32 cache and
``ragged_paged_int8.cu`` for f32 q over an int8 one, in two regimes
chosen from Q: the narrow waves (Q <= ``NARROW_Q``) of f32 K1, f32 K8,
f32-q K1-int8 and f32-q K8-int8 run the split-K CUDA-core body of
``split_kv_f32.cuh`` (128-position splits in parallel, then a merge; an
int8 payload staged raw and dequantized as payload * scale as it is
read), and their wide waves (Q > 16) the tensor cores in three TF32
passes, ``ragged_tf32.cuh`` (f32 K2's body: one block per 64-row q
tile, an int8 tile dequantized to f32 once it has landed); either way
16-byte aligned q, caches and scales or a raise; and
``ragged_paged_bf16.cu`` for bf16 q over a bf16 or an int8
cache: the tensor cores, in two regimes chosen from Q (wgmma for Q > 16,
split-K over positions and a merge for Q <= 16, one launch counted
either way; an int8 payload widened to bf16 as it is staged, exactly,
its scales applied in f32 to the scores and to P).  On CPU tensors they
run their plain versions, :func:`ragged_paged_reference` and
:func:`ragged_masked_reference`; nothing falls back from one to the
other.  Over a bf16 cache the bf16 kernels round P to bf16 before P V, as
the Pallas body does, and the plain versions do not:
:func:`ragged_rounding_bound` bounds the difference.  Over an int8 cache
the Pallas body computes in f32 and never rounds P, and neither do the
bf16-q kernels: P times the V scale goes into P V_int as a pair of bf16
values (hi, and the rest of its rounding), within one bf16 ulp of o.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
# K1/K8 waves at most this wide (Q) run the split-K regime of the bf16
# kernels and of f32 K1/K8 and their f32-q int8 twins
NARROW_Q = 16


def ragged_masked_reference(q, k, v, lengths, q_lens=None, k_scale=None,
                            v_scale=None):
    """The masked-gather oracle over a slot-contiguous [B, S, H, Dh]
    view, in f32: query ``jq`` of slot b admits kv positions up to
    ``clip(lengths[b] - q_lens[b] + jq, 0, lengths[b] - 1)``; a slot
    with length 0 returns zeros.  ``q_lens=None`` means every row is
    live.  An int8 view passes its [B, S, H] scale planes and is
    dequantized first.  Returns f32."""
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
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
                           block_tables, k_scale=None, v_scale=None):
    """Gather-then-mask oracle for the block-table kernel: materialize
    each slot's logical [T*bs] KV view from the pool (and an int8 pool's
    scale planes through the same tables) and delegate to
    :func:`ragged_masked_reference`.  Returns f32."""
    B = q.shape[0]
    bs = pool_k.shape[1]
    T = block_tables.shape[1]
    idx = block_tables.to(q.device).long()

    def view(pool):
        return pool[idx].reshape(B, T * bs, *pool.shape[2:])
    ks = vs = None
    if k_scale is not None:
        ks, vs = view(k_scale), view(v_scale)
    return ragged_masked_reference(q, view(pool_k), view(pool_v), lengths,
                                   q_lens, ks, vs)


def ragged_rounding_bound(q, k, v, lengths, q_lens, block_tables=None,
                          k_scale=None, v_scale=None):
    """[B, Q, H, Dh] f32: how far a wave that rounds P = exp(s - m) to
    bf16 before P V (the Pallas body over a bf16 cache, and the bf16
    kernels there) may put each element of o from the plain versions,
    which do not round, before o's own rounding.  One rounding is within
    2^-8 of p whatever max it is taken against, so o_d moves by at most
    2^-8 sum(p |v_d|) / l: 2^-8 times the plain version run on (q, k,
    |v|), through ``block_tables`` when given.  An int8 cache is
    dequantized first (one rounding of p times the V scale against the
    integer payload would be within 2^-8 p |v_d| of the dequantized
    term; the kernels split that product instead and need no bound
    there).  Zero on a length-0 slot."""
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    va = v.float().abs()
    if block_tables is None:
        w = ragged_masked_reference(q, k, va, lengths, q_lens)
    else:
        w = ragged_paged_reference(q, k, va, lengths, q_lens, block_tables)
    return 2.0 ** -8 * w


def _check_scales(kind, q, k, v, k_scale, v_scale):
    """An int8 cache comes with both scale planes, a float cache with
    neither: int8 payloads, f32 scales of the payload's shape less its
    Dh axis, on q's device.  Returns True for an int8 cache."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{kind}: pass both k_scale and v_scale, or "
                         f"neither")
    if k_scale is None:
        if k.dtype == torch.int8 or v.dtype == torch.int8:
            raise ValueError(f"{kind}: an int8 cache needs k_scale and "
                             f"v_scale")
        return False
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{kind}: k_scale/v_scale come with an int8 "
                         f"cache, got {k.dtype}/{v.dtype}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32:
            raise ValueError(f"{kind}: {name} must be float32, got "
                             f"{s.dtype}")
        if s.shape != k.shape[:-1]:
            raise ValueError(f"{kind}: {name} {tuple(s.shape)} must be "
                             f"the cache's shape less Dh, "
                             f"{tuple(k.shape[:-1])}")
        if s.device != q.device:
            raise ValueError(f"{kind}: {name} is on {s.device}, q on "
                             f"{q.device}")
    return True


def _check_args(kind, q, k, v, lengths, q_lens, index, k_scale=None,
                v_scale=None):
    """q [B, Q, H, Dh], k/v [*, *, H, Dh] (and the scale planes of an int8
    cache, :func:`_check_scales`); on CUDA also the kernel's dtypes, head
    dims, contiguity, int32 indices and an int8 payload's 4-byte
    alignment (the 16 bytes of the tensor-core and split-K kernels, K1/K8
    in every dtype and regime among them, are checked by :func:`_launch`,
    which picks the kernel).  ``index`` names the int32 index
    tensors.  Returns True for an int8 cache."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{kind}: q must be [B, Q, H, Dh] and k/v "
                         f"[*, *, H, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, Q, H, Dh = q.shape
    if k.shape != v.shape or k.shape[2:] != (H, Dh):
        raise ValueError(f"{kind}: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if lengths.shape != (B,) or q_lens.shape != (B,):
        raise ValueError(f"{kind}: lengths/q_lens must be [B={B}]")
    for name, t in [("k", k), ("v", v)] + list(index.items()):
        if t.device != q.device:
            raise ValueError(f"{kind}: {name} is on {t.device}, q on "
                             f"{q.device}")
    quant = _check_scales(kind, q, k, v, k_scale, v_scale)
    if q.device.type == "cpu":
        return quant
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or (not quant and (k.dtype != q.dtype
                                                 or v.dtype != q.dtype)):
        raise ValueError(f"{kind} kernel takes float32/bfloat16 q and "
                         f"caches of one dtype, q's (or int8 with scales), "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{kind} kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {Dh}")
    dense = [("q", q), ("k", k), ("v", v)] + list(index.items())
    if quant:
        dense += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in dense:
        if not t.is_contiguous():
            raise ValueError(f"{kind} kernel takes a contiguous {name}")
    if quant and (k.data_ptr() % 4 or v.data_ptr() % 4):
        raise ValueError(f"{kind} kernel reads int8 payloads in words of "
                         f"4 bytes or more: k/v must be 4-byte aligned "
                         f"(16-byte for the split-K and tensor-core "
                         f"kernels)")
    for name, t in index.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    return quant


# the tensor-core library that takes bf16 q, over a bf16 or an int8
# cache, in place of each CUDA-core source: (library, its workspace-size
# entry)
_BF16_LIBRARIES = {
    "ragged_paged": ("ragged_paged_bf16", "hetu_ragged_bf16_workspace"),
    "decode_attention": ("decode_attention_bf16",
                         "hetu_verify_bf16_workspace")}
# f32 q's calls at Q <= NARROW_Q that run the split-K CUDA-core body
# (split_kv_f32.cuh): K1/K8 and their int8 twins, K6/K7 and their int8
# twins (the verify wrappers cut a longer block into 16-row groups), and
# K4/K5 and their int8 twins (always Q 1).  (entry, over an int8 cache)
# -> (library, split entry, its workspace-size entry)
_F32_NARROW = {
    ("hetu_ragged_paged_attention", False): (
        "ragged_paged", "hetu_ragged_paged_attention_narrow",
        "hetu_ragged_f32_workspace"),
    ("hetu_ragged_attention", False): (
        "ragged_paged", "hetu_ragged_attention_narrow",
        "hetu_ragged_f32_workspace"),
    ("hetu_ragged_paged_attention", True): (
        "ragged_paged_int8", "hetu_ragged_paged_attention_int8_narrow",
        "hetu_ragged_f32_workspace"),
    ("hetu_ragged_attention", True): (
        "ragged_paged_int8", "hetu_ragged_attention_int8_narrow",
        "hetu_ragged_f32_workspace"),
    ("hetu_paged_verify_attention", False): (
        "decode_attention", "hetu_paged_verify_attention",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_block_verify_attention", False): (
        "decode_attention", "hetu_paged_block_verify_attention",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_verify_attention", True): (
        "decode_attention_int8", "hetu_paged_verify_attention_int8",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_block_verify_attention", True): (
        "decode_attention_int8", "hetu_paged_block_verify_attention_int8",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_decode_attention", False): (
        "decode_attention", "hetu_paged_decode_attention",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_block_decode_attention", False): (
        "decode_attention", "hetu_paged_block_decode_attention",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_decode_attention", True): (
        "decode_attention_int8", "hetu_paged_decode_attention_int8",
        "hetu_decode_f32_workspace"),
    ("hetu_paged_block_decode_attention", True): (
        "decode_attention_int8", "hetu_paged_block_decode_attention_int8",
        "hetu_decode_f32_workspace")}
# the ctypes signature of every workspace-size entry: (B, Q, H, Dh, span)
_WS_ARGTYPES = (ctypes.c_int,) * 5


class Route(NamedTuple):
    """What one call of :func:`_launch` calls: the C entry ``entry`` of
    kernel library ``library`` with ``argtypes``, after the
    workspace-size entry ``ws_entry`` (None: no workspace), passing
    ``tail`` after the shapes (the dtype code, for an entry that takes
    one); the call counts under ``name`` and, for K1/K8 and their int8
    twins, under ``regime`` too."""
    library: str
    entry: str
    ws_entry: Optional[str]
    tail: tuple
    name: str
    regime: Optional[str]
    argtypes: tuple


def route(source, entry, name, q, kv, rest, ints):
    """The :class:`Route` of ``_launch(source, entry, name, q, kv, rest,
    ints, span)``, from the shapes, dtypes and argument counts alone
    (nothing is read, built or launched).

    ``kv`` is (k, v), or (k, k_scale, v, v_scale) for an int8 cache,
    which takes the int8 twin: ``name`` + ``_int8``.  bf16 q launches the
    tensor-core library of ``_BF16_LIBRARIES`` at ``entry`` + ``_bf16``
    over a bf16 cache and ``entry`` + ``_int8_bf16`` over an int8 one,
    with the library's workspace (the f32 partials of the split-K body,
    Q <= NARROW_Q; none for K1/K8's wide regime) and no dtype.  f32 q at
    Q <= NARROW_Q launches ``_F32_NARROW``'s library and entry (every
    decode and verify call, and K1/K8 and their int8 twins: the split-K
    CUDA-core body), the same way; past it, K1/K8 and their int8 twins
    launch ``source`` (``_int8`` for an int8 cache) at ``entry``
    (``_int8``) with the dtype code and no workspace (the TF32 body).
    The C entry takes ``(q, *kv, *rest, out, [workspace], *ints, *tail,
    stream)``."""
    quant = len(kv) == 4
    if quant:
        name = f"{name}_int8"
    narrow = q.shape[1] <= NARROW_Q
    regime = (f"{name}:{'narrow' if narrow else 'wide'}"
              if source == "ragged_paged" else None)
    if q.dtype == torch.bfloat16:
        library, ws_entry = _BF16_LIBRARIES[source]
        entry = f"{entry}_int8_bf16" if quant else f"{entry}_bf16"
        tail = ()
    elif narrow and (entry, quant) in _F32_NARROW:
        library, entry, ws_entry = _F32_NARROW[entry, quant]
        tail = ()
    else:
        library = f"{source}_int8" if quant else source
        entry = f"{entry}_int8" if quant else entry
        ws_entry, tail = None, (_DTYPES[q.dtype],)
    n_ptrs = 2 + len(kv) + len(rest) + (ws_entry is not None)
    argtypes = ((ctypes.c_void_p,) * n_ptrs
                + (ctypes.c_int,) * (len(ints) + len(tail))
                + (ctypes.c_void_p,))
    return Route(library, entry, ws_entry, tail, name, regime, argtypes)


def _typed(lib, entry, argtypes, restype):
    """C entry ``entry`` of ``lib``, its ctypes signature set on its first
    lookup (ctypes keeps one function object per library and entry)."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def _launch(source, entry, name, q, kv, rest, ints, span):
    """Launch the C entry :func:`route` picks for C entry ``entry`` of
    kernel library ``source`` into a fresh output like q, and count it.
    ``kv`` is (k, v), or (k, k_scale, v, v_scale) for an int8 cache.
    ``source`` is ``ragged_paged`` (K1/K8) or ``decode_attention``
    (K4-K7; the decode wrappers pass q as [B, 1, H, Dh]); ``span`` is the
    cache's positions per slot, from which the library sizes the
    workspace.  Every body copies 16-byte chunks: q and the caches
    (int8: their scales too) not on 16-byte boundaries raise ValueError,
    before anything is built or launched.  One call counts as one
    launch, though a split-K call runs two device kernels (the splits,
    then their merge)."""
    r = route(source, entry, name, q, kv, rest, ints)
    _build.check_aligned((q, *kv), "q and the caches (int8: their scales "
                         "too)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.library(r.library)
    ptrs = [t.data_ptr() for t in (q, *kv, *rest, out)]
    if r.ws_entry is not None:
        n_ws = _typed(lib, r.ws_entry, _WS_ARGTYPES,
                      ctypes.c_longlong)(*q.shape, span)
        ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
        ptrs.append(ws.data_ptr() if n_ws else None)
    fn = _typed(lib, r.entry, r.argtypes, ctypes.c_int)
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, *ints, *r.tail, _build.stream_of(q))
    _build.check(lib, rc, f"{r.name} launch")
    _build.LAUNCHES[r.name] += 1
    if r.regime:
        _build.LAUNCHES[r.regime] += 1
    return out


def _kv(k, v, k_scale, v_scale, quant):
    """The cache operands of a launch (see :func:`_launch`)."""
    return (k, k_scale, v, v_scale) if quant else (k, v)


def ragged_paged_attention(q, pool_k, pool_v, lengths, q_lens,
                           block_tables, *, k_scale=None, v_scale=None):
    """One mixed wave over one layer of the paged pool.

    q: [B, Q, H, Dh]; pool_k, pool_v: [N_blocks, bs, H, Dh]; lengths /
    q_lens: [B] int32 (filled count INCLUDING the q-block, live queries
    per slot); block_tables: [B, T] int32 — entry (b, j) is the pool
    block holding slot b's positions [j*bs, (j+1)*bs); entries past a
    slot's length may hold any valid block (the engine points them at
    scratch block 0).  An int8 pool passes ``k_scale``/``v_scale``
    [N_blocks, bs, H] f32.  Returns o [B, Q, H, Dh] in q's dtype.  CUDA
    tensors launch the kernel (f32 or bf16 q; pools of q's dtype, or
    int8 with their scales; head dim 32/64/128, all contiguous, int32
    indices; q and the caches and scales 16-byte aligned); CPU tensors
    run :func:`ragged_paged_reference`."""
    quant = _check_args("ragged_paged_attention", q, pool_k, pool_v,
                        lengths, q_lens,
                        {"lengths": lengths, "q_lens": q_lens,
                         "block_tables": block_tables}, k_scale, v_scale)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError("ragged_paged_attention: block_tables must be "
                         "[B, T]")
    if q.device.type == "cpu":
        return ragged_paged_reference(q, pool_k, pool_v, lengths, q_lens,
                                      block_tables, k_scale,
                                      v_scale).to(q.dtype)
    bs, T = pool_k.shape[1], block_tables.shape[1]
    return _launch("ragged_paged", "hetu_ragged_paged_attention",
                   "ragged_paged_attention", q,
                   _kv(pool_k, pool_v, k_scale, v_scale, quant),
                   (lengths, q_lens, block_tables), (*q.shape, bs, T),
                   span=T * bs)


def ragged_attention(q, k, v, lengths, q_lens, *, k_scale=None,
                     v_scale=None):
    """One mixed wave over one layer of the slot-contiguous cache.

    q: [B, Q, H, Dh]; k, v: [B, S_max, H, Dh] (one row per slot), int8
    with ``k_scale``/``v_scale`` [B, S_max, H] f32 for an int8 cache;
    lengths / q_lens: [B] int32 as in :func:`ragged_paged_attention`.
    Returns o [B, Q, H, Dh] in q's dtype.  CUDA tensors launch the kernel
    (same terms as the paged one); CPU tensors run
    :func:`ragged_masked_reference`."""
    quant = _check_args("ragged_attention", q, k, v, lengths, q_lens,
                        {"lengths": lengths, "q_lens": q_lens}, k_scale,
                        v_scale)
    if k.shape[0] != q.shape[0]:
        raise ValueError("ragged_attention: k/v must hold one row per "
                         "slot of q")
    if q.device.type == "cpu":
        return ragged_masked_reference(q, k, v, lengths, q_lens, k_scale,
                                       v_scale).to(q.dtype)
    return _launch("ragged_paged", "hetu_ragged_attention",
                   "ragged_attention", q, _kv(k, v, k_scale, v_scale, quant),
                   (lengths, q_lens), (*q.shape, k.shape[1]),
                   span=k.shape[1])
