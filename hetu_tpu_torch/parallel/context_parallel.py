"""Sequence (context) parallelism: ring attention, Ulysses all-to-all and
single-device blockwise attention, the port of
``hetu_tpu/parallel/context_parallel.py``.

``ring_attention`` keeps q in place and rotates the K/V blocks around
the ``cp`` axis while each rank folds them into a streaming softmax, so
the S x S scores never exist and the sequence grows with the ranks.
Its flash path runs the carried flash kernel (K2-carry,
``flash_attention_with_carry``) on every live rotation: the previous
rotation's (o, lse) seeds the kernel's softmax state, so the merge costs
no pass of its own; a rotation wholly above the causal diagonal is
skipped and launches nothing.  Its exact path is the unfused streaming
softmax (``_block_attn_update``).  ``ulysses_attention`` swaps sequence
sharding for head sharding, attends over whole sequences for a group of
heads, and swaps back.

One per-rank body serves both kinds of mesh (``parallel.mesh``); only
the rotation differs:

- on a ``VirtualMesh`` (one process, one device) the functions take the
  global [B, S, H, D] arrays, cut the cp blocks, run the ranks one after
  another, and the rotation is indexing into the blocks;
- on a ``DeviceMesh`` (``torch.distributed``) each rank passes its own
  [B, S/cp, H, D] shard and gets its shard of the output; the rotation
  is a ``batch_isend_irecv`` ring shift (its backward shifts the
  gradient the other way, as autodiff of ``lax.ppermute`` does), posted
  before the block's compute and waited for when the next rotation
  needs it, and Ulysses' swaps are ``all_to_all_single``.  A ``dp`` axis
  composes as in the JAX package: each dp group runs its own cp ring
  over the batch it holds.

Everything is differentiable with autograd.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..kernels.flash_attention import flash_attention_with_carry
from ..kernels.flash_attention import mha_reference
from .mesh import VirtualMesh, axis_size

NEG_INF = -1e30
_IMPLS = ("flash", "exact")


def _block_attn_update(q, k, v, bias, m, l, o):
    """One streaming-softmax step.  q [B, Sq, H, D]; k, v [B, Sk, H, D];
    bias [Sq, Sk] additive (0 or NEG_INF); m, l [B, H, Sq]; o [B, Sq, H,
    D].  Computes in q's dtype, as the JAX package does."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s + bias[None, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows where everything so far is masked keep m_new == NEG_INF
    safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
    alpha = torch.where(m <= NEG_INF / 2, 0.0, alpha)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] \
        + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _finalize(l, o):
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return o / denom


def _causal_bias(q_start, kv_start, n_q, n_kv, dtype, device):
    q_pos = q_start + torch.arange(n_q, device=device)
    kv_pos = kv_start + torch.arange(n_kv, device=device)
    return torch.where(q_pos[:, None] >= kv_pos[None, :], 0.0,
                       NEG_INF).to(dtype)


def _ring_rank(q, k, v, *, my, cp, causal, impl, shift):
    """One rank's ring: q, k, v its [B, blk, H, D] blocks; ``shift(t,
    k_t, v_t)`` posts rotation t's K/V move and returns a callable that
    waits for it and gives the next (k, v).  Returns its output block in
    q's dtype and the last rotation's (k, v)."""
    B, blk, H, D = q.shape
    dev = q.device
    if impl == "flash":
        o = torch.zeros((B, blk, H, D), dtype=torch.float32, device=dev)
        lse = torch.full((B, H, blk), NEG_INF, dtype=torch.float32,
                         device=dev)
    else:
        m = torch.full((B, H, blk), NEG_INF, dtype=q.dtype, device=dev)
        l = torch.zeros((B, H, blk), dtype=q.dtype, device=dev)
        o = torch.zeros_like(q)
    k_t, v_t = k, v
    for t in range(cp):
        # the rotation first: it does not depend on this block's compute
        nxt = shift(t, k_t, v_t) if t + 1 < cp else None
        # after t rotations this rank holds rank (my - t)'s K/V block
        owner = (my - t) % cp
        if impl == "flash":
            if not causal or owner < my:          # wholly live
                o, lse = flash_attention_with_carry(q, k_t, v_t, o, lse,
                                                    causal=False)
            elif owner == my:                     # the diagonal
                o, lse = flash_attention_with_carry(q, k_t, v_t, o, lse,
                                                    causal=True)
            # else wholly above the diagonal: skipped, nothing launched
        else:
            if causal:
                bias = _causal_bias(my * blk, owner * blk, blk, blk,
                                    q.dtype, dev)
            else:
                bias = torch.zeros((blk, blk), dtype=q.dtype, device=dev)
            m, l, o = _block_attn_update(q, k_t, v_t, bias, m, l, o)
        if nxt is not None:
            k_t, v_t = nxt()
    out = o.to(q.dtype) if impl == "flash" else _finalize(l, o)
    return out, k_t, v_t


# ------------------------------------------------------------------ #
# the rotation under torch.distributed
# ------------------------------------------------------------------ #


def _post_shift(sends, recvs, group, step):
    """Post sends of ``sends`` to the rank ``step`` ahead on ``group``'s
    ring and receives into ``recvs`` from the rank ``step`` behind;
    returns the works."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    ops = [dist.P2POp(dist.isend, x, to, group=group) for x in sends] \
        + [dist.P2POp(dist.irecv, y, frm, group=group) for y in recvs]
    return dist.batch_isend_irecv(ops)


class _RingShift(torch.autograd.Function):
    """(k, v) moved one rank along the ring; the forward only posts the
    transfer (its works and the sent tensors go into ``pending``, to be
    waited on before the outputs are read); the backward sends the
    gradients one rank back and waits."""

    @staticmethod
    def forward(ctx, k, v, group, pending):
        ctx.group = group
        sends = (k.contiguous(), v.contiguous())
        outs = (torch.empty_like(sends[0]), torch.empty_like(sends[1]))
        pending["works"] = _post_shift(sends, outs, group, 1)
        pending["sends"] = sends     # alive until the sends complete
        return outs

    @staticmethod
    def backward(ctx, gk, gv):
        sends = (gk.contiguous(), gv.contiguous())
        outs = (torch.empty_like(sends[0]), torch.empty_like(sends[1]))
        for w in _post_shift(sends, outs, ctx.group, -1):
            w.wait()
        return outs[0], outs[1], None, None


class _RingJoin(torch.autograd.Function):
    """The output, tied to the last rotation's (k, v) with a zero
    gradient, so every rank runs the whole chain of shift backwards even
    where the causal ring skipped the blocks it received (rank 0 uses
    none of them): the ranks' sends and receives then pair up, as the
    transpose of ``lax.ppermute`` always runs in JAX."""

    @staticmethod
    def forward(ctx, out, k, v):
        ctx.like = [(x.shape, x.dtype, x.device) for x in (k, v)]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=d)
                            for s, t, d in ctx.like)


def _dist_shift(group):
    def shift(t, k_t, v_t):
        pending = {}
        k_n, v_n = _RingShift.apply(k_t, v_t, group, pending)

        def wait():
            for w in pending["works"]:
                w.wait()
            return k_n, v_n
        return wait
    return shift


# ------------------------------------------------------------------ #
# the entry points
# ------------------------------------------------------------------ #


def _check_virtual(mesh, q, what):
    dev = mesh.device
    if q.device.type != dev.type or (dev.index is not None
                                     and q.device.index != dev.index):
        raise ValueError(f"{what}: q is on {q.device}, the mesh on {dev}")


def _blocks(x, n):
    return [c.contiguous() for c in x.chunk(n, dim=1)]


def ring_attention(q, k, v, *, mesh, axis="cp", causal=False, impl=None):
    """Blockwise ring attention over the ``axis`` ranks of ``mesh``.

    On a ``VirtualMesh``, q, k, v are the global [B, S, H, D] tensors
    (S divisible by the axis size) and the result is the global output;
    on a ``DeviceMesh``, each rank passes its sequence shard and gets its
    output shard.  ``causal`` masks by global position.  ``impl``:
    ``"flash"`` runs the carried flash kernel on each live rotation (its
    plain version on CPU tensors) and skips the rotations above the
    causal diagonal; ``"exact"`` the unfused streaming softmax; ``None``
    is flash on CUDA tensors and exact otherwise.  The output has q's
    dtype."""
    if impl is None:
        impl = "flash" if q.is_cuda else "exact"
    if impl not in _IMPLS:
        raise ValueError(f"ring_attention impl must be 'flash', 'exact' "
                         f"or None (auto), got {impl!r}")
    cp = axis_size(mesh, axis)
    if isinstance(mesh, VirtualMesh):
        _check_virtual(mesh, q, "ring_attention")
        S = q.shape[1]
        if S % cp:
            raise ValueError(f"seq {S} not divisible by {axis}={cp}")
        qs, ks, vs = (_blocks(x, cp) for x in (q, k, v))
        outs = []
        for r in range(cp):
            def shift(t, k_t, v_t, r=r):
                src = (r - t - 1) % cp
                return lambda: (ks[src], vs[src])
            outs.append(_ring_rank(qs[r], ks[r], vs[r], my=r, cp=cp,
                                   causal=causal, impl=impl,
                                   shift=shift)[0])
        return torch.cat(outs, dim=1)
    out, k_t, v_t = _ring_rank(q.contiguous(), k.contiguous(),
                               v.contiguous(),
                               my=mesh.get_local_rank(axis), cp=cp,
                               causal=causal, impl=impl,
                               shift=_dist_shift(mesh.get_group(axis)))
    return _RingJoin.apply(out, k_t, v_t)


def _exact_attn(q, k, v, causal):
    return mha_reference(q, k, v, causal=causal)


def _all_to_all(x, group):
    """all_to_all_single with autograd over ``group``: chunk j of dim 0
    goes to rank j, and chunk i of the result came from rank i."""
    from torch.distributed.nn.functional import all_to_all_single
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention(q, k, v, *, mesh, axis="cp", causal=False,
                      attn_fn=None):
    """DeepSpeed-Ulysses: sequence sharding swapped for head sharding,
    whole-sequence attention per head group, and back.  Needs the axis
    size to divide H.  ``attn_fn(q, k, v, causal)`` is the local
    attention over [B, S, H/cp, D] (contiguous); the default is exact
    attention (``mha_reference``), as the JAX package's is.  Global
    tensors on a ``VirtualMesh``, shards on a ``DeviceMesh``, as
    :func:`ring_attention`."""
    cp = axis_size(mesh, axis)
    B, S, H, D = q.shape
    if H % cp:
        raise ValueError(f"heads {H} not divisible by {axis}={cp}")
    attn_fn = attn_fn or _exact_attn
    hs = H // cp
    if isinstance(mesh, VirtualMesh):
        _check_virtual(mesh, q, "ulysses_attention")
        if S % cp:
            raise ValueError(f"seq {S} not divisible by {axis}={cp}")
        outs = [attn_fn(*(x[:, :, r * hs:(r + 1) * hs].contiguous()
                          for x in (q, k, v)), causal)
                for r in range(cp)]
        return torch.cat(outs, dim=2)
    group = mesh.get_group(axis)

    def seq_to_head(x):
        # [B, s, H, D] -> chunks by head group -> [B, cp * s, H/cp, D]
        x = x.reshape(B, S, cp, hs, D).permute(2, 0, 1, 3, 4).contiguous()
        x = _all_to_all(x, group)                  # [cp (seq), B, s, ..]
        return x.permute(1, 0, 2, 3, 4).reshape(B, cp * S, hs, D)

    def head_to_seq(x):
        x = x.reshape(B, cp, S, hs, D).permute(1, 0, 2, 3, 4).contiguous()
        x = _all_to_all(x, group)                  # [cp (heads), B, s, ..]
        return x.permute(1, 2, 0, 3, 4).reshape(B, S, H, D)

    ql, kl, vl = (seq_to_head(x) for x in (q, k, v))
    return head_to_seq(attn_fn(ql, kl, vl, causal))


def blockwise_attention(q, k, v, *, block_size=512, causal=False):
    """Single-device blockwise (memory-efficient) attention with the
    ring's streaming-softmax math: the cp = 1 case and a numerics
    oracle.  q [B, S, H, D]; k, v [B, Sk, H, D]."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    blk = min(block_size, Sk)
    m = torch.full((B, H, S), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, S), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    for start in range(0, Sk, blk):
        kj, vj = k[:, start:start + blk], v[:, start:start + blk]
        n = kj.shape[1]
        if causal:
            bias = _causal_bias(0, start, S, n, q.dtype, q.device)
        else:
            bias = torch.zeros((S, n), dtype=q.dtype, device=q.device)
        m, l, o = _block_attn_update(q, kj, vj, bias, m, l, o)
    return _finalize(l, o)
