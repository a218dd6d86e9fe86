"""The arithmetic of the f32 flash backward on the tensor cores (K3's
``flash_bwd_dkv`` and ``flash_bwd_dq`` in f32, csrc/flash_bwd.cu +
flash_tf32.cuh) against the JAX package's Pallas backward in interpret
mode and against the plain versions the card holds the kernels to.

The tensor cores take f32 operands only as TF32 (10 mantissa bits,
rounded by ``cvt.rna``: to nearest, ties away from zero).  The kernels
split each f32 operand x into x_hi = tf32(x) and x_lo = tf32(x - x_hi)
and form every product (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK +=
dS^T Q in dK/dV; S = Q K^T, dP = dO V^T, dQ += dS K in dQ) as a_lo b_hi
+ a_hi b_lo + a_hi b_hi, three TF32 passes into one f32 accumulator, as
the Pallas bodies run f32 at Precision.HIGHEST.  :func:`_emulate` is
that arithmetic in PyTorch on the CPU, in the kernels' order: the block's
64-row tile (kv rows in dK/dV, q rows in dQ) against streamed tiles of
32 rows (64 at head dim 32), from the diagonal when causal (dK/dV) and
up to min(kv_len, the tile's causal limit) (dQ), P = 2^(s scale log2 e
- lse log2 e) with the exponent one fused multiply-add, dS = P (dP -
delta) scale from the unrounded P, P^T and dS^T split after they are
formed.  It is held to JAX's f32 ``_flash_bwd`` and to the plain
versions within 1e-5 + 1e-5 |want| for dQ, dK and dV, over causal and
full attention, kv_lens with 0 and a full length, Sk > S, an lse
cotangent, head dims 32, 64 and 128 and lengths that are not multiples
of the tiles.  One TF32 pass (a_hi b_hi alone) misses that tolerance:
the split is what holds it.  Last, the kernels' shared-memory swizzle
serves both ways a streamed tile is read without a bank conflict.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu_torch.kernels import flash_attention as tfa

LOG2E = 1.4426950408889634
B, H = 3, 2
OWN = 64           # rows of a block's own tile
ATOL = RTOL = 1e-5


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` (the kernel's integer
    add to the magnitude and mask of the 13 low bits), as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, passes):
    """a @ b from the TF32 parts of a and b: 3 passes (lo hi + hi lo + hi
    hi) or 1 (hi hi), in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def stream_rows(D):
    """Rows of a streamed tile of the kernels."""
    return 64 if D == 32 else 32


def _p_ds(s, dp, lse2, delta, live, scale_log2, scale):
    """P and dS of a tile as the kernels form them: P = 2^(fma(s,
    scale log2 e, -lse log2 e)) on live pairs, else 0; dS = (P (dP -
    delta)) scale, each product rounded.  lse2 and delta broadcast
    against s."""
    x = (s.double() * float(scale_log2) - lse2.double()).float()
    p = torch.where(live, torch.exp2(x), torch.zeros_like(x))
    return p, (p * (dp - delta)) * np.float32(scale)


def _emulate(q, k, v, do, lse, delta, *, causal, kv_lens=None, passes=3):
    """The kernels' arithmetic on [B, S, H, D] f32 (lse, delta [B, H, S]
    f32): (dq, dk, dv)."""
    Bn, S, Hn, D = q.shape
    Sk = k.shape[1]
    BS = stream_rows(D)
    scale = np.float32(D ** -0.5)
    scale_log2 = np.float32(scale * np.float32(LOG2E))
    lse2 = lse * np.float32(LOG2E)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for b in range(Bn):
        kvlen = Sk if kv_lens is None else min(max(int(kv_lens[b]), 0), Sk)
        for h in range(Hn):
            # dK/dV: one block per 64-row kv tile, streaming q tiles
            for j0 in range(0, Sk, OWN):
                keys = torch.arange(j0, min(j0 + OWN, Sk))
                kt, vt = k[b, keys, h], v[b, keys, h]
                ak = torch.zeros((len(keys), D))
                av = torch.zeros((len(keys), D))
                q_end = S if j0 < kvlen else 0
                for i0 in range(j0 if causal else 0, q_end, BS):
                    rows = torch.arange(i0, min(i0 + BS, S))
                    qt, gt = q[b, rows, h], do[b, rows, h]
                    st = product(kt, qt.T, passes)
                    dpt = product(vt, gt.T, passes)
                    live = (keys[:, None] < kvlen) & (
                        ~torch.tensor(causal) | (rows[None] >= keys[:, None]))
                    pt, dst = _p_ds(st, dpt, lse2[b, h, rows][None],
                                    delta[b, h, rows][None], live,
                                    scale_log2, scale)
                    av = av + product(pt, gt, passes)
                    ak = ak + product(dst, qt, passes)
                dk[b, keys, h], dv[b, keys, h] = ak, av
            # dQ: one block per 64-row q tile, streaming kv tiles
            for i0 in range(0, S, OWN):
                rows = torch.arange(i0, min(i0 + OWN, S))
                qt, gt = q[b, rows, h], do[b, rows, h]
                kv_end = min(kvlen, i0 + len(rows)) if causal else kvlen
                acc = torch.zeros((len(rows), D))
                for t0 in range(0, kv_end, BS):
                    keys = torch.arange(t0, min(t0 + BS, kv_end))
                    kt, vt = k[b, keys, h], v[b, keys, h]
                    s = product(qt, kt.T, passes)
                    dp = product(gt, vt.T, passes)
                    live = (keys[None] < kvlen) & (
                        ~torch.tensor(causal) | (rows[:, None] >= keys[None]))
                    _, ds = _p_ds(s, dp, lse2[b, h, rows][:, None],
                                  delta[b, h, rows][:, None], live,
                                  scale_log2, scale)
                    acc = acc + product(ds, kt, passes)
                dq[b, rows, h] = acc
    return dq, dk, dv


def _fold(x):
    """[B, S, H, D] numpy -> the JAX kernels' [B*H, S, D] f32."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                       jnp.float32)


def _unfold(x, b, h):
    x = np.asarray(x, np.float32)
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _k3(D, causal, S, Sk, with_lens, with_g_lse=False, passes=3):
    """(JAX's f32 (dq, dk, dv), the plain versions', the emulation's) on
    one case, from the plain forward's (o, lse); kv_lens of the three
    sequences Sk - 3, 0 and Sk when ``with_lens``."""
    rng = np.random.RandomState(D + S + Sk + causal)
    q, do = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, Sk, H, D).astype(np.float32) for _ in range(2))
    kv = np.array([Sk - 3, 0, Sk], np.int32) if with_lens else None
    g_lse = rng.randn(B, H, S).astype(np.float32) if with_g_lse else None
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tkv = torch.from_numpy(kv) if with_lens else None
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, causal=causal, kv_lens=tkv)
    tg = torch.from_numpy(g_lse) if with_g_lse else None
    delta = tfa.bwd_delta(o, tdo, tg)
    jq, jk, jv = jfa._flash_bwd(
        _fold(q), _fold(k), _fold(v),
        jnp.asarray(np.repeat(kv, H)) if with_lens else None,
        _fold(o.numpy()), jnp.asarray(lse.numpy().reshape(B * H, 1, S)),
        _fold(do), causal=causal, block_q=S, block_k=Sk, interpret=True,
        g_lse=jnp.asarray(g_lse.reshape(B * H, S)) if with_g_lse else None)
    want = tuple(_unfold(x, B, H) for x in (jq, jk, jv))
    args = (tq, tk, tv, tkv, lse, delta, tdo)
    pk, pv = tfa.flash_bwd_dkv_reference(*args, causal=causal)
    plain = (tfa.flash_bwd_dq_reference(*args, causal=causal).numpy(),
             pk.numpy(), pv.numpy())
    got = _emulate(tq, tk, tv, tdo, lse, delta, causal=causal,
                   kv_lens=kv, passes=passes)
    return want, plain, tuple(x.numpy() for x in got)


# (causal, S, Sk, kv_lens, lse cotangent): the 64-row own tile's ragged
# edge crossed with streamed tiles of 32 (64 at D 32) and a ragged last
# one, kv_lens 0 and full, Sk > S causal and not
CASES = [(True, 100, 100, True, False), (False, 40, 150, True, False),
         (True, 40, 72, False, False), (False, 70, 33, False, True),
         (True, 130, 130, False, True)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk,with_lens,with_g_lse", CASES)
def test_three_tf32_passes_hold_f32_parity(D, causal, S, Sk, with_lens,
                                           with_g_lse):
    """K3's f32 arithmetic on the tensor cores against JAX's f32 backward
    and the plain versions: dq, dk and dv within 1e-5 + 1e-5 |want|; the
    kv_lens-0 sequence's gradients zero."""
    want, plain, got = _k3(D, causal, S, Sk, with_lens, with_g_lse)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(g, p, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} vs the plain version")
        if with_lens:
            assert (g[1] == 0).all()


@pytest.mark.parametrize("D", [64, 128])
def test_one_tf32_pass_misses_f32_parity(D):
    """A single TF32 pass (a_hi b_hi) is about 2^-11 off per product: it
    misses 1e-5 + 1e-5 |want| on the same case, so the split is
    needed."""
    want, _, got = _k3(D, True, 100, 100, True, passes=1)
    worst = max(float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max())
                for g, w in zip(got, want))
    assert worst > 10


def _swizzle(r, c, D):
    """The kernels' float offset of (row r, column c) of a [rows][D]
    tile (``sw`` in csrc/flash_bwd.cu)."""
    x = r & 7
    return r * D + (c ^ (((x ^ ((x >> 2) * 3)) & 3) << 3))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_swizzle_serves_both_read_patterns(D):
    """Each half-warp's 8-byte pair loads (row 8n + g, columns 8c + 2t
    and 8c + 2t + 1) and each warp's 4-byte column loads (rows 8n + 2t
    + e at column 8j + g) hit 32 different banks, every 16-byte copy
    chunk stays whole and 16-byte aligned, and the layout is one to one
    on the tile."""
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for n in range(4):
        for c in range(D // 8):
            for half in (lanes[:16], lanes[16:]):
                banks = [(_swizzle(8 * n + g, 8 * c + 2 * t, D) + w) % 32
                         for g, t in half for w in (0, 1)]
                assert len(set(banks)) == 32
                assert all(_swizzle(8 * n + g, 8 * c + 2 * t, D) % 2 == 0
                           for g, t in half)
        for j in range(D // 8):
            for e in (0, 1):
                banks = [_swizzle(8 * n + 2 * t + e, 8 * j + g, D) % 32
                         for g, t in lanes]
                assert len(set(banks)) == 32
    offs = {_swizzle(r, c, D) for r in range(64) for c in range(D)}
    assert offs == set(range(64 * D))
    for r in range(64):
        for c4 in range(0, D, 4):
            o = _swizzle(r, c4, D)
            assert o % 4 == 0
            assert [_swizzle(r, c4 + i, D) for i in range(4)] == \
                [o + i for i in range(4)]
