"""The arithmetic of the f32 flash forward on the tensor cores (K2
``flash_fwd`` and K2-carry ``flash_fwd_carry`` in f32,
csrc/flash_fwd.cu + flash_tf32.cuh) against the JAX package's Pallas
forward in interpret mode, within the f32 tolerance the card holds the
kernel to.

The tensor cores take f32 operands only as TF32 (10 mantissa bits,
rounded by ``cvt.rna``: to nearest, ties away from zero).  The kernel
splits each f32 operand x into x_hi = tf32(x) and x_lo = tf32(x - x_hi)
and forms every product of S = Q K^T and O += P V as a_lo b_hi + a_hi
b_lo + a_hi b_hi, three TF32 passes into one f32 accumulator (each TF32
product exact in f32), as the Pallas body runs f32 at
Precision.HIGHEST.  :func:`_emulate` is that arithmetic in PyTorch on
the CPU, in the kernel's order: key tiles of 64 positions (32 at head
dim 128) up to the live end of the 64-row q tile, the online softmax in
log2 units against the running max (p = 2^(s scale log2 e - m), dead
keys at NEG_INF, the max clamped to 0 while nothing is live), P split
after the exp, and the carry's seed (m = lse_c, l = 1, acc = o_c).  It
is held to JAX's f32 forward within 1e-5 (o; the carried o also 1e-5
relative, as the card holds K2-carry) and 1e-5 (lse), over causal and
full attention, kv_lens with 0 and 1, a carry empty, live or mixed row
by row, head dims 32, 64 and 128 and lengths that are not multiples of
the tiles.  One TF32 pass (a_hi b_hi alone) misses that tolerance: the
split is what holds it.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa

NEG_INF = -1e30
LOG2E = 1.4426950408889634
B, H = 3, 2
ATOL = 1e-5
CARRY_RTOL = 1e-5


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


def bk_of(D):
    """Keys per K/V tile of the kernel."""
    return 32 if D == 128 else 64


def _emulate(q, k, v, *, causal, kv_lens=None, carry=None, passes=3):
    """The kernel's arithmetic on [B, S, H, D] f32: (o [B, S, H, D], lse
    [B, H, S], +1e30 on a row with no live key)."""
    Bn, S, Hn, D = q.shape
    Sk = k.shape[1]
    BK = bk_of(D)
    scale_log2 = np.float32(D ** -0.5) * np.float32(LOG2E)
    o = torch.zeros_like(q)
    lse = torch.zeros((Bn, Hn, S))
    for b in range(Bn):
        kvlen = Sk if kv_lens is None else min(max(int(kv_lens[b]), 0), Sk)
        for h in range(Hn):
            for q0 in range(0, S, 64):
                rows = torch.arange(q0, min(q0 + 64, S))
                qt = q[b, rows, h]
                lim = torch.full((len(rows),), kvlen - 1)
                kv_end = kvlen
                if causal:
                    lim = torch.minimum(lim, rows)
                    kv_end = min(kvlen, int(rows[-1]) + 1)
                m = torch.full((len(rows),), NEG_INF)
                l = torch.zeros(len(rows))
                acc = torch.zeros((len(rows), D))
                if carry is not None:
                    oc, lc = carry[0][b, rows, h], carry[1][b, h, rows]
                    live = lc > NEG_INF / 2
                    m = torch.where(live, lc * np.float32(LOG2E), m)
                    l = torch.where(live, torch.ones_like(l), l)
                    acc = torch.where(live[:, None], oc, acc)
                for t0 in range(0, kv_end, BK):
                    keys = torch.arange(t0, min(t0 + BK, kv_end))
                    s = product(qt, k[b, keys, h].T, passes)
                    s = torch.where(keys[None] <= lim[:, None], s,
                                    torch.full_like(s, NEG_INF))
                    mx = s.amax(-1)
                    m_new = torch.maximum(m, torch.where(
                        mx <= NEG_INF / 2, torch.full_like(mx, NEG_INF),
                        mx * scale_log2))
                    safe = torch.where(m_new <= NEG_INF / 2,
                                       torch.zeros_like(m_new), m_new)
                    alpha = torch.where(m <= NEG_INF / 2,
                                        torch.zeros_like(m),
                                        torch.exp2(m - m_new))
                    p = torch.exp2(s * scale_log2 - safe[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + product(p, v[b, keys, h],
                                                         passes)
                    m = m_new
                denom = torch.where(l == 0, torch.ones_like(l), l)
                o[b, rows, h] = acc / denom[:, None]
                lse[b, h, rows] = torch.where(
                    (l == 0) | (m <= NEG_INF / 2),
                    torch.full_like(l, -NEG_INF),
                    m / np.float32(LOG2E) + torch.log(l))
    return o, lse


def _fold(x):
    """[B, S, H, D] numpy -> the JAX kernels' [B*H, S, D] f32."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                       jnp.float32)


def _unfold(x, b, h):
    x = np.asarray(x, np.float32)
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _qkv(seed, s, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, s, H, d).astype(np.float32),
            rng.randn(B, sk, H, d).astype(np.float32),
            rng.randn(B, sk, H, d).astype(np.float32))


def _carry(seed, s, d, kind):
    rng = np.random.RandomState(seed)
    o_c = rng.randn(B, s, H, d).astype(np.float32)
    lse_c = (2.0 * rng.randn(B, H, s) + 3.0).astype(np.float32)
    if kind == "empty":
        o_c[:] = 0.0
        lse_c[:] = NEG_INF
    elif kind == "mixed":
        lse_c[..., ::3] = NEG_INF
    return o_c, lse_c


def _k2(D, causal, S, Sk, with_lens, passes=3):
    """(JAX's f32 (o, lse), the emulation's) on one case; kv_lens of the
    three sequences partial, 0 and 1 when ``with_lens``."""
    q, k, v = _qkv(D + S + Sk, S, Sk, D)
    kv = np.array([Sk - 3, 0, 1], np.int32) if with_lens else None
    jo, jl = jfa._flash_fwd(_fold(q), _fold(k), _fold(v),
                            jnp.asarray(np.repeat(kv, H))
                            if with_lens else None, causal=causal,
                            block_q=S, block_k=Sk, interpret=True)
    want = (_unfold(jo, B, H), np.asarray(jl).reshape(B, H, S))
    got = _emulate(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                   kv_lens=kv, passes=passes)
    return want, tuple(x.numpy() for x in got)


# (causal, S, Sk): the 64-row q tile's ragged edge, key tiles of 64 (and
# 32 at D 128) crossed with a ragged last one, Sk > S without the causal
# mask
CASES = [(True, 100, 100), (False, 40, 150), (False, 70, 33)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", CASES)
@pytest.mark.parametrize("with_lens", [True, False])
def test_three_tf32_passes_hold_f32_parity(D, causal, S, Sk, with_lens):
    """K2's f32 arithmetic on the tensor cores against JAX's f32 forward:
    o within 1e-5, lse within 1e-5 (+1e30 exactly on rows with no live
    key), the kv_lens-0 sequence zero."""
    (want_o, want_l), (o, lse) = _k2(D, causal, S, Sk, with_lens)
    np.testing.assert_allclose(o, want_o, atol=ATOL, rtol=0)
    dead = want_l >= 1e29
    assert np.array_equal(lse >= 1e29, dead)
    np.testing.assert_allclose(lse[~dead], want_l[~dead], atol=1e-5, rtol=0)
    if with_lens:
        assert (o[1] == 0).all()


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", CASES[:2])
@pytest.mark.parametrize("kind", ["empty", "live", "mixed"])
def test_three_tf32_passes_hold_the_carry(D, causal, S, Sk, kind):
    """K2-carry's f32 arithmetic (the carry seeds m, l and acc) against
    JAX's carried f32 forward: o within 1e-5 + 1e-5 rel, lse 1e-5."""
    q, k, v = _qkv(D + Sk, S, Sk, D)
    o_c, lse_c = _carry(D, S, D, kind)
    jo, jl = jfa._flash_fwd(
        _fold(q), _fold(k), _fold(v), None, causal=causal, block_q=S,
        block_k=Sk, interpret=True,
        carry=(_fold(o_c), jnp.asarray(lse_c.reshape(B * H, 1, S))))
    o, lse = _emulate(*(torch.from_numpy(x) for x in (q, k, v)),
                      causal=causal,
                      carry=(torch.from_numpy(o_c), torch.from_numpy(lse_c)))
    np.testing.assert_allclose(o.numpy(), _unfold(jo, B, H), atol=ATOL,
                               rtol=CARRY_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl).reshape(B, H, S),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [64, 128])
def test_one_tf32_pass_misses_f32_parity(D):
    """A single TF32 pass (a_hi b_hi) is about 2^-11 off per product: it
    misses 1e-5 on the same case, so the split is needed."""
    (want_o, _), (o, _) = _k2(D, True, 100, 100, False, passes=1)
    assert np.abs(o - want_o).max() > 10 * ATOL


def test_tf32_rounding_is_round_half_away_from_zero():
    """tf32() keeps 10 mantissa bits, ties away from zero, and splits x
    into two TF32 parts within 2^-21 |x|."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, one], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one]
    y = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    hi, lo = split(y)
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()
    assert ((y - hi - lo).abs() <= 2.0 ** -21 * y.abs()).all()
