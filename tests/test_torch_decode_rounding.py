"""The bf16 decode kernels (K4 ``paged_decode_attention``, K5
``paged_block_decode_attention``) against the JAX package's Pallas
kernels in interpret mode, and the bound that holds them:
``ragged_attention.ragged_rounding_bound``.

The Pallas decode body (``_decode_kernel`` / ``_block_decode_kernel`` ->
``_online_softmax_update``) rounds P = exp(s - m) to bf16 before P V
(``decode_attention.py:85``, ``p.astype(v.dtype)``) and sums the
denominator from the unrounded P; the port's plain versions keep P in
f32 (they are the engine's CPU path and the kernels' yardstick, and stay
as they are).  One rounding is within 2^-8 of p, whatever max it is
taken against, so each element of o moves by at most 2^-8 sum(p |v_d|)
/ l: 2^-8 times the plain version run on (q, k, |v|), which is what
``ragged_rounding_bound`` computes for a decode wave too (a decode wave
is a ragged wave of one row).  So the bf16 Pallas kernels are held to
the plain versions within ``2^-12 + 2^-7 |want| + ragged_rounding_bound``
element by element (2^-12 for the f32 sums in another order, one bf16
ulp for the output's own rounding), over waves with many KV blocks of
16 positions, so the Pallas running max moves between blocks
(``block_k=16`` over the slot rows; the pool's blocks are 16 positions):
head dims 32, 64 and 128; lengths on and off block and split edges, a
length-0 slot, and two slots sharing pool blocks.  The same waves
without the bound fall outside the bf16 ulp tolerance, so the bound is
what lets them pass.

The card's bf16 K4/K5 (csrc/decode_attention_bf16.cu) run the split-K
body of split_kv_bf16.cuh with the query as its one row: 128-position
splits, the max of each warp's 32 keys, P = 2^(s scale log2 e - m)
rounded to bf16 for P V, l from the unrounded P, the warps and then the
splits merged in f32.  :func:`_emulate` is that arithmetic in PyTorch
on the CPU; it rounds P against other maxima than the Pallas body, each
within half a bf16 ulp of p, so it is held to JAX within the same bound.
"""

import math

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import ragged_attention as tra

H, BS, T = 2, 16, 20
ATOL, RTOL = 2.0 ** -12, 2.0 ** -7
SPLIT, WARP_KEYS = 128, 32        # split_kv_bf16.cuh's kSplit, kSplitKW


def _wave(Dh, seed):
    """Eight slots over a permuted pool of 16-position blocks (tables of
    20 entries, 320 positions): lengths 300 (three key splits, off the
    block edges), 256 (on a split edge), 131, 128, 16 (on block edges),
    5, 0, and 33, whose first two blocks are slot 2's.  Returns numpy
    (q [B, H, Dh], pool_k, pool_v, lengths, tables)."""
    lengths = np.array([300, 256, 131, 128, 16, 5, 0, 33], np.int32)
    B = len(lengths)
    rng = np.random.RandomState(seed)
    need = [-(-int(n) // BS) for n in lengths]
    N = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    tables[7, :2] = tables[2, :2]                  # a shared prefix
    pk = rng.randn(N, BS, H, Dh).astype(np.float32)
    pv = rng.randn(N, BS, H, Dh).astype(np.float32)
    q = rng.randn(B, H, Dh).astype(np.float32)
    return q, pk, pv, lengths, tables


def _bf16(x):
    """numpy f32 -> (the bf16 torch tensor, the same values for JAX)."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _slot_rows(pool, tables):
    B, T_ = tables.shape
    return pool[tables].reshape(B, T_ * pool.shape[1], *pool.shape[2:])


def _emulate(q, k, v, lengths):
    """The split-K body's arithmetic at Q 1 over slot rows (q [B, H, Dh],
    k/v [B, S, H, Dh] bf16), in f32: scores from the bf16 operands, keys
    past the slot's length at NEG_INF; per warp of 32 keys its raw max
    m_w (log2 units), p = 2^(s scale log2 e - m_w), l_w = sum p, acc_w =
    bf16(p) . v; the four warps of a split, then the splits, merged by
    2^(m_i - M) in f32, skipping those with no live key; o = acc / l
    rounded to bf16, zeros on a length-0 slot."""
    B, Hn, Dh = q.shape
    S = k.shape[1]
    n = -(-S // SPLIT)
    pad = n * SPLIT - S
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    neg = tra.NEG_INF
    s = torch.einsum("bhd,bshd->bhs", q.float(), k)
    live = torch.arange(n * SPLIT)[None, None] < lengths.long()[:, None,
                                                                None]
    s = torch.where(live, s, torch.full_like(s, neg))
    s = s.reshape(B, Hn, -1, WARP_KEYS)              # [B, H, warps, 32]
    c = Dh ** -0.5 * math.log2(math.e)
    mx = s.amax(-1)
    m = torch.where(mx <= neg / 2, torch.full_like(mx, neg), mx * c)
    safe = torch.where(m <= neg / 2, torch.zeros_like(m), m)
    p = torch.exp2(s * c - safe[..., None])
    vw = v.reshape(B, -1, WARP_KEYS, Hn, Dh)
    acc = torch.einsum("bhwk,bwkhd->bhwd", p.bfloat16().float(), vw)
    l = p.sum(-1)

    def merge(m, l, acc, group):
        """Combine groups of ``group`` consecutive partials."""
        m = m.reshape(B, Hn, -1, group)
        l = l.reshape(B, Hn, -1, group)
        acc = acc.reshape(B, Hn, -1, group, Dh)
        top = m.amax(-1, keepdim=True)
        w = torch.where(m > neg / 2, torch.exp2(m - top),
                        torch.zeros_like(m))
        return (top[..., 0], (w * l).sum(-1),
                (w[..., None] * acc).sum(-2))

    m, l, acc = merge(m, l, acc, SPLIT // WARP_KEYS)  # a split's warps
    _, l, acc = merge(m, l, acc, n)                   # the splits
    o = acc[:, :, 0] / torch.where(l == 0, torch.ones_like(l), l)[..., 0,
                                                                    None]
    return o.bfloat16()


def _case(layout, Dh, seed):
    """(JAX's bf16 o as f32 numpy, the port's plain o, its bound, the
    emulated kernel's o), one decode wave through K4 (``slots``) or K5
    (``pool``)."""
    q, pk, pv, lens, tab = _wave(Dh, seed)
    (qt, qj), (kt, kj), (vt, vj) = _bf16(q), _bf16(pk), _bf16(pv)
    L = torch.from_numpy(lens)
    ones = torch.ones_like(L)
    Tt = torch.from_numpy(tab)
    if layout == "slots":
        rk, rv = _slot_rows(pk, tab), _slot_rows(pv, tab)
        (kt, kj), (vt, vj) = _bf16(rk), _bf16(rv)
        want = jda.paged_decode_attention(qj, kj, vj, jnp.asarray(lens),
                                          block_k=BS, interpret=True)
        got = tda.paged_decode_attention(qt, kt, vt, L)
        bound = tra.ragged_rounding_bound(qt[:, None], kt, vt, L, ones)
        rows_k, rows_v = kt, vt
    else:
        want = jda.paged_block_decode_attention(
            qj, kj, vj, jnp.asarray(lens), jnp.asarray(tab),
            interpret=True)
        got = tda.paged_block_decode_attention(qt, kt, vt, L, Tt)
        bound = tra.ragged_rounding_bound(qt[:, None], kt, vt, L, ones, Tt)
        rows_k, rows_v = (x[Tt.long()].reshape(len(lens), T * BS, H, Dh)
                          for x in (kt, vt))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    return (np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy(),
            bound[:, 0].numpy(),
            _emulate(qt, rows_k, rows_v, L).float().numpy())


def _ratio(want, got, bound=0.0):
    """The largest |got - want| / (2^-12 + 2^-7 |want| + bound)."""
    return float((np.abs(got - want)
                  / (ATOL + RTOL * np.abs(want) + bound)).max())


@pytest.mark.parametrize("layout", ["pool", "slots"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_bf16_pallas_decode_within_the_rounding_bound(layout, Dh):
    """JAX's bf16 Pallas decode kernel (P rounded before P V) against the
    port's plain version (P in f32): within 2^-12 + 2^-7 |want| + the
    bound, element by element, the length-0 slot exactly zero on
    both."""
    jax_o, want, bound, _ = _case(layout, Dh, seed=Dh)
    assert _ratio(jax_o, want, bound) <= 1.0
    assert (jax_o[6] == 0).all() and (want[6] == 0).all()


@pytest.mark.parametrize("layout", ["pool", "slots"])
def test_the_bound_is_needed(layout):
    """The waves above fall outside the bf16 ulp tolerance without the
    bound: the rounding of P is what it covers."""
    jax_o, want, bound, _ = _case(layout, 64, seed=64)
    assert _ratio(jax_o, want) > 1.0
    assert _ratio(jax_o, want, bound) <= 1.0


@pytest.mark.parametrize("layout", ["pool", "slots"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_split_body_arithmetic_within_the_rounding_bound(layout, Dh):
    """The split-K body's Q 1 arithmetic (128-position splits, 32-key
    warp maxima, P rounded to bf16, an f32 merge) against JAX's bf16
    Pallas decode kernel: within 2^-12 + 2^-7 |want| + the bound, the
    length-0 slot zero on both; and against the plain version, which it
    is held to on the card, within the same."""
    jax_o, want, bound, emu = _case(layout, Dh, seed=Dh)
    assert _ratio(jax_o, emu, bound) <= 1.0
    assert _ratio(want, emu, bound) <= 1.0
    assert (emu[6] == 0).all()
