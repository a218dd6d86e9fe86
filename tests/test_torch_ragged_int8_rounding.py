"""The arithmetic of the bf16-q int8-cache kernels on the tensor cores
(K1-int8 ``ragged_paged_attention`` and K8-int8 ``ragged_attention``,
csrc/ragged_paged_bf16.cu, and K4-int8 ``paged_decode_attention``,
K5-int8 ``paged_block_decode_attention``, K6-int8
``paged_verify_attention`` and K7-int8 ``paged_block_verify_attention``,
csrc/decode_attention_bf16.cu, all on the same bodies) against the JAX
package's int8 Pallas kernels in interpret mode, within one bf16 ulp.

The Pallas int8 bodies dequantize K and V to f32 (``k_int * k_scale``)
and compute in f32: P is never rounded there.  The card's kernels put
the integer payload on the tensor cores instead: they widen it to bf16
exactly (``kv_encode`` clamps to +-127, which bf16's 8 significant bits
hold), form the scores as Q K_int^T (each product exact in f32) times
each key's K scale in f32, before the mask and the max, and split a =
``p * v_scale`` into a bf16 pair, a_hi = bf16(a) and a_lo = bf16(a -
a_hi), two products into one f32 accumulator with l summed from the
unrounded p.  Each term of o then moves by about 2^-16 a |v_int|, far
inside one bf16 ulp.  :func:`_emulate` is that arithmetic in PyTorch on
the CPU; it is held to JAX within ``2^-12 + 2^-7 |want|`` element by
element (2^-12 for the f32 sums in another order, one bf16 ulp for the
output's own rounding), with no rounding bound, over waves with several
KV blocks: Q 1 (decode), 8 (verify) and 64 (a prompt chunk); head dims
32, 64 and 128; an inert q_len-0 slot with a length, a length-0 slot,
and two slots sharing pool blocks; the verify waves (Q 1, 5, 16) of
K7-int8 through the pool and of K6-int8 over slot rows; and one decode
row a slot (q_len 1 everywhere, the inert slot's length included) for
K5-int8 through the pool and K4-int8 over slot rows.  The arithmetic before the split (a rounded to bf16 once) falls
outside that tolerance on the same waves: it needed
``ragged_rounding_bound`` of the dequantized cache, and the reference
needs none.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu.kernels import ragged_attention as jra
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.quant import kv_encode

H, BS = 2, 16
ATOL, RTOL = 2.0 ** -12, 2.0 ** -7


def _wave(Q, Dh, seed):
    """Six slots over a permuted pool of 16-position blocks: slot 0 a
    q-block of Q rows at the end of 150 positions (10 pool blocks),
    slot 1 a decode row over 131, slot 2 a short q-block, slot 3 length
    0, slot 4 a decode row sharing slot 1's first two blocks, slot 5
    inert (q_len 0) with a length of 70.  K/V are ``kv_encode``'d.
    Returns torch (q bf16, k int8, k scales, v int8, v scales, lengths,
    q_lens, tables)."""
    lengths = np.array([150, 131, 5, 0, 33, 70], np.int32)
    q_lens = np.minimum(np.array([Q, 1, 3, 0, 1, 0], np.int32), lengths)
    B, T = len(lengths), 10
    rng = np.random.RandomState(seed)
    need = [-(-int(n) // BS) for n in lengths]
    N = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    tables[4, :2] = tables[1, :2]                  # a shared prefix
    kq, ks = kv_encode(torch.from_numpy(
        rng.randn(N, BS, H, Dh).astype(np.float32)))
    vq, vs = kv_encode(torch.from_numpy(
        (3.0 * rng.randn(N, BS, H, Dh)).astype(np.float32)))
    q = torch.from_numpy(rng.randn(B, Q, H, Dh).astype(np.float32))
    return (q.bfloat16(), kq, ks, vq, vs, torch.from_numpy(lengths),
            torch.from_numpy(q_lens), torch.from_numpy(tables))


def _slot_rows(pool, tables):
    B, T = tables.shape
    return pool[tables.long()].reshape(B, T * pool.shape[1],
                                       *pool.shape[2:])


def _emulate(q, kq, ks, vq, vs, lengths, q_lens, split=True):
    """The kernels' arithmetic over slot rows (k/v [B, S, H, Dh] int8,
    scales [B, S, H]), in f32: s = (q . k_int) k_scale Dh^-1/2, dead keys
    at NEG_INF, p = exp(s - max), l = sum p, a = p v_scale split into
    bf16(a) + bf16(a - bf16(a)) (``split=False``: bf16(a) alone, the
    arithmetic before the split), o = sum a v_int / l, rounded to bf16;
    zeros on a length-0 slot."""
    B, Q, _, Dh = q.shape
    S = kq.shape[1]
    s = torch.einsum("bqhd,bshd->bqhs", q.float(), kq.float())
    s = s * ks.permute(0, 2, 1)[:, None] * Dh ** -0.5
    L, QL = lengths.long(), q_lens.long()
    posq = torch.minimum(torch.clamp(
        (L - QL)[:, None] + torch.arange(Q)[None], min=0),
        torch.clamp(L - 1, min=0)[:, None])                  # [B, Q]
    live = torch.arange(S)[None, None, None, :] <= posq[:, :, None, None]
    s = torch.where(live, s, torch.full_like(s, tra.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * live
    a = p * vs.permute(0, 2, 1)[:, None]
    hi = a.bfloat16().float()
    o = torch.einsum("bqhs,bshd->bqhd", hi, vq.float())
    if split:
        lo = (a - hi).bfloat16().float()
        o = torch.einsum("bqhs,bshd->bqhd", lo, vq.float()) + o
    o = o / p.sum(-1)[..., None]
    return (o * (L > 0)[:, None, None, None]).bfloat16()


def _case(layout, Q, Dh, seed, split=True):
    """(JAX's int8 o as f32 numpy, the emulated kernel's o), one wave
    through either layout ("verify": the pool through JAX's block verify
    kernel, K7-int8's; "verify-slots": the slot rows through its verify
    kernel, K6-int8's; "decode" and "decode-slots": one decode row a slot,
    q_len 1 on every slot, through JAX's block decode and decode kernels,
    K5-int8's and K4-int8's, as [B, 1, H, Dh])."""
    q, kq, ks, vq, vs, lens, ql, tab = _wave(Q, Dh, seed)
    kr, ksr, vr, vsr = (_slot_rows(x, tab) for x in (kq, ks, vq, vs))
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    jl, jql = jnp.asarray(lens.numpy()), jnp.asarray(ql.numpy())
    if layout.startswith("decode"):
        assert Q == 1
        ql = torch.ones_like(lens)
        sc = (ksr, vsr) if layout == "decode-slots" else (ks, vs)
        kw = dict(k_scale=jnp.asarray(sc[0].numpy()),
                  v_scale=jnp.asarray(sc[1].numpy()), interpret=True)
        if layout == "decode-slots":
            want = jda.paged_decode_attention(
                jq[:, 0], jnp.asarray(kr.numpy()), jnp.asarray(vr.numpy()),
                jl, **kw)[:, None]
        else:
            want = jda.paged_block_decode_attention(
                jq[:, 0], jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                jl, jnp.asarray(tab.numpy()), **kw)[:, None]
    elif layout in ("slots", "verify-slots"):
        run = (jda.paged_verify_attention if layout == "verify-slots"
               else jra.ragged_attention)
        want = run(
            jq, jnp.asarray(kr.numpy()), jnp.asarray(vr.numpy()), jl, jql,
            k_scale=jnp.asarray(ksr.numpy()),
            v_scale=jnp.asarray(vsr.numpy()), interpret=True)
    else:
        run = (jda.paged_block_verify_attention if layout == "verify"
               else jra.ragged_paged_attention)
        want = run(
            jq, jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jl, jql,
            jnp.asarray(tab.numpy()), k_scale=jnp.asarray(ks.numpy()),
            v_scale=jnp.asarray(vs.numpy()), interpret=True)
    got = _emulate(q, kr, ksr, vr, vsr, lens, ql, split=split)
    assert want.dtype == jnp.bfloat16
    return np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy()


def _ratio(want, got):
    """The largest |got - want| / (2^-12 + 2^-7 |want|)."""
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


@pytest.mark.parametrize("layout", ["pool", "slots"])
@pytest.mark.parametrize("Q", [1, 8, 64])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_int8_kernel_arithmetic_within_the_rounding_bound(layout, Q, Dh):
    """The kernels' int8 arithmetic (integer K and V on the tensor cores,
    scales in f32, p v_scale split into a bf16 pair) against JAX's int8
    Pallas kernel (all f32): within 2^-12 + 2^-7 |want| element by
    element, with no rounding bound, the length-0 slot exactly zero on
    both."""
    want, got = _case(layout, Q, Dh, seed=Q + Dh)
    assert _ratio(want, got) <= 1.0
    assert (want[3] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("layout", ["pool", "slots"])
def test_the_int8_bound_is_needed(layout):
    """The bound was needed by the arithmetic before the split (p v_scale
    rounded to bf16 once): on the same wave it falls outside the bf16
    ulp tolerance, where the split holds it."""
    want, single = _case(layout, 64, 64, seed=128, split=False)
    _, split = _case(layout, 64, 64, seed=128)
    assert _ratio(want, single) > 1.0
    assert _ratio(want, split) <= 1.0


@pytest.mark.parametrize("layout", ["pool", "slots"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_bf16_decode_int8_arithmetic_holds_one_ulp(layout, Dh):
    """K5-int8 (``pool``) and K4-int8 (``slots``) for bf16 q (the split
    body of K1-int8 / K8-int8, one decode row a slot with the decode row
    limit len - 1, which is theirs at q_len 1) against JAX's int8 block
    decode and decode kernels (``_block_decode_kernel_int8``,
    ``_decode_kernel_int8``) in interpret mode: within 2^-12 + 2^-7
    |want|, no bound, the length-0 slot zero."""
    want, got = _case("decode" if layout == "pool" else "decode-slots", 1,
                      Dh, seed=5 * Dh + 1)
    assert _ratio(want, got) <= 1.0
    assert (want[3] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("layout", ["pool", "slots"])
@pytest.mark.parametrize("Q", [1, 5, 16])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_bf16_verify_int8_arithmetic_holds_one_ulp(layout, Q, Dh):
    """K7-int8 (``pool``) and K6-int8 (``slots``) for bf16 q (the split
    body of K1-int8 / K8-int8 with the verify rows' limits, which are
    K1's and K8's) against JAX's int8 block verify and verify kernels
    (``_block_verify_kernel_int8``, ``_verify_kernel_int8``) in interpret
    mode: within 2^-12 + 2^-7 |want|, no bound, the length-0 slot
    zero."""
    want, got = _case("verify" if layout == "pool" else "verify-slots", Q,
                      Dh, seed=3 * Q + Dh)
    assert _ratio(want, got) <= 1.0
    assert (want[3] == 0).all() and (got[3] == 0).all()
