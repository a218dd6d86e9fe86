"""The bf16 plain versions of the flash forward (K2) and its carried form
(K2-carry) round where the Pallas body rounds, against the JAX package's
interpret-mode kernels on the same numpy inputs.

``_fwd_kernel`` rounds P = exp(s - m) to v's dtype before P V and sums
the denominator from the unrounded P.  With one kv block (block_k = Sk)
its running max is the row max, so its rounding points are the plain
version's: o = sum(rnd(p) v) / sum(p).  What is left is the order of the
f32 sums and XLA's exp against torch's, which may move a P by one f32
ulp and so flip its bf16 rounding now and then:

- K2 (bf16 output): at least 99.9% of the elements bit-equal to JAX's,
  every one within one bf16 ulp of it (``rtol 2^-7``); a plain version
  that keeps P in f32 matches only ~80%.  lse within 1e-5, +1e30
  exactly on rows with no live key.
- K2-carry (f32 output): every element within ``bf16_rounding_bound``
  (a flipped bf16 rounding of a P term moves o_d by at most one bf16
  ulp of that p times |v_d| / l, and ulp(p) <= 2^-7 p, so all of them
  by at most 2^-7 sum(p |v_d|) / l) and at least 99% within
  ``1e-5 + 1e-5 * |want|``; keeping P in f32 misses that by ~1e-3.
- With several kv blocks (``block_k`` 8) the Pallas body rounds P
  against its running max at each block, as the card's kernels do at
  each key tile, and the plain version against the row's final max:
  every element within ``1e-5 + bf16_rounding_bound`` (f32's 1e-5 for
  the sums in another order) and ``rtol`` 2^-7 (K2: each side rounds o
  to bf16 once) or 1e-5 (K2-carry, f32 o), the bound the card tests
  and ``chip_smoke.py`` hold the kernels to.
- f32: the rounding is a no-op, and ``mha_reference`` (the exact oracle
  of ring attention) never rounds inside.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu_torch.kernels import flash_attention as tfa

NEG_INF = -1e30
B, H = 3, 2


def _fold(x, dtype):
    """[B, S, H, D] numpy -> the JAX kernels' [B*H, S, D]."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                       getattr(jnp, dtype))


def _unfold(x, b, h):
    x = np.asarray(jnp.asarray(x, jnp.float32))
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _qkv(seed, s, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, s, H, d).astype(np.float32),
            rng.randn(B, sk, H, d).astype(np.float32),
            rng.randn(B, sk, H, d).astype(np.float32))


def _t(x, dtype="float32"):
    return torch.from_numpy(x).to(getattr(torch, dtype))


SHAPES = [(True, 40, 40), (False, 40, 72)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", SHAPES)
@pytest.mark.parametrize("with_lens", [True, False])
def test_bf16_forward_plain_rounds_like_pallas(D, causal, S, Sk, with_lens):
    q, k, v = _qkv(D + S, S, Sk, D)
    kv = np.array([Sk - 3, 0, 9], np.int32)
    lens_j = jnp.asarray(np.repeat(kv, H)) if with_lens else None
    jo, jl = jfa._flash_fwd(_fold(q, "bfloat16"), _fold(k, "bfloat16"),
                            _fold(v, "bfloat16"), lens_j, causal=causal,
                            block_q=S, block_k=Sk, interpret=True)
    want_o = _unfold(jo, B, H)
    want_l = np.asarray(jl).reshape(B, H, S)
    o, lse = tfa.flash_fwd_reference(
        _t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"),
        causal=causal,
        kv_lens=torch.from_numpy(kv) if with_lens else None)
    assert o.dtype == torch.bfloat16
    got = o.float().numpy()
    diff = np.abs(got - want_o)
    assert (diff == 0).mean() >= 0.999
    assert (diff <= 2.0 ** -7 * np.abs(want_o)).all()
    lse = lse.numpy()
    dead = want_l >= 1e29
    assert np.array_equal(lse >= 1e29, dead)
    assert (lse[dead] == np.float32(-NEG_INF)).all()
    np.testing.assert_allclose(lse[~dead], want_l[~dead], atol=1e-5,
                               rtol=0)
    if with_lens:
        assert (got[1] == 0).all()


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


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", SHAPES)
@pytest.mark.parametrize("kind", ["empty", "live", "mixed"])
def test_bf16_carry_plain_rounds_like_pallas(D, causal, S, Sk, kind):
    q, k, v = _qkv(D + Sk, S, Sk, D)
    o_c, lse_c = _carry(D, S, D, kind)
    jo, jl = jfa._flash_fwd(
        _fold(q, "bfloat16"), _fold(k, "bfloat16"), _fold(v, "bfloat16"),
        None, causal=causal, block_q=S, block_k=Sk, interpret=True,
        carry=(_fold(o_c, "float32"),
               jnp.asarray(lse_c.reshape(B * H, 1, S))))
    want_o = _unfold(jo, B, H)
    want_l = np.asarray(jl).reshape(B, H, S)
    o, lse = tfa.flash_fwd_carry_reference(
        _t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"), _t(o_c),
        _t(lse_c), causal=causal)
    assert o.dtype == torch.float32
    diff = np.abs(o.numpy() - want_o)
    bound = tfa.bf16_rounding_bound(
        _t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"),
        causal=causal, lse_c=_t(lse_c)).numpy()
    assert (diff <= bound).all()
    assert (diff <= 1e-5 + 1e-5 * np.abs(want_o)).mean() >= 0.99
    np.testing.assert_allclose(lse.numpy(), want_l, atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", SHAPES)
@pytest.mark.parametrize("kind", ["none", "empty", "live", "mixed"])
def test_bf16_running_max_rounding_within_bound(D, causal, S, Sk, kind):
    """Pallas with 8-key blocks (P rounded against a running max) against
    the plain version (against the row's max): within 1e-5 +
    ``bf16_rounding_bound`` element by element, rtol 2^-7 in bf16 (K2,
    ``kind`` none, with kv_lens) and 1e-5 in f32 (K2-carry); and not
    equal, so the two roundings do differ here."""
    q, k, v = _qkv(3 * D + S, S, Sk, D)
    qb, kb, vb = (_t(x, "bfloat16") for x in (q, k, v))
    if kind == "none":
        kv = np.array([Sk - 3, 0, 9], np.int32)
        jo, _ = jfa._flash_fwd(
            _fold(q, "bfloat16"), _fold(k, "bfloat16"), _fold(v, "bfloat16"),
            jnp.asarray(np.repeat(kv, H)), causal=causal, block_q=S,
            block_k=8, interpret=True)
        lens = torch.from_numpy(kv)
        o, _ = tfa.flash_fwd_reference(qb, kb, vb, causal=causal,
                                       kv_lens=lens)
        bound = tfa.bf16_rounding_bound(qb, kb, vb, causal=causal,
                                        kv_lens=lens)
        rtol = 2.0 ** -7
    else:
        o_c, lse_c = _carry(D + 1, S, D, kind)
        jo, _ = jfa._flash_fwd(
            _fold(q, "bfloat16"), _fold(k, "bfloat16"), _fold(v, "bfloat16"),
            None, causal=causal, block_q=S, block_k=8, interpret=True,
            carry=(_fold(o_c, "float32"),
                   jnp.asarray(lse_c.reshape(B * H, 1, S))))
        o, _ = tfa.flash_fwd_carry_reference(qb, kb, vb, _t(o_c), _t(lse_c),
                                             causal=causal)
        bound = tfa.bf16_rounding_bound(qb, kb, vb, causal=causal,
                                        lse_c=_t(lse_c))
        rtol = 1e-5
    want = _unfold(jo, B, H)
    got = o.float().numpy()
    diff = np.abs(got - want)
    lim = 1e-5 + bound.numpy() + rtol * np.abs(want)
    assert (diff <= lim).all(), float((diff / lim).max())
    assert diff.max() > 0


@pytest.mark.parametrize("causal", [True, False])
def test_f32_plain_does_not_round_and_mha_reference_never_rounds(causal):
    """In f32 the rounded plain version is exact attention; in bf16
    ``mha_reference`` is exact attention over the bf16 inputs (P kept in
    f32), output rounded once."""
    q, k, v = _qkv(3, 24, 24, 64)
    kv = torch.tensor([24, 0, 5], dtype=torch.int32)
    o, _ = tfa.flash_fwd_reference(_t(q), _t(k), _t(v), causal=causal,
                                   kv_lens=kv)
    exact = tfa.mha_reference(_t(q), _t(k), _t(v), causal=causal,
                              kv_lens=kv)
    np.testing.assert_allclose(o.numpy(), exact.numpy(), atol=1e-6, rtol=0)
    xb = [_t(x, "bfloat16") for x in (q, k, v)]
    got = tfa.mha_reference(*xb, causal=causal, kv_lens=kv)
    want = tfa.mha_reference(*(x.float() for x in xb), causal=causal,
                             kv_lens=kv).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert not torch.equal(
        got, tfa.flash_fwd_reference(*xb, causal=causal, kv_lens=kv)[0])
