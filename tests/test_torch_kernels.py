"""The PyTorch port's kernels against the JAX package's: K1
``ragged_paged_attention``, K2 ``flash_attention``, K4
``paged_decode_attention``, K5 ``paged_block_decode_attention`` and K8
``ragged_attention``.

On the CPU each port wrapper runs its plain PyTorch version; these tests
hold that version to the JAX Pallas kernel (interpret mode) and to the
JAX reference on the same numpy inputs.  The CUDA kernels themselves are
held to the plain versions on the card by test_torch_kernels_cuda.py
and chip_smoke.py.

Tolerances: f32 ``atol 1e-5`` (the same softmax, summed in another
order); bf16 ``atol 2e-2`` (the JAX side keeps bf16 operands where the
port's plain versions compute in f32 and round the output once: the
JAX flash kernel, for one, rounds its probabilities to bf16 before the
PV product).  The CUDA kernels are held far tighter to the plain
versions on the card.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu.kernels import ragged_attention as jra
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import flash_attention as tfa
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.kernels import (KERNELS, QUANT_KERNELS, launch_counts,
                                    reset_launches)
from hetu_tpu_torch.quant import kv_encode

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------- #
# K1: ragged paged attention
# ------------------------------------------------------------------- #


def _ragged_wave(seed=0, H=2, Dh=8, bs=8, T=6):
    """A mixed wave over a permuted pool: q_len 0 (an inert slot with
    length), 1 (decode), 3 and 6 (prompt chunks), a zero-length slot,
    and slots 1 and 4 sharing their first two pool blocks."""
    lengths = np.array([20, 33, 5, 0, 17, 9], np.int32)
    q_lens = np.array([6, 1, 3, 0, 1, 0], np.int32)
    B, Q = len(lengths), 8
    rng = np.random.RandomState(seed)
    need = [-(-int(n) // bs) for n in lengths]
    N = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    tables[4, :2] = tables[1, :2]
    pk = rng.randn(N, bs, H, Dh).astype(np.float32)
    pv = rng.randn(N, bs, H, Dh).astype(np.float32)
    q = rng.randn(B, Q, H, Dh).astype(np.float32)
    return q, pk, pv, lengths, q_lens, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_plain_matches_jax_kernel(dtype):
    q, pk, pv, lens, ql, tab = _ragged_wave()
    got = tra.ragged_paged_attention(
        _t(q, dtype), _t(pk, dtype), _t(pv, dtype), _t(lens).int(),
        _t(ql).int(), _t(tab).int())
    assert got.dtype == getattr(torch, dtype)
    want = jra.ragged_paged_attention(
        _j(q, dtype), _j(pk, dtype), _j(pv, dtype), jnp.asarray(lens),
        jnp.asarray(ql), jnp.asarray(tab), interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=0)
    assert np.all(_f32(got)[3] == 0.0)          # zero-length slot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_plain_matches_jax_reference(dtype):
    q, pk, pv, lens, ql, tab = _ragged_wave(seed=3)
    got = tra.ragged_paged_reference(
        _t(q, dtype), _t(pk, dtype), _t(pv, dtype), _t(lens), _t(ql),
        _t(tab))
    want = jra.ragged_paged_reference(
        _j(q, dtype), _j(pk, dtype), _j(pv, dtype), jnp.asarray(lens),
        jnp.asarray(ql), jnp.asarray(tab))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=0)


def test_ragged_masked_reference_matches_jax():
    q, pk, pv, lens, ql, tab = _ragged_wave(seed=5)
    B, T = tab.shape
    k = pk[tab].reshape(B, T * pk.shape[1], *pk.shape[2:])
    v = pv[tab].reshape(B, T * pv.shape[1], *pv.shape[2:])
    got = tra.ragged_masked_reference(_t(q), _t(k), _t(v), _t(lens),
                                      _t(ql))
    want = jra.ragged_masked_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       jnp.asarray(ql))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


def test_ragged_wrapper_rejects_bad_shapes():
    q, pk, pv, lens, ql, tab = _ragged_wave()
    with pytest.raises(ValueError):
        tra.ragged_paged_attention(_t(q)[..., :4], _t(pk), _t(pv),
                                   _t(lens).int(), _t(ql).int(),
                                   _t(tab).int())
    with pytest.raises(ValueError):
        tra.ragged_paged_attention(_t(q), _t(pk), _t(pv),
                                   _t(lens[:3]).int(), _t(ql).int(),
                                   _t(tab).int())


# ------------------------------------------------------------------- #
# K2: forward flash attention
# ------------------------------------------------------------------- #


def _flash_inputs(seed=0, B=3, S=24, H=2, D=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    return q, k, v, np.array([17, 0, 24], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_kernel(dtype, causal):
    q, k, v, kv = _flash_inputs()
    got = tfa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=causal, kv_lens=_t(kv).int())
    assert got.dtype == getattr(torch, dtype)
    want = jfa.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               causal=causal, kv_lens=jnp.asarray(kv),
                               block_q=8, block_k=8)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=0)
    assert np.all(_f32(got)[1] == 0.0)          # kv_lens == 0


@pytest.mark.parametrize("kv_lens", [True, False])
def test_flash_plain_matches_mha_reference(kv_lens):
    q, k, v, kv = _flash_inputs(seed=2)
    lens_t = _t(kv).int() if kv_lens else None
    lens_j = jnp.asarray(kv) if kv_lens else None
    got = tfa.mha_reference(_t(q), _t(k), _t(v), causal=True,
                            kv_lens=lens_t)
    want = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal=True, kv_lens=lens_j)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


def test_flash_lse_matches_pallas_forward():
    """The per-row logsumexp the backward slice needs: +1e30 on rows
    with no live key, m + log l elsewhere."""
    q, k, v, kv = _flash_inputs(seed=4)
    B, S, H, D = q.shape
    _, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), causal=True,
                           kv_lens=_t(kv).int())

    def fold(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, D)
    _, want = jfa._flash_fwd(fold(q), fold(k), fold(v),
                             jnp.repeat(jnp.asarray(kv), H), causal=True,
                             block_q=8, block_k=8, interpret=True)
    want = np.asarray(want).reshape(B, H, S)
    got = lse.numpy()
    dead = want >= 1e29
    assert np.array_equal(got >= 1e29, dead) and dead[1].all()
    np.testing.assert_allclose(got[~dead], want[~dead], atol=1e-5, rtol=0)


# ------------------------------------------------------------------- #
# K4, K5: decode attention; K8: ragged attention over slot rows
# ------------------------------------------------------------------- #


def _decode_case(seed=0, H=2, Dh=8, bs=8, T=5):
    """Six slots over the same K/V, as slot rows [B, T*bs, H, Dh] and as
    a permuted pool [N, bs, H, Dh] with block tables: a length-0 slot, a
    length at a block edge (16), a full row (40), one position, and
    slots 1 and 4 sharing their first two blocks; dead table entries at
    scratch block 0."""
    lengths = np.array([23, 16, 0, 40, 1, 11], np.int32)
    B, S = len(lengths), T * bs
    rng = np.random.RandomState(seed)
    need = [-(-int(n) // bs) for n in lengths]
    N = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    tables[4, :2] = tables[1, :2]
    pk = rng.randn(N, bs, H, Dh).astype(np.float32)
    pv = rng.randn(N, bs, H, Dh).astype(np.float32)
    k = pk[tables].reshape(B, S, H, Dh)
    v = pv[tables].reshape(B, S, H, Dh)
    q = rng.randn(B, 8, H, Dh).astype(np.float32)
    return q, k, v, pk, pv, lengths, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_kernel(dtype):
    """K4 over the slot rows."""
    q, k, v, _, _, lens, _ = _decode_case()
    got = tda.paged_decode_attention(_t(q[:, 0], dtype), _t(k, dtype),
                                     _t(v, dtype), _t(lens).int())
    assert got.dtype == getattr(torch, dtype)
    want = jda.paged_decode_attention(
        _j(q[:, 0], dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(lens),
        interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=0)
    assert np.all(_f32(got)[2] == 0.0)          # zero-length slot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_decode_plain_matches_jax_kernel(dtype):
    """K5 through the block tables of a permuted pool."""
    q, _, _, pk, pv, lens, tab = _decode_case(seed=1)
    got = tda.paged_block_decode_attention(
        _t(q[:, 0], dtype), _t(pk, dtype), _t(pv, dtype), _t(lens).int(),
        _t(tab).int())
    assert got.dtype == getattr(torch, dtype)
    want = jda.paged_block_decode_attention(
        _j(q[:, 0], dtype), _j(pk, dtype), _j(pv, dtype), jnp.asarray(lens),
        jnp.asarray(tab), interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=0)
    assert np.all(_f32(got)[2] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_contiguous_plain_matches_jax_kernel(dtype):
    """K8 over the slot rows: a prompt q-block of 8, decode tokens, an
    inert slot with a length, a zero-length slot."""
    q, k, v, _, _, lens, _ = _decode_case(seed=2)
    q_lens = np.array([8, 1, 0, 3, 1, 0], np.int32)
    got = tra.ragged_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                               _t(lens).int(), _t(q_lens).int())
    assert got.dtype == getattr(torch, dtype)
    want = jra.ragged_attention(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(lens),
        jnp.asarray(q_lens), interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=0)
    assert np.all(_f32(got)[2] == 0.0)


def test_decode_references_match_jax():
    q, k, v, pk, pv, lens, tab = _decode_case(seed=3)
    got = tda.masked_decode_reference(_t(q[:, 0]), _t(k), _t(v), _t(lens))
    want = jda.masked_decode_reference(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)
    got = tda.paged_block_decode_reference(_t(q[:, 0]), _t(pk), _t(pv),
                                           _t(lens), _t(tab))
    want = jda.paged_block_decode_reference(
        jnp.asarray(q[:, 0]), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(lens), jnp.asarray(tab))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


def _six_wrappers(q, k, v, pk, pv, lens, tab):
    """The six wrappers that take an int8 cache, each as ``call(k_or_pk,
    v_or_pv, **scales)`` over the case of :func:`_decode_case`."""
    L, T = _t(lens).int(), _t(tab).int()
    q1, q4 = _t(q[:, 0]), _t(q)
    return [
        lambda a, b, **s: tda.paged_decode_attention(q1, a, b, L, **s),
        lambda a, b, **s: tda.paged_block_decode_attention(q1, a, b, L, T,
                                                           **s),
        lambda a, b, **s: tra.ragged_attention(q4, a, b, L, L, **s),
        lambda a, b, **s: tra.ragged_paged_attention(q4, a, b, L, L, T, **s),
        lambda a, b, **s: tda.paged_verify_attention(q4, a, b, L, L, **s),
        lambda a, b, **s: tda.paged_block_verify_attention(q4, a, b, L, L, T,
                                                           **s)]


def test_int8_scales_refused():
    """Every wrapper checks an int8 cache's scale arguments: both planes
    or neither, an int8 payload with them and only with them, f32 scales
    of the payload's shape less Dh.  Well-formed int8 arguments run the
    plain version (CPU tensors)."""
    q, k, v, pk, pv, lens, tab = _decode_case()
    calls = _six_wrappers(q, k, v, pk, pv, lens, tab)
    for j, call in enumerate(calls):
        paged = j in (1, 3, 5)
        x, y = (pk, pv) if paged else (k, v)
        xq, yq = _t(x, "int8"), _t(y, "int8")
        s = torch.ones(x.shape[:-1])
        bad = [
            ((xq, yq), dict(k_scale=s), "both"),
            ((_t(x), _t(y)), dict(k_scale=s, v_scale=s), "int8 cache"),
            ((xq, yq), {}, "needs k_scale"),
            ((xq, yq), dict(k_scale=s.double(), v_scale=s), "float32"),
            ((xq, yq), dict(k_scale=s, v_scale=s[..., :1]), "less Dh"),
            ((xq, _t(y)), dict(k_scale=s, v_scale=s), "int8 cache")]
        for args, kw, msg in bad:
            with pytest.raises(ValueError, match=msg):
                call(*args, **kw)
        assert call(xq, yq, k_scale=s, v_scale=s).isfinite().all()


def test_cpu_calls_launch_no_kernel():
    reset_launches()
    q, k, v, kv = _flash_inputs()
    tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    B, S, H, _ = q.shape
    tfa.flash_fwd_carry(_t(q), _t(k), _t(v), torch.zeros(q.shape),
                        torch.full((B, H, S), tfa.NEG_INF), causal=True)
    q, pk, pv, lens, ql, tab = _ragged_wave()
    tra.ragged_paged_attention(_t(q), _t(pk), _t(pv), _t(lens).int(),
                               _t(ql).int(), _t(tab).int())
    q, k, v, pk, pv, lens, tab = _decode_case()
    L = _t(lens).int()
    tra.ragged_attention(_t(q), _t(k), _t(v), L, L)
    tda.paged_decode_attention(_t(q[:, 0]), _t(k), _t(v), L)
    tda.paged_block_decode_attention(_t(q[:, 0]), _t(pk), _t(pv), L,
                                     _t(tab).int())
    tda.paged_verify_attention(_t(q), _t(k), _t(v), L, L)
    tda.paged_block_verify_attention(_t(q), _t(pk), _t(pv), L, L,
                                     _t(tab).int())
    for j, call in enumerate(_six_wrappers(q, k, v, pk, pv, lens, tab)):
        x, y = (pk, pv) if j % 2 else (k, v)
        (xq, xs), (yq, ys) = (kv_encode(_t(a)) for a in (x, y))
        call(xq, yq, k_scale=xs, v_scale=ys)
    assert set(KERNELS) == {"flash_attention", "flash_attention_carry",
                            "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dq"} | {
        f"{n}{sfx}" for n in QUANT_KERNELS for sfx in ("", "_int8")}
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
