"""The PyTorch port's kernels against the JAX package's.

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

import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu.kernels import ragged_attention as jra
from hetu_tpu_torch.kernels import flash_attention as tfa
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.kernels import launch_counts, reset_launches

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


def test_cpu_calls_launch_no_kernel():
    reset_launches()
    q, k, v, kv = _flash_inputs()
    tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    q, pk, pv, lens, ql, tab = _ragged_wave()
    tra.ragged_paged_attention(_t(q), _t(pk), _t(pv), _t(lens).int(),
                               _t(ql).int(), _t(tab).int())
    assert launch_counts() == {"flash_attention": 0,
                               "ragged_paged_attention": 0}
