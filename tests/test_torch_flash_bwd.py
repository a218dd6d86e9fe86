"""The port's flash-attention backward (K3) against the JAX package's, on
the CPU.

- ``flash_bwd_reference`` (the plain version of csrc/flash_bwd.cu)
  against the JAX ``_flash_bwd`` (its two Pallas kernels in interpret
  mode) on the same (q, k, v, o, lse, dO): causal and not, ``kv_lens``
  with a 0 and a full length, Sk > S, an lse cotangent ``g_lse``, S not
  a multiple of the JAX blocks.  f32 ``atol 1e-5`` (the same sums in
  another order); bf16 ``atol 2e-2`` (both round P and dS to bf16 at
  the same points; a bf16 rounding that lands on the other side moves a
  sum by an ulp of one term).
- The port's ``flash_attention`` gradient by autograd against
  ``jax.grad`` through the JAX ``flash_attention``: f32 ``1e-5``.
- The plain backward against autograd through the plain forward:
  ``1e-6``.
- CPU tensors launch no kernel.

The CUDA kernels are held to the plain versions on the card by
test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu_torch.kernels import flash_attention as tfa
from hetu_tpu_torch.kernels import launch_counts, reset_launches

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(seed, B=3, S=24, Sk=24, H=2, D=8, kv_lens=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k, v = (rng.randn(B, Sk, H, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, S, H, D).astype(np.float32)
    kv = np.array([Sk - 7, 0, Sk][:B], np.int32) if kv_lens else None
    return q, k, v, do, kv


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _fold(x, dtype):
    """[B, S, H, D] -> the JAX kernels' [B*H, S, D]."""
    x = np.asarray(x, np.float32)
    B, S, H, D = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D),
                       getattr(jnp, dtype))


def _unfold(x, B, H):
    x = _f32(x)
    return x.reshape(B, H, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


CASES = {
    "causal-kv_lens": dict(causal=True),
    "full-kv_lens": dict(causal=False),
    "causal": dict(causal=True, kv_lens=False),
    "cross-Sk>S": dict(causal=False, S=16, Sk=40),
    "causal-Sk>S": dict(causal=True, S=16, Sk=40, kv_lens=False),
    "ragged-S": dict(causal=True, S=20, Sk=20),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("with_g_lse", [False, True])
def test_plain_backward_matches_jax_kernels(dtype, case, with_g_lse):
    kw = dict(CASES[case])
    causal = kw.pop("causal")
    q, k, v, do, kv = _case(seed=len(case), **kw)
    B, S, H, D = q.shape
    dt = getattr(torch, dtype)
    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    tkv = torch.from_numpy(kv) if kv is not None else None
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, causal=causal, kv_lens=tkv)
    g_lse = (np.random.RandomState(7).randn(B, H, S).astype(np.float32)
             if with_g_lse else None)
    got = tfa.flash_bwd_reference(
        tq, tk, tv, tkv, o, lse, tdo, causal=causal,
        g_lse=torch.from_numpy(g_lse) if with_g_lse else None)
    assert all(g.dtype == dt for g in got)
    lens = jnp.repeat(jnp.asarray(kv), H) if kv is not None else None
    want = jfa._flash_bwd(
        _fold(q, dtype), _fold(k, dtype), _fold(v, dtype), lens,
        _fold(_f32(o), dtype), jnp.asarray(lse.numpy().reshape(B * H, 1, S)),
        _fold(do, dtype), causal=causal, block_q=8, block_k=8,
        interpret=True,
        g_lse=jnp.asarray(g_lse.reshape(B * H, S)) if with_g_lse else None)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_f32(g), _unfold(w, B, H),
                                   atol=TOL[dtype], rtol=0,
                                   err_msg=f"d{name}")
    if kv is not None:            # kv_lens 0: zero gradients
        assert all(np.all(_f32(g)[1] == 0.0) for g in got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_lens", [True, False])
def test_flash_attention_grad_matches_jax_grad(causal, kv_lens):
    """Autograd through the port's flash_attention (K2 forward, K3
    backward) against jax.grad through the JAX flash_attention."""
    q, k, v, do, kv = _case(seed=3, kv_lens=kv_lens)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tkv = torch.from_numpy(kv) if kv is not None else None
    o = tfa.flash_attention(tq, tk, tv, causal=causal, kv_lens=tkv)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))

    def f(q_, k_, v_):
        out = jfa.flash_attention(
            q_, k_, v_, causal=causal,
            kv_lens=jnp.asarray(kv) if kv is not None else None,
            block_q=8, block_k=8)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                             for x in (q, k, v)))
    np.testing.assert_allclose(_f32(o), _f32(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        kv_lens=jnp.asarray(kv) if kv is not None else None,
        block_q=8, block_k=8)), atol=1e-5, rtol=0)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    kw = dict(CASES[case])
    causal = kw.pop("causal")
    q, k, v, do, kv = _case(seed=11, **kw)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tkv = torch.from_numpy(kv) if kv is not None else None
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, causal=causal, kv_lens=tkv)
    want = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    got = tfa.flash_bwd_reference(tq.detach(), tk.detach(), tv.detach(), tkv,
                                  o.detach(), lse.detach(), _t(do),
                                  causal=causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-6, rtol=0,
                                   err_msg=f"d{name}")


def test_cpu_calls_launch_no_kernel():
    q, k, v, do, kv = _case(seed=5)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    reset_launches()
    o = tfa.flash_attention(tq, tk, tv, causal=True,
                            kv_lens=torch.from_numpy(kv))
    o.backward(_t(do))
    tfa.flash_bwd(tq.detach(), tk.detach(), tv.detach(), None, o.detach(),
                  torch.zeros(3, 2, 24), _t(do), causal=True)
    assert not any(launch_counts().values())


def test_bwd_refuses_malformed_stats():
    q, k, v, do, _ = _case(seed=6, kv_lens=False)
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, causal=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_bwd(tq, tk, tv, None, o, lse.transpose(1, 2), tdo)
    with pytest.raises(ValueError, match="dO"):
        tfa.flash_bwd(tq, tk, tv, None, o, lse, tdo.to(torch.bfloat16))
