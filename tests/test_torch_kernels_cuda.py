"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and nvcc and skips without
them.  The file imports neither JAX nor the JAX package, so on a machine
with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances, element by element ``|got - want| <= atol + rtol*|want|``:
f32 ``atol 1e-5`` (the kernels sum the softmax in another order than
the plain versions); bf16 ``atol 2^-12, rtol 2^-7`` (both sides round
an f32 result to bf16, at most one bf16 ulp apart).
"""

import numpy as np
import pytest
import torch

from hetu_tpu_torch.kernels import flash_attention as tfa
from hetu_tpu_torch.kernels import launch_counts, reset_launches
from hetu_tpu_torch.kernels import ragged_attention as tra

TOL = {"float32": dict(atol=1e-5, rtol=0.0),
       "bfloat16": dict(atol=2.0 ** -12, rtol=2.0 ** -7)}
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _wave(Dh, bs, Q, seed=0, H=3):
    lengths = np.array([70, 33, 5, 0, 17, 130], np.int32)
    q_lens = np.array([Q, 1, 3, 0, 1, 0], np.int32)
    q_lens = np.minimum(q_lens, lengths)
    B, T = len(lengths), -(-160 // bs)
    rng = np.random.RandomState(seed)
    need = [-(-int(n) // bs) for n in lengths]
    free = list(rng.permutation(np.arange(1, 1 + sum(need))))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    tables[4, :1] = tables[1, :1]             # a shared block
    N = 1 + sum(need)
    g = torch.Generator().manual_seed(seed)
    pk, pv = (torch.randn((N, bs, H, Dh), generator=g) for _ in range(2))
    q = torch.randn((B, Q, H, Dh), generator=g)
    return q, pk, pv, lengths, q_lens, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,bs,Q", [(64, 16, 64), (32, 8, 1),
                                     (128, 16, 40)])
def test_ragged_kernel_matches_plain(cuda, dtype, Dh, bs, Q):
    q, pk, pv, lens, ql, tab = _wave(Dh, bs, Q)
    dt = getattr(torch, dtype)
    args = [q.to(cuda, dt), pk.to(cuda, dt), pv.to(cuda, dt)] + [
        torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    reset_launches()
    got = tra.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert launch_counts()["ragged_paged_attention"] == 1
    want = tra.ragged_paged_reference(*args).to(dt)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    assert (got[3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,S,Sk", [(True, 100, 100),
                                         (False, 40, 72)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, S, Sk):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    q = torch.randn((3, S, 4, 64), generator=g).to(cuda, dt)
    k, v = (torch.randn((3, Sk, 4, 64), generator=g).to(cuda, dt)
            for _ in range(2))
    lens = torch.tensor([Sk - 3, 0, 9], dtype=torch.int32, device=cuda)
    reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, causal=causal, kv_lens=lens)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    o_r, lse_r = tfa.flash_fwd_reference(q, k, v, causal=causal,
                                         kv_lens=lens)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_r.float().cpu().numpy(), **TOL[dtype])
    live = lse_r < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_r[live].cpu().numpy(), atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pk, pv, lens, ql, tab = _wave(64, 16, 8)
    args = [q.to(cuda), pk.to(cuda), pv.to(cuda)] + [
        torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    bad = list(args)
    bad[3] = bad[3].long()                    # int64 lengths
    with pytest.raises(ValueError, match="int32"):
        tra.ragged_paged_attention(*bad)
    bad = list(args)
    bad[1] = bad[1].to(torch.bfloat16)        # mixed dtypes
    with pytest.raises(ValueError, match="one dtype"):
        tra.ragged_paged_attention(*bad)
    x = torch.randn((1, 8, 2, 48), device=cuda)   # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(x, x, x, causal=True)
