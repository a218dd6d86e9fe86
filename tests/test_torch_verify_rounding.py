"""The bf16 verify waves (K6 ``paged_verify_attention``, K7
``paged_block_verify_attention``) against the JAX package's Pallas
kernels in interpret mode, and the bound that holds them:
``ragged_attention.ragged_rounding_bound``.

The Pallas verify body (``_verify_kernel`` / ``_block_verify_kernel`` ->
``_online_softmax_multi``) rounds P = exp(s - m) to bf16 before P V
(``decode_attention.py:407``) and sums the denominator from the
unrounded P; the port's plain versions keep P in f32 (they are the
engine's CPU path and the kernels' yardstick, and stay as they are).
One rounding is within 2^-8 of p, whatever max it is taken against, so
each element of o moves by at most 2^-8 sum(p |v_d|) / l: 2^-8 times
the plain version run on (q, k, |v|), which is what
``ragged_rounding_bound`` computes for a verify wave too (a verify wave
is a ragged wave).  So the bf16 Pallas kernels, and the card's bf16
verify kernels that round where they round (csrc/decode_attention_bf16.cu),
are held to the plain versions within ``2^-12 + 2^-7 |want| +
ragged_rounding_bound`` element by element (2^-12 for the f32 sums in
another order, one bf16 ulp for the output's own rounding), over waves
with several KV blocks of 16 positions, so the Pallas running max moves
between blocks (``block_k=16`` over the slot rows; the pool's blocks are
16 positions): Q 2, 5, 8 and 16; head dims 32, 64 and 128; a q-block
shorter than Q (dead rows, compared too), an inert q_len-0 slot with a
length, a length-0 slot, and two slots sharing pool blocks.  The same
waves without the bound fall outside the bf16 ulp tolerance, so the
bound is what lets them pass.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import ragged_attention as tra

H, BS = 2, 16
ATOL, RTOL = 2.0 ** -12, 2.0 ** -7


def _wave(Q, Dh, seed):
    """Six slots over a permuted pool of 16-position blocks: slot 0 a
    full q-block of Q rows at the end of 150 positions (10 pool blocks),
    slot 1 a q-block of Q - 1 rows (one dead row) over 131, slot 2 three
    rows over 5, slot 3 length 0, slot 4 one row sharing slot 1's first
    two blocks, slot 5 inert (q_len 0) with a length of 70.  Returns
    numpy (q, pool_k, pool_v, lengths, q_lens, tables)."""
    lengths = np.array([150, 131, 5, 0, 33, 70], np.int32)
    q_lens = np.minimum(np.array([Q, Q - 1, 3, 0, 1, 0], np.int32),
                        lengths)
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
    pk = rng.randn(N, BS, H, Dh).astype(np.float32)
    pv = rng.randn(N, BS, H, Dh).astype(np.float32)
    q = rng.randn(B, Q, H, Dh).astype(np.float32)
    return q, pk, pv, lengths, q_lens, tables


def _bf16(x):
    """numpy f32 -> (the bf16 torch tensor, the same values for JAX)."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _slot_rows(pool, tables):
    B, T = tables.shape
    return pool[tables].reshape(B, T * pool.shape[1], *pool.shape[2:])


def _case(layout, Q, Dh, seed):
    """(JAX's bf16 o as f32 numpy, the port's plain o, its bound), one
    verify wave through K6 (``slots``) or K7 (``pool``)."""
    q, pk, pv, lens, ql, tab = _wave(Q, Dh, seed)
    if layout == "slots":
        pk, pv = _slot_rows(pk, tab), _slot_rows(pv, tab)
    (qt, qj), (kt, kj), (vt, vj) = _bf16(q), _bf16(pk), _bf16(pv)
    L, QL = torch.from_numpy(lens), torch.from_numpy(ql)
    if layout == "slots":
        want = jda.paged_verify_attention(qj, kj, vj, jnp.asarray(lens),
                                          jnp.asarray(ql), block_k=BS,
                                          interpret=True)
        got = tda.paged_verify_attention(qt, kt, vt, L, QL)
        bound = tra.ragged_rounding_bound(qt, kt, vt, L, QL)
    else:
        T = torch.from_numpy(tab)
        want = jda.paged_block_verify_attention(
            qj, kj, vj, jnp.asarray(lens), jnp.asarray(ql),
            jnp.asarray(tab), interpret=True)
        got = tda.paged_block_verify_attention(qt, kt, vt, L, QL, T)
        bound = tra.ragged_rounding_bound(qt, kt, vt, L, QL, T)
    assert got.dtype == torch.bfloat16
    return (np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy(),
            bound.numpy())


@pytest.mark.parametrize("layout", ["pool", "slots"])
@pytest.mark.parametrize("Q", [2, 5, 8, 16])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_bf16_pallas_verify_within_the_rounding_bound(layout, Q, Dh):
    """JAX's bf16 Pallas verify kernel (P rounded before P V) against the
    port's plain version (P in f32): within 2^-12 + 2^-7 |want| + the
    bound, element by element, dead rows included, the length-0 slot
    exactly zero on both."""
    jax_o, want, bound = _case(layout, Q, Dh, seed=3 * Q + Dh)
    diff = np.abs(jax_o - want)
    lim = ATOL + RTOL * np.abs(want) + bound
    assert (diff <= lim).all(), float((diff / lim).max())
    assert (jax_o[3] == 0).all() and (want[3] == 0).all()


@pytest.mark.parametrize("layout", ["pool", "slots"])
def test_the_bound_is_needed(layout):
    """The waves above fall outside the bf16 ulp tolerance without the
    bound: the rounding of P is what it covers."""
    jax_o, want, _ = _case(layout, 16, 64, seed=3 * 16 + 64)
    assert (np.abs(jax_o - want) > ATOL + RTOL * np.abs(want)).any()
