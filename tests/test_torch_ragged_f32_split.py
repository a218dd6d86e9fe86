"""The arithmetic of the narrow waves on the card of f32 K1 and f32 K8
(``ragged_paged_attention`` / ``ragged_attention``, f32 q over an f32
pool or slot rows at Q <= 16), of f32-q K1-int8 (f32 q over an int8
pool with f32 scales), and of f32 K6/K7 and their f32-q int8 twins
(``paged_verify_attention`` / ``paged_block_verify_attention``, a verify
block of at most 16 rows): the split-K CUDA-core body of
csrc/split_kv_f32.cuh, against the JAX package's Pallas kernels in
interpret mode, and against the port's plain versions, within f32's
tolerance.

The body cuts each slot's positions into splits of 128; in a split, warp
w takes 32 keys, forms s = q . k in f32, masks the keys past each row's
limit, and takes its softmax in log2 units: m_w = max(s) Dh^-1/2 log2 e,
p = 2^(s Dh^-1/2 log2 e - m_w), l_w = sum p, acc_w = p . v, nothing
rounded.  The four warps of a split, then the splits, merge by 2^(m_i -
M) in f32, skipping those with no live key, and o = acc / l.  An int8
cache is dequantized as payload * scale as the products read it (the
plain version's dequantized values), and the same arithmetic follows.
A verify row's limit is a ragged row's (VerifyLim is RaggedLim's clip).
:func:`_emulate` is that arithmetic in PyTorch on the CPU.  It is held
to JAX's f32 ``ragged_paged_attention`` (the pool) and
``ragged_attention`` (the pool's slot rows), and to its
``paged_block_verify_attention`` (the pool) and
``paged_verify_attention`` (slot rows) on their live rows (JAX's dead
verify rows are finite garbage), over the f32 cache and over its
``kv_encode`` with ``k_scale``/``v_scale`` (interpret mode), and on
every row to ``ragged_paged_reference`` / ``ragged_masked_reference``
(``paged_block_verify_reference`` / ``masked_verify_reference`` for the
verify kernels) within 1e-5 + 1e-5 |want| element by element (the sums
taken in another order, and 2^x in place of e^x), over waves of
16-position pool blocks: the ragged kernels at Q 1 (decode), 8 (verify)
and 16 (the widest narrow wave), the verify kernels at Q 2, 5, 8 and 16;
head dims 32, 64 and 128; lengths on and off split and block edges
(300, 256, 131, 128, 16, 5, 0, 33), an inert q_len-0 slot with a
length, dead rows, and two slots sharing pool blocks; the length-0 slot
is zero.
"""

import math

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import decode_attention as jda
from hetu_tpu.kernels import ragged_attention as jra
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.quant import kv_decode, kv_encode

H, BS, T = 2, 16, 20
ATOL, RTOL = 1e-5, 1e-5
SPLIT, WARP_KEYS = 128, 32        # split_kv_bf16.cuh's kSplit, kSplitKW


def _wave(Q, Dh, seed):
    """Eight slots over a permuted pool of 16-position blocks (tables of
    20 entries, 320 positions): lengths 300 (three key splits), 256 (on
    a split edge), 131, 128 (inert: q_len 0), 16, 5, 0, and 33, whose
    first two blocks are slot 2's; q_lens Q, Q - 1 (a dead row), 1, 0,
    Q, 3, 0, 1, clipped to the lengths.  Returns torch f32 (q [B, Q, H,
    Dh], pool_k, pool_v) and int32 (lengths, q_lens, tables)."""
    lengths = np.array([300, 256, 131, 128, 16, 5, 0, 33], np.int32)
    q_lens = np.minimum(np.array([Q, max(Q - 1, 1), 1, 0, Q, 3, 0, 1],
                                 np.int32), lengths)
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
    q = rng.randn(B, Q, H, Dh).astype(np.float32)
    return tuple(map(torch.from_numpy, (q, pk, pv, lengths, q_lens,
                                        tables)))


def _emulate(q, k, v, lengths, q_lens):
    """The split body's arithmetic over slot rows (q [B, Q, H, Dh], k/v
    [B, S, H, Dh] f32), in f32: row jq of slot b sees positions up to
    clip(len - q_len + jq, 0, len - 1); per warp of 32 keys its raw max
    m_w (log2 units, NEG_INF where no key is live), p = 2^(s scale log2 e
    - m_w) (a max of 0 while no key is live), l_w = sum p, acc_w = p . v;
    the four warps of a split, then the splits, merged by 2^(m_i - M);
    o = acc / l (l = 0 gives 0); zeros on a length-0 slot."""
    B, Q, Hn, Dh = q.shape
    S = k.shape[1]
    n = -(-S // SPLIT)
    pad = n * SPLIT - S
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    neg = tra.NEG_INF
    L, QL = lengths.long(), q_lens.long()
    lim = torch.minimum(torch.clamp(
        (L - QL)[:, None] + torch.arange(Q)[None], min=0),
        (L - 1)[:, None])                                  # [B, Q]
    s = torch.einsum("bqhd,bshd->bhqs", q, k)
    live = torch.arange(n * SPLIT)[None, None, None] \
        <= lim[:, None, :, None]
    s = torch.where(live, s, torch.full_like(s, neg))
    s = s.reshape(B, Hn, Q, -1, WARP_KEYS)          # [B, H, Q, warps, 32]
    c = Dh ** -0.5 * math.log2(math.e)
    mx = s.amax(-1)
    m = torch.where(mx <= neg / 2, torch.full_like(mx, neg), mx * c)
    safe = torch.where(m <= neg / 2, torch.zeros_like(m), m)
    p = torch.exp2(s * c - safe[..., None])
    vw = v.reshape(B, -1, WARP_KEYS, Hn, Dh)
    acc = torch.einsum("bhqwk,bwkhd->bhqwd", p, vw)
    l = p.sum(-1)

    def merge(m, l, acc, group):
        """Combine groups of ``group`` consecutive partials."""
        m = m.reshape(B, Hn, Q, -1, group)
        l = l.reshape(B, Hn, Q, -1, group)
        acc = acc.reshape(B, Hn, Q, -1, group, Dh)
        top = m.amax(-1, keepdim=True)
        w = torch.where(m > neg / 2, torch.exp2(m - top),
                        torch.zeros_like(m))
        return (top[..., 0], (w * l).sum(-1),
                (w[..., None] * acc).sum(-2))

    m, l, acc = merge(m, l, acc, SPLIT // WARP_KEYS)   # a split's warps
    _, l, acc = merge(m, l, acc, n)                    # the splits
    o = acc[..., 0, :] / torch.where(l == 0, torch.ones_like(l),
                                     l)[..., 0, None]
    return o.permute(0, 2, 1, 3)                        # [B, Q, H, Dh]


# (JAX kernel, the port's plain version) of each (kernel, layout)
KERNELS = {("ragged", "pool"): (jra.ragged_paged_attention,
                                tra.ragged_paged_reference),
           ("ragged", "slots"): (jra.ragged_attention,
                                 tra.ragged_masked_reference),
           ("verify", "pool"): (jda.paged_block_verify_attention,
                                tda.paged_block_verify_reference),
           ("verify", "slots"): (jda.paged_verify_attention,
                                 tda.masked_verify_reference)}


def _case(Q, Dh, seed, layout, cache, kernel, with_jax):
    """(JAX's f32 o or, without ``with_jax``, None; the port's plain o
    without ``with_jax``, else None; the emulated body's o; q_lens),
    numpy, one wave through the pool (K1
    or K7) or its slot rows (K8 or K6) of ``kernel`` ("ragged" or
    "verify"), over the f32 cache or (``cache`` "int8") its
    ``kv_encode``, which the body dequantizes to ``kv_decode``'s
    values."""
    q, pk, pv, lens, ql, tab = _wave(Q, Dh, seed)
    B = len(lens)

    def rows(x):
        """The pool's slot rows [B, T*BS, ...] (a scale plane too)."""
        return x[tab.long()].reshape(B, T * BS, *x.shape[2:])
    kv = (pk, pv) if layout == "pool" else (rows(pk), rows(pv))
    sc = ()
    if cache == "int8":
        (k8, ks), (v8, vs) = kv_encode(pk), kv_encode(pv)
        kv, sc = (k8, v8), (ks, vs)
        if layout == "slots":
            kv, sc = tuple(map(rows, kv)), tuple(map(rows, sc))
    idx = (lens, ql, tab) if layout == "pool" else (lens, ql)
    jax_fn, plain_fn = KERNELS[kernel, layout]
    want = None
    if with_jax:
        want = jax_fn(*(jnp.asarray(x.numpy()) for x in (q, *kv, *idx)),
                      **dict(zip(("k_scale", "v_scale"),
                                 (jnp.asarray(x.numpy()) for x in sc))),
                      interpret=True)
        assert want.dtype == jnp.float32
        want = np.asarray(want)
    # the JAX kernel's case reads no plain version
    plain = None if with_jax else plain_fn(q, *kv, *idx, *sc).numpy()
    if cache == "int8":
        pk, pv = kv_decode(k8, ks), kv_decode(v8, vs)
    emu = _emulate(q, rows(pk), rows(pv), lens, ql)
    assert emu.dtype == torch.float32
    return want, plain, emu.numpy(), ql.numpy()


# (Dh, Q, layout, cache, kernel): f32 K1 (the f32 pool) keeps its ids
# "Dh-Q", the slot rows (K8) and the int8 caches (K1-int8, and the same
# arithmetic over slot rows) add theirs, and the verify kernels (K7 over
# the pool, K6 over slot rows, and their int8 twins) "-verify"
CASES = [pytest.param(Dh, Q, layout, cache, kernel,
                      id=f"{Dh}-{Q}" + ("" if (layout, cache) == ("pool",
                                                                  "f32")
                                        and kernel == "ragged"
                                        else f"-{layout}-{cache}")
                      + ("-verify" if kernel == "verify" else ""))
         for kernel, qs in (("ragged", (1, 8, 16)), ("verify", (2, 5, 8, 16)))
         for layout in ("pool", "slots") for cache in ("f32", "int8")
         for Dh in (32, 64, 128) for Q in qs]


def _live(x, q_lens):
    """The rows of ``x`` [B, Q, ...] below each slot's q_len."""
    return np.concatenate([x[b, :n] for b, n in enumerate(q_lens)])


def _ratio(want, got):
    """The largest |got - want| / (1e-5 + 1e-5 |want|)."""
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


@pytest.mark.parametrize("Dh,Q,layout,cache,kernel", CASES)
def test_f32_split_arithmetic_holds_the_jax_kernel(Q, Dh, layout, cache,
                                                   kernel):
    """The split body's f32 arithmetic against JAX's Pallas K1 (the pool)
    or K8 (slot rows), or its K7 / K6 on their live rows, in f32, over an
    f32 cache or its int8 encoding (interpret mode): within 1e-5 + 1e-5
    |want|, the length-0 slot exactly zero on both."""
    want, _, emu, q_lens = _case(Q, Dh, Q + Dh, layout, cache, kernel,
                                 with_jax=True)
    if kernel == "verify":
        assert _ratio(_live(want, q_lens), _live(emu, q_lens)) <= 1.0
    else:
        assert _ratio(want, emu) <= 1.0
    assert (want[6] == 0).all() and (emu[6] == 0).all()


@pytest.mark.parametrize("Dh,Q,layout,cache,kernel", CASES)
def test_f32_split_arithmetic_holds_the_plain_version(Q, Dh, layout,
                                                      cache, kernel):
    """The same arithmetic against ``ragged_paged_reference`` (the pool)
    or ``ragged_masked_reference`` (slot rows), or the verify kernels'
    ``paged_block_verify_reference`` / ``masked_verify_reference``,
    which the kernels are held to on the card, within the same
    tolerance on every row, dead rows and the inert slot's included."""
    _, plain, emu, _ = _case(Q, Dh, 2 * Q + Dh, layout, cache, kernel,
                             with_jax=False)
    assert _ratio(plain, emu) <= 1.0
    assert (plain[6] == 0).all()
