"""The arithmetic of the wide waves on the card of f32 K1 and f32 K8
(``ragged_paged_attention`` / ``ragged_attention``, f32 q over an f32
pool or slot rows at Q > 16) and of their f32-q int8 twins (f32 q over
an int8 cache with f32 scales): the TF32 tensor-core body of
csrc/ragged_tf32.cuh, against the JAX package's Pallas kernels in
interpret mode, and against the port's plain versions, within f32's
tolerance.

The body is f32 K2's (csrc/flash_fwd.cu, flash_tf32.cuh) over a slot's
positions: 64-row q tiles; key tiles of 64 positions (32 at head dim
128) up to the q tile's largest row limit; each f32 operand x split into
x_hi = tf32(x) and x_lo = tf32(x - x_hi) and every product of S = Q K^T
and of each tile's P V formed as a_lo b_hi + a_hi b_lo + a_hi b_hi in
f32; the online softmax in log2 units against the running max (p =
2^(s Dh^-1/2 log2 e - m), dead keys at NEG_INF, the max clamped to 0
while nothing is live); each tile's P V from zero, then acc = alpha acc
+ P V.  Row jq of slot b sees the positions up to clip(len - q_len +
jq, 0, len - 1), so rows past q_len see the whole slot; a slot of
length 0 outputs zeros.  An int8 cache is dequantized as payload * scale
(``kv_decode``'s values) before the split, as the kernel dequantizes
each tile once it has landed.  :func:`_emulate` is that arithmetic in
PyTorch on the CPU.  A key tile wholly past a row's limit changes
nothing of it (p = 0, alpha = 1), so the emulation runs every row of a
slot over the key tiles up to the slot's largest limit, as the kernel
runs a warp's 16.  It is held to JAX's f32 ``ragged_paged_attention``
(the pool) and ``ragged_attention`` (the pool's slot rows), over the f32
cache and over its ``kv_encode`` (interpret mode), and to
``ragged_paged_reference`` / ``ragged_masked_reference``, within 1e-5 +
1e-5 |want| element by element, over waves of 16-position pool blocks at
Q 17, 64, 256 and 1024 and head dims 32, 64 and 128: lengths on and off
tile and block edges and 0, an inert q_len-0 slot with a length, dead
rows, two slots sharing pool blocks.  One TF32 pass (a_hi b_hi alone)
misses that tolerance: the split is what holds it.
"""

import functools

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from hetu_tpu.kernels import ragged_attention as jra
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.quant import kv_decode, kv_encode

H, BS = 2, 16
ATOL, RTOL = 1e-5, 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` (the kernel's integer
    add to the magnitude and mask of the 13 low bits), as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a, b, passes):
    """a @ b from the TF32 parts of a and b: 3 passes (lo hi + hi lo + hi
    hi) or 1 (hi hi), in f32."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def bk_of(Dh):
    """Keys per K/V tile of the kernel."""
    return 32 if Dh == 128 else 64


def _wave(Q, Dh, seed):
    """Eight slots over a permuted pool of 16-position blocks: lengths
    Q + 37 (the widest, past a tile edge), 128 (on tile and block edges,
    q_len Q / 2: dead rows past it), 65 (one past a tile), 0, 96 (inert:
    q_len 0), 16, 5 and 200, whose first two blocks are slot 2's; q_lens
    clipped to the lengths.  Returns torch f32 (q [B, Q, H, Dh], pool_k,
    pool_v) and int32 (lengths, q_lens, tables)."""
    lengths = np.array([Q + 37, 128, 65, 0, 96, 16, 5, 200], np.int32)
    q_lens = np.minimum(np.array([Q, Q // 2, 3, 0, 0, 16, 5, 1], np.int32),
                        lengths)
    B = len(lengths)
    T = -(-int(lengths.max()) // BS)
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


def _emulate(q, k, v, lengths, q_lens, passes=3):
    """The wide body's arithmetic over slot rows (q [B, Q, H, Dh], k/v
    [B, S, H, Dh] f32), in f32: [B, Q, H, Dh], zeros on a length-0
    slot."""
    B, Q, Hn, Dh = q.shape
    BK = bk_of(Dh)
    c = np.float32(Dh ** -0.5) * np.float32(LOG2E)
    o = torch.zeros_like(q)
    for b in range(B):
        n, ql = int(lengths[b]), int(q_lens[b])
        if n == 0:
            continue
        lim = torch.clamp(n - ql + torch.arange(Q), 0, n - 1)   # [Q]
        kv_end = int(lim.max()) + 1
        for h in range(Hn):
            m = torch.full((Q,), NEG_INF)
            l = torch.zeros(Q)
            acc = torch.zeros((Q, Dh))
            for t0 in range(0, kv_end, BK):
                keys = torch.arange(t0, min(t0 + BK, kv_end))
                s = product(q[b, :, h], k[b, keys, h].T, passes)
                s = torch.where(keys[None] <= lim[:, None], s,
                                torch.full_like(s, NEG_INF))
                mx = s.amax(-1)
                m_new = torch.maximum(m, torch.where(
                    mx <= NEG_INF / 2, torch.full_like(mx, NEG_INF), mx * c))
                safe = torch.where(m_new <= NEG_INF / 2,
                                   torch.zeros_like(m_new), m_new)
                alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                                    torch.exp2(m - m_new))
                p = torch.exp2(s * c - safe[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + product(p, v[b, keys, h],
                                                     passes)
                m = m_new
            o[b, :, h] = acc / torch.where(l == 0, torch.ones_like(l),
                                           l)[:, None]
    return o


@functools.lru_cache(maxsize=None)
def _case(Q, Dh, layout, cache, passes=3):
    """(JAX's f32 o, the port's plain o, the emulated body's o), numpy,
    one wave through the pool (K1) or its slot rows (K8), over the f32
    cache or (``cache`` "int8") its ``kv_encode``, which the body
    dequantizes to ``kv_decode``'s values."""
    q, pk, pv, lens, ql, tab = _wave(Q, Dh, Q + Dh)
    B, T = tab.shape

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
        pk, pv = kv_decode(k8, ks), kv_decode(v8, vs)
    idx = (lens, ql, tab) if layout == "pool" else (lens, ql)
    jax_fn = (jra.ragged_paged_attention if layout == "pool"
              else jra.ragged_attention)
    want = jax_fn(*(jnp.asarray(x.numpy()) for x in (q, *kv, *idx)),
                  **dict(zip(("k_scale", "v_scale"),
                             (jnp.asarray(x.numpy()) for x in sc))),
                  interpret=True)
    if layout == "pool":
        plain = tra.ragged_paged_reference(q, *kv, *idx, *sc)
    else:
        plain = tra.ragged_masked_reference(q, *kv, *idx, *sc)
    emu = _emulate(q, rows(pk), rows(pv), lens, ql, passes)
    assert want.dtype == jnp.float32 and emu.dtype == torch.float32
    return np.asarray(want), plain.numpy(), emu.numpy()


# (Dh, Q, layout, cache): f32 K1 (the f32 pool) at every Q and head dim;
# the slot rows (K8) and the int8 caches (K1-int8, K8-int8) at Q 17 and
# 256
CASES = [pytest.param(Dh, Q, layout, cache, id=f"{Dh}-{Q}-{layout}-{cache}")
         for layout in ("pool", "slots") for cache in ("f32", "int8")
         for Dh in (32, 64, 128)
         for Q in ((17, 64, 256, 1024) if (layout, cache) == ("pool", "f32")
                   else (17, 256))]


def _ratio(want, got):
    """The largest |got - want| / (1e-5 + 1e-5 |want|)."""
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


@pytest.mark.parametrize("Dh,Q,layout,cache", CASES)
def test_tf32_wide_arithmetic_holds_the_jax_kernel(Dh, Q, layout, cache):
    """The wide body's three-pass arithmetic against JAX's Pallas K1 (the
    pool) or K8 (slot rows) in f32, over an f32 cache or its int8
    encoding (interpret mode): within 1e-5 + 1e-5 |want|, the length-0
    slot exactly zero on both."""
    want, _, emu = _case(Q, Dh, layout, cache)
    assert _ratio(want, emu) <= 1.0
    assert (want[3] == 0).all() and (emu[3] == 0).all()


@pytest.mark.parametrize("Dh,Q,layout,cache", CASES)
def test_tf32_wide_arithmetic_holds_the_plain_version(Dh, Q, layout, cache):
    """The same arithmetic against ``ragged_paged_reference`` (the pool)
    or ``ragged_masked_reference`` (slot rows), which the kernels are
    held to on the card, within the same tolerance."""
    _, plain, emu = _case(Q, Dh, layout, cache)
    assert _ratio(plain, emu) <= 1.0
    assert (plain[3] == 0).all()


@pytest.mark.parametrize("Dh", [64, 128])
def test_one_tf32_pass_misses_f32_parity(Dh):
    """A single TF32 pass (a_hi b_hi) is about 2^-11 off per product: it
    misses 1e-5 + 1e-5 |want| on a Q 64 wave, so the split is needed."""
    want, _, emu = _case(64, Dh, "pool", "f32", passes=1)
    assert _ratio(want, emu) > 10.0

