"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and nvcc and skips without
them.  The file imports neither JAX nor the JAX package, so on a machine
with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances, element by element ``|got - want| <= atol + rtol*|want|``:
f32 ``atol 1e-5`` (the kernels sum the softmax in another order than
the plain versions); bf16 ``atol 2^-12, rtol 2^-7`` (both sides round
an f32 result to bf16, at most one bf16 ulp apart).  The int8 twins are
held to the same: both sides form the same f32 product payload * scale.
The bf16 ragged kernels (K1, K8: csrc/ragged_paged_bf16.cu, wgmma
past 16 rows, split-K at most 16) round P to bf16 before P V as the
Pallas body does, and their plain versions do not: they are held to
the bf16 tolerance plus ``ragged_rounding_bound`` (``assert_ragged_close``),
and so are the bf16 decode and verify kernels (K4-K7:
csrc/decode_attention_bf16.cu, the split-K body of K1/K8's narrow
waves), which round P where the Pallas decode and verify bodies round
it.  Their int8 twins for bf16 q (K1-int8,
K8-int8 and K4-int8 to K7-int8 on the same bodies: the payload widened
to bf16 exactly, the K scale applied to the scores in f32, P times the V
scale split into a bf16 pair, two products) do not round P, as the
Pallas int8 bodies, which compute in f32, do not: they are held to the
bf16 tolerance alone.
The narrow waves (Q <= 16) of f32 K1, f32 K8, f32-q K1-int8 and f32-q
K8-int8, f32 K4-K7, and f32-q K4-int8 to K7-int8, run the split-K
CUDA-core body (csrc/split_kv_f32.cuh) and are held to f32's tolerance;
f32 K8 equals f32 K1 bit for bit on one wave, and so does f32-q K8-int8
f32-q K1-int8; f32-q K1-int8 equals f32 K1 over the decoded cache; f32
K4 and K6 equal f32 K8 and f32 K5 and K7 equal f32 K1 on the same wave
(a decode call at Q 1), bit for bit;
in either q dtype K6-int8 and K4-int8 run K8-int8's split body, and
K5-int8 and K7-int8 K1-int8's, and equal it bit for bit.
The bf16 flash forward (K2, K2-carry) is held to the bound of its
rounding of P, stated at ``flash_tol``; the flash backward (K3) to its
own, stated at ``k3_close``; the f32 carried forward (K2-carry), whose
output is f32, to ``atol 1e-5, rtol 1e-5`` (``CARRY_TOL``).  The bf16
flash kernels run on the tensor cores (csrc/flash_*_bf16.cu), and so
do the f32 forward and backward, in three TF32 passes
(csrc/flash_fwd.cu, csrc/flash_bwd.cu), the forward held to f32's
tolerance and the backward to ``k3_close``.  The verify wrappers past 16
rows launch once per 16-row group; the ring runs on a virtual mesh of
the card.
"""

import numpy as np
import pytest
import torch

from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import flash_attention as tfa
from hetu_tpu_torch.kernels import (launch_counts, regime_counts,
                                    reset_launches)
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.quant import kv_decode, kv_encode

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


def assert_ragged_close(got, want, args, dtype):
    """K1/K8 (and K6/K7) over a float cache against their plain version,
    element by element: ``TOL``; in bf16 plus ``ragged_rounding_bound``
    of the call's arguments (the kernel rounds P to bf16 before P V, as
    the Pallas body does; the plain version does not; one rounding is
    within 2^-8 of p, so o_d within 2^-8 sum(p |v_d|) / l)."""
    bound = (tra.ragged_rounding_bound(*args)
             if dtype == "bfloat16" else None)
    assert_within(got, want, dtype, bound)


def assert_within(got, want, dtype, bound=None):
    """``TOL[dtype]`` element by element, plus ``bound`` (a tensor of
    want's shape: ``ragged_rounding_bound``) where given."""
    atol, rtol = TOL[dtype]["atol"], TOL[dtype]["rtol"]
    if bound is not None:
        atol = atol + bound.cpu().numpy()
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    lim = atol + rtol * np.abs(want)
    diff = np.abs(got - want)
    assert (diff <= lim).all(), (
        f"largest err / bound {float((diff / lim).max())}, max abs error "
        f"{float(diff.max())}")


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
    assert_ragged_close(got, want, args, dtype)
    assert (got[3] == 0).all()


def _slot_rows(pk, tables):
    """The pool gathered into slot rows [B, T*bs, H, Dh] (contiguous)."""
    B, T = tables.shape
    idx = torch.from_numpy(tables).long()
    return pk[idx].reshape(B, T * pk.shape[1], *pk.shape[2:]).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,bs,Q", [(64, 16, 64), (32, 8, 1),
                                     (128, 16, 40)])
def test_ragged_contiguous_kernel_matches_plain(cuda, dtype, Dh, bs, Q):
    q, pk, pv, lens, ql, tab = _wave(Dh, bs, Q, seed=2)
    dt = getattr(torch, dtype)
    args = [q.to(cuda, dt), _slot_rows(pk, tab).to(cuda, dt),
            _slot_rows(pv, tab).to(cuda, dt)] + [
        torch.from_numpy(a).to(cuda) for a in (lens, ql)]
    reset_launches()
    got = tra.ragged_attention(*args)
    torch.cuda.synchronize()
    assert launch_counts()["ragged_attention"] == 1
    want = tra.ragged_masked_reference(*args).to(dt)
    assert_ragged_close(got, want, args, dtype)
    assert (got[3] == 0).all()


def _long_wave(Dh, Q, q_lens, seed, H=3, bs=16,
               lengths=(1000, 257, 1, 0)):
    """Slots of ``lengths`` (by default four, 1000, 257, 1 and 0: the
    first two cross several 128-position key splits) over a permuted
    pool of 16-position blocks, slot 2's block shared with slot 1's
    first; q_lens (one per slot) clipped to the lengths.  Returns numpy
    (q, pool_k, pool_v, lengths, q_lens, tables) as ``_wave``."""
    lengths = np.array(lengths, np.int32)
    q_lens = np.minimum(np.asarray(q_lens, np.int32), lengths)
    B, T = len(lengths), 1024 // bs
    rng = np.random.RandomState(seed)
    need = [-(-int(n) // bs) for n in lengths]
    free = list(rng.permutation(np.arange(1, 1 + sum(need))))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    tables[2, 0] = tables[1, 0]               # a shared block
    g = torch.Generator().manual_seed(seed)
    pk, pv = (torch.randn((1 + sum(need), bs, H, Dh), generator=g)
              for _ in range(2))
    q = torch.randn((B, Q, H, Dh), generator=g)
    return q, pk, pv, lengths, q_lens, tables


def _bf16_both_layouts(cuda, q, pk, pv, lens, ql, tab, int8=False):
    """One bf16 wave through K1 (the pool) and K8 (its slot rows), or
    with ``int8`` through K1-int8 and K8-int8 over the caches'
    ``kv_encode``: for each, (kernel output, plain output, the call's
    arguments, its scale keywords, the kernel's name, the launch and
    regime counts the call made)."""
    dt = torch.bfloat16
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    out = []
    for run, plain, name, kv in (
            (tra.ragged_paged_attention, tra.ragged_paged_reference,
             "ragged_paged_attention", (pk, pv)),
            (tra.ragged_attention, tra.ragged_masked_reference,
             "ragged_attention",
             tuple(_slot_rows(x, tab) for x in (pk, pv)))):
        sc = {}
        if int8:
            (k, ks), (v, vs) = (_int8(x, cuda) for x in kv)
            kv, sc, name = (k, v), dict(k_scale=ks, v_scale=vs), \
                f"{name}_int8"
        args = [q.to(cuda, dt)] + [x.to(cuda, x.dtype if int8 else dt)
                                   for x in kv] + idx[:2] \
            + (idx[2:] if run is tra.ragged_paged_attention else [])
        reset_launches()
        got = run(*args, **sc)
        torch.cuda.synchronize()
        out.append((got, plain(*args, *sc.values()).to(dt), args, sc, name,
                    {**launch_counts(), **regime_counts()}))
    return out


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 5, 8, 16])
def test_bf16_ragged_narrow_waves(cuda, Dh, Q):
    """Decode and verify waves (Q <= 16, split-K over positions, then the
    merge): lengths 1000, 257, 1 and 0 cross several key splits, a slot
    with fewer live rows than Q has dead rows, one slot shares a pool
    block; one counted launch per call, the length-0 slot zero."""
    wave = _long_wave(Dh, Q, [Q, max(Q - 2, 1), 1, 0], seed=Q + Dh)
    for got, want, args, _, name, counts in _bf16_both_layouts(cuda,
                                                                *wave):
        assert counts[name] == counts[f"{name}:narrow"] == 1
        assert counts[f"{name}:wide"] == 0
        assert_ragged_close(got, want, args, "bfloat16")
        assert (got[3] == 0).all()


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [17, 64, 256])
def test_bf16_ragged_wide_waves(cuda, Dh, Q):
    """Prompt-chunk waves (Q > 16, the wgmma body): a full q-block, a
    shorter one (dead rows past it), an inert slot with a length (q_len
    0: every row dead), the length-0 slot, one shared pool block; one
    counted launch per call, the length-0 slot zero."""
    wave = _long_wave(Dh, Q, [Q, Q // 2, 0, 0], seed=2 * Q + Dh)
    for got, want, args, _, name, counts in _bf16_both_layouts(cuda,
                                                                *wave):
        assert counts[name] == counts[f"{name}:wide"] == 1
        assert counts[f"{name}:narrow"] == 0
        assert_ragged_close(got, want, args, "bfloat16")
        assert (got[3] == 0).all()


def test_bf16_ragged_wrappers_refuse_misaligned_data(cuda):
    """The bf16 ragged kernels copy 16-byte chunks: a q, k or v that does
    not start on a 16-byte boundary is refused, not read."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 8)
    dt = torch.bfloat16
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    x = torch.zeros(pk.numel() + 4, device=cuda, dtype=dt)
    bad = x[4:].view(pk.shape)                  # 8 bytes past the start
    bad.copy_(pk.to(cuda, dt))
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(q.to(cuda, dt), bad, pv.to(cuda, dt),
                                   lens_d, ql_d, tab_d)
    rows = _slot_rows(pk, tab).to(cuda, dt)
    x = torch.zeros(q.numel() + 4, device=cuda, dtype=dt)
    qbad = x[4:].view(q.shape)
    assert qbad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(qbad, rows, rows, lens_d, ql_d)


def _record_loads(monkeypatch):
    """Record the kernel libraries the wrappers load and the C entries
    they look up in them, in order: returns (libraries, entries)."""
    from hetu_tpu_torch.kernels import _build
    libs, entries = [], []
    library = _build.library

    class Seen:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            entries.append(name)
            return getattr(self._lib, name)

    def load(name):
        libs.append(name)
        return Seen(library(name))
    monkeypatch.setattr(_build, "library", load)
    return libs, entries


def _nonzero_launches():
    from hetu_tpu_torch.kernels import _build
    return {k: n for k, n in _build.LAUNCHES.items() if n}


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 2, 5, 8, 16])
def test_f32_ragged_narrow_waves_on_the_split_body(cuda, monkeypatch, Dh,
                                                   Q):
    """f32 K1, f32 K8 and f32-q K1-int8 on decode and verify waves (Q <=
    16: the split-K CUDA-core body of split_kv_f32.cuh, then the merge):
    lengths 1000, 257, 1 and 0 cross several 128-position key splits, a
    q-block of Q rows, a shorter one (dead rows), an inert q_len-0 slot
    with a length sharing a pool block, the length-0 slot.  Each within
    1e-5 of its plain version, its library loaded and its narrow entry
    called, one launch counted under the wrapper's name and ``:narrow``,
    the length-0 slot zero: K1 (``ragged_paged``) over the pool, K8 (the
    same library) over the pool's slot rows, equal to K1 bit for bit
    (one body, one row limit, one split order), and K1-int8
    (``ragged_paged_int8``) over the pool's ``kv_encode``, equal bit for
    bit to K1 over its ``kv_decode`` (the body dequantizes the payload to
    exactly those values)."""
    q, pk, pv, lens, ql, tab = _long_wave(Dh, Q, [Q, max(Q - 2, 1), 0, 0],
                                          seed=7 * Q + Dh)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    args = [q.to(cuda), pk.to(cuda), pv.to(cuda)] + idx
    libs, entries = _record_loads(monkeypatch)
    reset_launches()
    got = tra.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert libs == ["ragged_paged"]
    assert entries == ["hetu_ragged_f32_workspace",
                       "hetu_ragged_paged_attention_narrow"]
    assert _nonzero_launches() == {"ragged_paged_attention": 1,
                                   "ragged_paged_attention:narrow": 1}
    assert_within(got, tra.ragged_paged_reference(*args), "float32")
    assert (got[3] == 0).all()

    k, v = (_slot_rows(x, tab).to(cuda) for x in (pk, pv))
    slot_args = [args[0], k, v] + idx[:2]
    del libs[:], entries[:]
    reset_launches()
    got8 = tra.ragged_attention(*slot_args)
    torch.cuda.synchronize()
    assert libs == ["ragged_paged"]
    assert entries == ["hetu_ragged_f32_workspace",
                       "hetu_ragged_attention_narrow"]
    assert _nonzero_launches() == {"ragged_attention": 1,
                                   "ragged_attention:narrow": 1}
    assert_within(got8, tra.ragged_masked_reference(*slot_args), "float32")
    assert torch.equal(got8, got)

    (k8, ks), (v8, vs) = (_int8(x, cuda) for x in (pk, pv))
    sc = dict(k_scale=ks, v_scale=vs)
    del libs[:], entries[:]
    reset_launches()
    got_q = tra.ragged_paged_attention(args[0], k8, v8, *idx, **sc)
    torch.cuda.synchronize()
    assert libs == ["ragged_paged_int8"]
    assert entries == ["hetu_ragged_f32_workspace",
                       "hetu_ragged_paged_attention_int8_narrow"]
    assert _nonzero_launches() == {"ragged_paged_attention_int8": 1,
                                   "ragged_paged_attention_int8:narrow": 1}
    assert_within(got_q, tra.ragged_paged_reference(args[0], k8, v8, *idx,
                                                    ks, vs), "float32")
    assert (got_q[3] == 0).all()
    deq = tra.ragged_paged_attention(args[0], kv_decode(k8, ks),
                                     kv_decode(v8, vs), *idx)
    assert torch.equal(got_q, deq)

    (r8, rs), (w8, ws) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
    slot_args = [args[0], r8, w8] + idx[:2]
    del libs[:], entries[:]
    reset_launches()
    got_q8 = tra.ragged_attention(*slot_args, k_scale=rs, v_scale=ws)
    torch.cuda.synchronize()
    assert libs == ["ragged_paged_int8"]
    assert entries == ["hetu_ragged_f32_workspace",
                       "hetu_ragged_attention_int8_narrow"]
    assert _nonzero_launches() == {"ragged_attention_int8": 1,
                                   "ragged_attention_int8:narrow": 1}
    assert_within(got_q8, tra.ragged_masked_reference(*slot_args, rs, ws),
                  "float32")


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 8, 16])
def test_f32_q_k8_int8_equals_k1_int8_bit_for_bit(cuda, Dh, Q):
    """f32-q K8-int8 over int8 slot rows and f32-q K1-int8 over the int8
    pool they were gathered from, on one narrow wave: one split body,
    one row limit, one split order, only the row addresses differ, so
    the outputs are equal bit for bit (and within 1e-5 of the plain
    version)."""
    q, pk, pv, lens, ql, tab = _long_wave(Dh, Q, [Q, max(Q - 2, 1), 1, 0],
                                          seed=5 * Q + Dh)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    qd = q.to(cuda)
    (k8, ks), (v8, vs) = (_int8(x, cuda) for x in (pk, pv))
    reset_launches()
    k1 = tra.ragged_paged_attention(qd, k8, v8, *idx, k_scale=ks,
                                    v_scale=vs)
    tab_d = idx[2].long()

    def rows(x):
        B, T = tab_d.shape
        return x[tab_d].reshape(B, T * x.shape[1], *x.shape[2:]) \
            .contiguous()
    k8_out = tra.ragged_attention(qd, rows(k8), rows(v8), *idx[:2],
                                  k_scale=rows(ks), v_scale=rows(vs))
    torch.cuda.synchronize()
    assert regime_counts()["ragged_attention_int8:narrow"] == 1
    assert regime_counts()["ragged_paged_attention_int8:narrow"] == 1
    assert torch.equal(k8_out, k1)
    assert_within(k8_out, tra.ragged_masked_reference(
        qd, rows(k8), rows(v8), *idx[:2], rows(ks), rows(vs)), "float32")


def test_f32_ragged_wide_waves_keep_the_cuda_core_body(cuda, monkeypatch):
    """f32 K1, f32 K8, f32-q K1-int8 and f32-q K8-int8 at Q 17 (the wide
    regime) launch their wide entries (the TF32 tensor-core body of
    ragged_tf32.cuh since it replaced the CUDA-core one), not the narrow
    ones, each within 1e-5 of its plain version."""
    q, pk, pv, lens, ql, tab = _long_wave(64, 17, [17, 9, 0, 0], seed=17)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    args = [q.to(cuda), pk.to(cuda), pv.to(cuda)] + idx
    libs, entries = _record_loads(monkeypatch)
    reset_launches()
    got = tra.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert entries == ["hetu_ragged_paged_attention"]
    assert _nonzero_launches() == {"ragged_paged_attention": 1,
                                   "ragged_paged_attention:wide": 1}
    assert_within(got, tra.ragged_paged_reference(*args), "float32")
    k, v = (_slot_rows(x, tab).to(cuda) for x in (pk, pv))
    got = tra.ragged_attention(args[0], k, v, *idx[:2])
    torch.cuda.synchronize()
    assert libs == ["ragged_paged"] * 2
    assert entries[1:] == ["hetu_ragged_attention"]
    assert regime_counts()["ragged_attention:wide"] == 1
    assert_within(got, tra.ragged_masked_reference(args[0], k, v,
                                                   *idx[:2]), "float32")
    (k8, ks), (v8, vs) = (_int8(x, cuda) for x in (pk, pv))
    got = tra.ragged_paged_attention(args[0], k8, v8, *idx, k_scale=ks,
                                     v_scale=vs)
    torch.cuda.synchronize()
    assert libs[2:] == ["ragged_paged_int8"]
    assert entries[2:] == ["hetu_ragged_paged_attention_int8"]
    assert regime_counts()["ragged_paged_attention_int8:wide"] == 1
    assert_within(got, tra.ragged_paged_reference(args[0], k8, v8, *idx,
                                                  ks, vs), "float32")
    (k8, ks), (v8, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
    got = tra.ragged_attention(args[0], k8, v8, *idx[:2], k_scale=ks,
                               v_scale=vs)
    torch.cuda.synchronize()
    assert libs[3:] == ["ragged_paged_int8"]
    assert entries[3:] == ["hetu_ragged_attention_int8"]
    assert regime_counts()["ragged_attention_int8:wide"] == 1
    assert_within(got, tra.ragged_masked_reference(args[0], k8, v8,
                                                   *idx[:2], ks, vs),
                  "float32")


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [17, 64, 256, 1024])
def test_f32_ragged_wide_waves_on_the_tensor_cores(cuda, monkeypatch, Dh,
                                                   Q):
    """f32 K1, f32 K8, f32-q K1-int8 and f32-q K8-int8 on prompt-chunk
    waves (Q > 16: the TF32 body of ragged_tf32.cuh): lengths 1000, 257,
    1 and 0 cross many key tiles, a full q-block, a shorter one (dead
    rows past it), an inert q_len-0 slot with a length sharing a pool
    block, the length-0 slot.  Each within 1e-5 of its plain version,
    its wide entry called, one launch counted under the wrapper's name
    and ``:wide``, the length-0 slot zero; K8 equal to K1 bit for bit
    (one body, one row limit, one tile order), K1-int8 equal bit for bit
    to K1 over ``kv_decode`` (the body dequantizes the payload to those
    values) and K8-int8 to K1-int8."""
    q, pk, pv, lens, ql, tab = _long_wave(Dh, Q, [Q, Q // 2, 0, 0],
                                          seed=3 * Q + Dh)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    qd = q.to(cuda)
    (k8, ks), (v8, vs) = (_int8(x, cuda) for x in (pk, pv))
    rows = [_slot_rows(x.cpu(), tab).to(cuda) for x in (pk, pv)]
    rows8 = [_slot_rows(x.cpu(), tab).to(cuda) for x in (k8, ks, v8, vs)]
    calls = (
        ("ragged_paged", "hetu_ragged_paged_attention",
         "ragged_paged_attention", tra.ragged_paged_attention,
         tra.ragged_paged_reference, [qd, pk.to(cuda), pv.to(cuda)] + idx,
         ()),
        ("ragged_paged", "hetu_ragged_attention", "ragged_attention",
         tra.ragged_attention, tra.ragged_masked_reference,
         [qd] + rows + idx[:2], ()),
        ("ragged_paged_int8", "hetu_ragged_paged_attention_int8",
         "ragged_paged_attention_int8", tra.ragged_paged_attention,
         tra.ragged_paged_reference, [qd, k8, v8] + idx, (ks, vs)),
        ("ragged_paged_int8", "hetu_ragged_attention_int8",
         "ragged_attention_int8", tra.ragged_attention,
         tra.ragged_masked_reference,
         [qd, rows8[0], rows8[2]] + idx[:2], (rows8[1], rows8[3])))
    libs, entries = _record_loads(monkeypatch)
    outs = []
    for lib, entry, name, run, plain, args, sc in calls:
        del libs[:], entries[:]
        reset_launches()
        kw = dict(zip(("k_scale", "v_scale"), sc))
        got = run(*args, **kw)
        torch.cuda.synchronize()
        assert libs == [lib] and entries == [entry]
        assert _nonzero_launches() == {name: 1, f"{name}:wide": 1}
        assert_within(got, plain(*args, *sc), "float32")
        assert (got[3] == 0).all()
        outs.append(got)
    assert torch.equal(outs[1], outs[0])
    assert torch.equal(outs[3], outs[2])
    deq = tra.ragged_paged_attention(qd, kv_decode(k8, ks),
                                     kv_decode(v8, vs), *idx)
    assert torch.equal(outs[2], deq)


def test_f32_ragged_narrow_wrapper_refuses_misaligned_data(cuda):
    """The f32 split body copies 16-byte chunks: at Q <= 16 a q or a pool
    8 bytes off a 16-byte boundary is refused by f32 K1, so are such
    slot rows by f32 K8, and an int8 payload 8 bytes off (or a scale
    plane 4 bytes off) by f32-q K1-int8 and by f32-q K8-int8; nothing
    launches.  At Q 17 the TF32 body (ragged_tf32.cuh) copies 16-byte
    chunks too: the same pool and payloads are refused there."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 8)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    qd, kd, vd = q.to(cuda), pk.to(cuda), pv.to(cuda)
    rows = _slot_rows(pk, tab).to(cuda)
    (k8, ks), (v8, vs) = (_int8(x, cuda) for x in (pk, pv))
    reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(qd, _off16(kd, 8), vd, *idx)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(_off16(qd, 8), kd, vd, *idx)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(qd, rows, _off16(rows, 8), *idx[:2])
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(_off16(qd, 8), rows, rows, *idx[:2])
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(qd, _off16(k8, 8), v8, *idx, k_scale=ks,
                                   v_scale=vs)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(qd, k8, v8, *idx, k_scale=ks,
                                   v_scale=_off16(vs, 4))
    (r8, rs), (w8, ws) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(qd, _off16(r8, 8), w8, *idx[:2], k_scale=rs,
                             v_scale=ws)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(qd, r8, w8, *idx[:2], k_scale=_off16(rs, 4),
                             v_scale=ws)
    assert not any(launch_counts().values())
    q17 = _wave(64, 16, 17)[0].to(cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(q17, _off16(kd, 8), vd, *idx)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(_off16(q17, 8), kd, vd, *idx)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(q17, _off16(k8, 8), v8, *idx, k_scale=ks,
                                   v_scale=vs)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(q17, _off16(r8, 8), w8, *idx[:2], k_scale=rs,
                             v_scale=ws)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,bs", [(64, 16), (32, 8), (128, 16)])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_decode_kernels_match_plain(cuda, dtype, Dh, bs, layout):
    """K4 over slot rows and K5 through the block tables, on one wave
    with a length-0 slot and lengths off and on block edges; bf16 plus
    ``ragged_rounding_bound`` (the kernel rounds P to bf16 before P V,
    as the Pallas decode body does)."""
    q, pk, pv, lens, _, tab = _wave(Dh, bs, 1, seed=3)
    dt = getattr(torch, dtype)
    q = q[:, 0].to(cuda, dt)
    lens_d, tab_d = (torch.from_numpy(a).to(cuda) for a in (lens, tab))
    reset_launches()
    if layout == "slots":
        k, v = (_slot_rows(x, tab).to(cuda, dt) for x in (pk, pv))
        got = tda.paged_decode_attention(q, k, v, lens_d)
        want = tda.masked_decode_reference(q, k, v, lens_d)
        name, rest = "paged_decode_attention", ()
    else:
        k, v = pk.to(cuda, dt), pv.to(cuda, dt)
        got = tda.paged_block_decode_attention(q, k, v, lens_d, tab_d)
        want = tda.paged_block_decode_reference(q, k, v, lens_d, tab_d)
        name, rest = "paged_block_decode_attention", (tab_d,)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    assert_ragged_close(got[:, None], want.to(dt)[:, None],
                        (q[:, None], k, v, lens_d, torch.ones_like(lens_d))
                        + rest, dtype)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,bs,Q", [(64, 16, 5), (32, 8, 2), (128, 16, 16),
                                     (64, 8, 3)])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_verify_kernels_match_plain(cuda, dtype, Dh, bs, Q, layout):
    """K6 over slot rows and K7 through the block tables, on one verify
    wave with a full q-block, a shorter one, a q_len-0 slot, a length-0
    slot and dead rows (their clipped output is compared too)."""
    q, pk, pv, lens, ql, tab = _wave(Dh, bs, Q, seed=4)
    ql = np.minimum(np.array([Q, Q - 1, 1, 0, Q, 0], np.int32), lens)
    dt = getattr(torch, dtype)
    q = q.to(cuda, dt)
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    reset_launches()
    if layout == "slots":
        k, v = (_slot_rows(x, tab).to(cuda, dt) for x in (pk, pv))
        args = (q, k, v, lens_d, ql_d)
        got = tda.paged_verify_attention(*args)
        want = tda.masked_verify_reference(*args)
        name = "paged_verify_attention"
    else:
        k, v = pk.to(cuda, dt), pv.to(cuda, dt)
        args = (q, k, v, lens_d, ql_d, tab_d)
        got = tda.paged_block_verify_attention(*args)
        want = tda.paged_block_verify_reference(*args)
        name = "paged_block_verify_attention"
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    assert_ragged_close(got, want.to(dt), args, dtype)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q", [17, 33])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_verify_kernels_serve_long_blocks(cuda, dtype, Q, layout):
    """K6/K7 past 16 rows: one launch per 16-row group, every live row
    equal to the plain version over the whole block, and the whole output
    equal to the plain version of each group (dead groups give zeros)."""
    q, pk, pv, lens, _, tab = _wave(64, 16, Q, seed=6)
    lens = np.array([70, 33, 50, 0, 17, 130], np.int32)
    ql = np.array([Q, Q - 1, 16, 0, 1, 0], np.int32)
    dt = getattr(torch, dtype)
    q = q.to(cuda, dt)
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    if layout == "slots":
        k, v = (_slot_rows(x, tab).to(cuda, dt) for x in (pk, pv))
        run, plain = tda.paged_verify_attention, tda.masked_verify_reference
        rest, name = (), "paged_verify_attention"
    else:
        k, v = pk.to(cuda, dt), pv.to(cuda, dt)
        run, plain = (tda.paged_block_verify_attention,
                      tda.paged_block_verify_reference)
        rest, name = (tab_d,), "paged_block_verify_attention"
    reset_launches()
    got = run(q, k, v, lens_d, ql_d, *rest)
    torch.cuda.synchronize()
    assert launch_counts()[name] == -(-Q // 16)

    def bound(*args):
        return (tra.ragged_rounding_bound(*args)
                if dtype == "bfloat16" else None)
    want = plain(q, k, v, lens_d, ql_d, *rest).to(dt)
    whole = bound(q, k, v, lens_d, ql_d, *rest)
    for b, n in enumerate(ql):
        assert_within(got[b, :n], want[b, :n], dtype,
                      None if whole is None else whole[b, :n])
    groups = tda.verify_groups(q, lens_d, ql_d)
    want = torch.cat([plain(qc, k, v, lc, nc, *rest).to(dt)
                      for qc, lc, nc in groups], dim=1)
    assert_within(got, want, dtype, None if whole is None else torch.cat(
        [bound(qc, k, v, lc, nc, *rest) for qc, lc, nc in groups], dim=1))


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_bf16_verify_kernels_cross_key_splits(cuda, monkeypatch, Dh, Q,
                                              layout):
    """bf16 K6/K7 on the tensor-core library: lengths 1000, 257, 1 and 0
    cross several 128-position key splits, a q-block of Q rows, one of
    fewer (dead rows), a one-row slot sharing a pool block, the length-0
    slot zero; one launch counted under the wrapper's name (no regime
    key) and the library loaded is ``decode_attention_bf16``."""
    q, pk, pv, lens, ql, tab = _long_wave(Dh, Q, [Q, max(Q - 2, 1), 1, 0],
                                          seed=3 * Q + Dh)
    dt = torch.bfloat16
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    if layout == "slots":
        run, plain, name = (tda.paged_verify_attention,
                            tda.masked_verify_reference,
                            "paged_verify_attention")
        args = [q.to(cuda, dt)] + [_slot_rows(x, tab).to(cuda, dt)
                                   for x in (pk, pv)] + idx[:2]
    else:
        run, plain, name = (tda.paged_block_verify_attention,
                            tda.paged_block_verify_reference,
                            "paged_block_verify_attention")
        args = [q.to(cuda, dt), pk.to(cuda, dt), pv.to(cuda, dt)] + idx
    from hetu_tpu_torch.kernels import _build
    loaded = []
    library = _build.library
    monkeypatch.setattr(_build, "library",
                        lambda n: loaded.append(n) or library(n))
    reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    assert loaded == ["decode_attention_bf16"]
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == {name: 1}
    assert_ragged_close(got, plain(*args).to(dt), args, "bfloat16")
    assert (got[3] == 0).all()


def test_bf16_verify_wrappers_refuse_misaligned_data(cuda):
    """The bf16 verify kernels copy 16-byte chunks: a q, k or v that does
    not start on a 16-byte boundary is refused, not read, and nothing
    launches (no other kernel takes the call)."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 5)
    dt = torch.bfloat16
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    x = torch.zeros(pk.numel() + 4, device=cuda, dtype=dt)
    bad = x[4:].view(pk.shape)                  # 8 bytes past the start
    bad.copy_(pk.to(cuda, dt))
    assert bad.is_contiguous() and bad.data_ptr() % 16
    reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_block_verify_attention(q.to(cuda, dt), bad,
                                         pv.to(cuda, dt), lens_d, ql_d,
                                         tab_d)
    rows = _slot_rows(pk, tab).to(cuda, dt)
    x = torch.zeros(q.numel() + 4, device=cuda, dtype=dt)
    qbad = x[4:].view(q.shape)
    assert qbad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(qbad, rows, rows, lens_d, ql_d)
    assert not any(launch_counts().values())


def test_verify_kernel_q1_equals_decode_kernel(cuda):
    """A one-row verify block scores what the decode kernel scores, bit
    for bit, over an f32 cache and over an int8 one: f32 K6 and f32 K4
    (and f32-q K6-int8 and K4-int8) are one split body, split_kv_f32.cuh,
    with row limits that agree at q_len 1 (VerifyLim clips as RaggedLim
    does, DecodeLim is RaggedLim there) and one split order, so the sums
    run in the same order; and f32 K6 equals f32 K8 at Q 1."""
    q, pk, pv, lens, _, tab = _wave(64, 16, 1, seed=5)
    k, v = (_slot_rows(x, tab).to(cuda) for x in (pk, pv))
    lens_d = torch.from_numpy(lens).to(cuda)
    ones = torch.ones_like(lens_d)
    qd = q.to(cuda)
    got = tda.paged_verify_attention(qd, k, v, lens_d, ones)
    want = tda.paged_decode_attention(qd[:, 0], k, v, lens_d)
    k8 = tra.ragged_attention(qd, k, v, lens_d, ones)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want)
    assert torch.equal(got, k8)
    (kq, ks), (vq, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
    sc = dict(k_scale=ks, v_scale=vs)
    got = tda.paged_verify_attention(qd, kq, vq, lens_d, ones, **sc)
    want = tda.paged_decode_attention(qd[:, 0], kq, vq, lens_d, **sc)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want)


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 2, 5, 8, 16, 17])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_f32_verify_kernels_equal_the_ragged_kernels(cuda, monkeypatch, Dh,
                                                     Q, cache):
    """f32 K7 (the pool) and f32 K6 (its slot rows), and over an int8
    cache f32-q K7-int8 and K6-int8, run the split-K CUDA-core body of
    split_kv_f32.cuh with VerifyLim, RaggedLim's clip: lengths 1000 and
    257 cross several 128-position key splits, a q-block of Q rows, a
    shorter one (dead rows), an inert q_len-0 slot with a length, the
    length-0 slot zero.  Each call loads only ``decode_attention`` (int8:
    ``decode_attention_int8``), looks up ``hetu_decode_f32_workspace``
    and its verify entry once per 16-row group, and counts one launch a
    group under the wrapper's name (``_int8``); its output equals, bit
    for bit, f32 K1's (K7) or f32 K8's (K6), or their f32-q int8 twins',
    on the same groups, and is within 1e-5 of the plain version on every
    row of each group (past 16 rows, on every live row of the whole
    block too)."""
    q, pk, pv, lens, ql, tab = _long_wave(Dh, Q, [Q, max(Q - 2, 1), 0, 0],
                                          seed=13 * Q + Dh)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    qd = q.to(cuda)
    int8 = cache == "int8"
    if int8:
        (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        k, v, sc = pk.to(cuda), pv.to(cuda), {}
    tab_d = idx[2].long()

    def rows(x):
        B, T = tab_d.shape
        return x[tab_d].reshape(B, T * x.shape[1], *x.shape[2:]) \
            .contiguous()
    rk, rv = rows(k), rows(v)
    rsc = {n: rows(x) for n, x in sc.items()}
    suffix = "_int8" if int8 else ""
    libs, entries = _record_loads(monkeypatch)
    reset_launches()
    k7 = tda.paged_block_verify_attention(qd, k, v, *idx, **sc)
    k6 = tda.paged_verify_attention(qd, rk, rv, *idx[:2], **rsc)
    torch.cuda.synchronize()
    n = -(-Q // 16)
    assert set(libs) == {"decode_attention" + suffix}
    assert entries == (
        ["hetu_decode_f32_workspace",
         f"hetu_paged_block_verify_attention{suffix}"] * n
        + ["hetu_decode_f32_workspace",
           f"hetu_paged_verify_attention{suffix}"] * n)
    assert _nonzero_launches() == {
        f"paged_block_verify_attention{suffix}": n,
        f"paged_verify_attention{suffix}": n}
    groups = (tda.verify_groups(qd, *idx[:2]) if Q > 16
              else [(qd, *idx[:2])])
    k1 = torch.cat([tra.ragged_paged_attention(qc, k, v, lc, nc, idx[2],
                                               **sc)
                    for qc, lc, nc in groups], dim=1)
    k8 = torch.cat([tra.ragged_attention(qc, rk, rv, lc, nc, **rsc)
                    for qc, lc, nc in groups], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(k7, k1)
    assert torch.equal(k6, k8)
    scales = tuple(sc.values())
    plain7 = torch.cat([tda.paged_block_verify_reference(
        qc, k, v, lc, nc, idx[2], *scales) for qc, lc, nc in groups], dim=1)
    plain6 = torch.cat([tda.masked_verify_reference(
        qc, rk, rv, lc, nc, *(rows(x) for x in scales))
        for qc, lc, nc in groups], dim=1)
    assert_within(k7, plain7, "float32")
    assert_within(k6, plain6, "float32")
    whole = tda.paged_block_verify_reference(qd, k, v, *idx, *scales)
    for b, m in enumerate(ql):
        assert_within(k7[b, :m], whole[b, :m], "float32")
    assert (k7[3] == 0).all() and (k6[3] == 0).all()


def test_f32_verify_wrappers_refuse_misaligned_data(cuda, monkeypatch):
    """f32 K6 and K7 copy 16-byte chunks (the split-K body): a q, a cache
    or a pool 8 bytes off a 16-byte boundary is refused, not read; no
    library is loaded and nothing launches."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 5)
    ql = np.minimum(np.array([5, 4, 1, 0, 5, 0], np.int32), lens)
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    qd, kd, vd = q.to(cuda), pk.to(cuda), pv.to(cuda)
    rows = _slot_rows(pk, tab).to(cuda)
    libs, _ = _record_loads(monkeypatch)
    reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_block_verify_attention(qd, _off16(kd, 8), vd, *idx)
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_block_verify_attention(_off16(qd, 8), kd, vd, *idx)
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(qd, rows, _off16(rows, 8), *idx[:2])
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(_off16(qd, 8), rows, rows, *idx[:2])
    assert libs == []
    assert not any(launch_counts().values())


# f32 K4/K5's slots: a long slot, one and two splits' edges (127, 128,
# 129 positions), a single position and a length-0 slot (index 3)
F32_DECODE_LENGTHS = (1000, 129, 1, 0, 127, 128)


def _f32_decode_case(cuda, layout, Dh, seed):
    """f32 decode over the slots of ``F32_DECODE_LENGTHS`` through K4
    (``slots``) or K5 (``pool``): (the wrapper, its plain version, its
    arguments, the ragged kernel of the same layout and its arguments at
    Q 1 with q_lens 1)."""
    q, pk, pv, lens, _, tab = _long_wave(Dh, 1, [1] * 6, seed=seed,
                                         lengths=F32_DECODE_LENGTHS)
    qd = q.to(cuda)
    lens_d, tab_d = (torch.from_numpy(a).to(cuda) for a in (lens, tab))
    ones = torch.ones_like(lens_d)
    if layout == "slots":
        k, v = (_slot_rows(x, tab).to(cuda) for x in (pk, pv))
        return (tda.paged_decode_attention, tda.masked_decode_reference,
                (qd[:, 0], k, v, lens_d), tra.ragged_attention,
                (qd, k, v, lens_d, ones))
    k, v = pk.to(cuda), pv.to(cuda)
    return (tda.paged_block_decode_attention,
            tda.paged_block_decode_reference, (qd[:, 0], k, v, lens_d,
                                               tab_d),
            tra.ragged_paged_attention, (qd, k, v, lens_d, ones, tab_d))


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_f32_decode_kernels_equal_the_ragged_kernels(cuda, monkeypatch, Dh,
                                                     layout):
    """f32 K4 (``slots``) and f32 K5 (``pool``) run the split-K CUDA-core
    body of split_kv_f32.cuh with DecodeLim, one decode row a slot:
    lengths 1000, 129, 128, 127, 1 and 0 (several splits, one split and
    two, a single position).  Each call loads only ``decode_attention``,
    looks up ``hetu_decode_f32_workspace`` and then its decode entry,
    counts one launch under the wrapper's name and zeroes the length-0
    slot; its output equals, bit for bit, f32 K8's (slot rows) or f32
    K1's (the pool) at Q 1 with q_len 1 on the same cache (DecodeLim is
    RaggedLim there, and the split order is one), and is within 1e-5 of
    the plain version."""
    run, plain, args, ragged, rargs = _f32_decode_case(
        cuda, layout, Dh, seed=17 * Dh + (layout == "pool"))
    libs, entries = _record_loads(monkeypatch)
    reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    name = run.__name__
    assert libs == ["decode_attention"]
    assert entries == ["hetu_decode_f32_workspace", f"hetu_{name}"]
    assert _nonzero_launches() == {name: 1}
    assert (got[3] == 0).all()
    assert_within(got, plain(*args), "float32")
    want = ragged(*rargs)
    torch.cuda.synchronize()
    assert torch.equal(got, want[:, 0])


def test_f32_decode_wrappers_refuse_misaligned_data(cuda, monkeypatch):
    """f32 K4 and K5 copy 16-byte chunks (the split-K body): a q, a K or
    a V cache 8 bytes off a 16-byte boundary is refused, not read; no
    library is loaded and nothing launches."""
    libs, _ = _record_loads(monkeypatch)
    reset_launches()
    for layout in ("slots", "pool"):
        run, _, args, _, _ = _f32_decode_case(cuda, layout, 64, seed=23)
        for i in range(3):
            bad = list(args)
            bad[i] = _off16(args[i], 8)
            with pytest.raises(ValueError, match="16-byte"):
                run(*bad)
    assert libs == []
    assert not any(launch_counts().values())


def _bf16_decode_case(cuda, layout, Dh, seed):
    """bf16 decode over ``_long_wave``'s slots (lengths 1000, 257, 1, 0,
    several key splits, one shared pool block) through K4 (``slots``)
    or K5 (``pool``): (the wrapper, its plain version, its name, its
    arguments, the ragged kernel of the same layout and its arguments at
    Q 1 with q_lens 1, the verify kernel's and its arguments at Q 1)."""
    q, pk, pv, lens, _, tab = _long_wave(Dh, 1, [1, 1, 1, 0], seed=seed)
    dt = torch.bfloat16
    q = q[:, 0].to(cuda, dt)
    lens_d, tab_d = (torch.from_numpy(a).to(cuda) for a in (lens, tab))
    ones = torch.ones_like(lens_d)
    if layout == "slots":
        k, v = (_slot_rows(x, tab).to(cuda, dt) for x in (pk, pv))
        return (tda.paged_decode_attention, tda.masked_decode_reference,
                "paged_decode_attention", (q, k, v, lens_d),
                tra.ragged_attention, (q[:, None], k, v, lens_d, ones),
                tda.paged_verify_attention,
                (q[:, None], k, v, lens_d, ones))
    k, v = pk.to(cuda, dt), pv.to(cuda, dt)
    return (tda.paged_block_decode_attention,
            tda.paged_block_decode_reference,
            "paged_block_decode_attention", (q, k, v, lens_d, tab_d),
            tra.ragged_paged_attention,
            (q[:, None], k, v, lens_d, ones, tab_d),
            tda.paged_block_verify_attention,
            (q[:, None], k, v, lens_d, ones, tab_d))


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_bf16_decode_kernels_cross_key_splits(cuda, monkeypatch, Dh,
                                              layout):
    """bf16 K4/K5 on the tensor-core library: lengths 1000, 257, 1 and 0
    cross several 128-position key splits, a one-position slot shares a
    pool block, the length-0 slot is zero; one launch counted under the
    wrapper's name (no regime key), and the only library loaded is
    ``decode_attention_bf16``; held to TOL + ``ragged_rounding_bound``."""
    run, plain, name, args, *_ = _bf16_decode_case(cuda, layout, Dh,
                                                   seed=5 * Dh)
    from hetu_tpu_torch.kernels import _build
    loaded = []
    library = _build.library
    monkeypatch.setattr(_build, "library",
                        lambda n: loaded.append(n) or library(n))
    reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    assert loaded == ["decode_attention_bf16"]
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == {name: 1}
    q, k, v, lens = args[:4]
    assert_ragged_close(got[:, None], plain(*args).to(q.dtype)[:, None],
                        (q[:, None], k, v, lens, torch.ones_like(lens))
                        + tuple(args[4:]), "bfloat16")
    assert (got[3] == 0).all()


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_bf16_decode_kernels_equal_the_ragged_kernels_at_q1(cuda, Dh,
                                                            layout):
    """bf16 K4 is bf16 K8's decode wave (Q 1, q_lens 1), and bf16 K5 is
    K1's: the same split-K body with the same row limits, bit for
    bit."""
    run, _, _, args, ragged, rargs, _, _ = _bf16_decode_case(
        cuda, layout, Dh, seed=7 * Dh)
    got = run(*args)
    want = ragged(*rargs)
    torch.cuda.synchronize()
    assert torch.equal(got, want[:, 0])


@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_bf16_verify_kernel_q1_equals_decode_kernel(cuda, layout):
    """A one-row bf16 verify block (K6/K7) scores what bf16 K4/K5 score:
    the same split-K body, bit for bit (the f32 pair is
    ``test_verify_kernel_q1_equals_decode_kernel``)."""
    run, _, _, args, _, _, verify, vargs = _bf16_decode_case(
        cuda, layout, 64, seed=11)
    got = verify(*vargs)
    want = run(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want)


def test_bf16_decode_wrappers_refuse_misaligned_data(cuda):
    """bf16 K4/K5 copy 16-byte chunks: a q that does not start on a
    16-byte boundary is refused, not read or copied, and nothing
    launches."""
    for layout in ("slots", "pool"):
        run, _, _, args, *_ = _bf16_decode_case(cuda, layout, 64, seed=13)
        q = args[0]
        x = torch.zeros(q.numel() + 4, device=cuda, dtype=q.dtype)
        qbad = x[4:].view(q.shape)              # 8 bytes past the start
        qbad.copy_(q)
        assert qbad.is_contiguous() and qbad.data_ptr() % 16
        reset_launches()
        with pytest.raises(ValueError, match="16-byte"):
            run(qbad, *args[1:])
        assert not any(launch_counts().values())


def flash_tol(q, k, v, dtype, causal, kv_lens=None, lse_c=None, rtol=None):
    """The flash forward (K2, K2-carry) against its plain version, as
    dict(atol, rtol) for ``assert_flash_close``.  f32 as ``TOL`` (or the
    caller's rtol).  bf16: the kernel rounds P = exp(s - m) to bf16
    against its running max m at each key tile, the plain version
    against the row's final max (the only max it has); each rounding is
    within 2^-8 of p (bf16 keeps 8 significant bits), so the two P
    differ by at most 2^-7 p and each element of o by at most 2^-7
    sum(p |v_d|) / l of its row (``bf16_rounding_bound``), plus f32's
    1e-5 for the sums and exp in another order, before its own rounding,
    which adds one bf16 ulp (rtol 2^-7; the carry's f32 output adds
    none, so its rtol stays 1e-5).  Masks show in the lse, held to
    1e-4."""
    if dtype == "float32":
        return TOL[dtype] if rtol is None else dict(atol=1e-5, rtol=rtol)
    bound = tfa.bf16_rounding_bound(q, k, v, causal=causal,
                                    kv_lens=kv_lens, lse_c=lse_c)
    return dict(atol=1e-5 + bound.cpu().numpy(),
                rtol=2.0 ** -7 if rtol is None else rtol)


def assert_flash_close(got, want, atol, rtol):
    """|got - want| <= atol + rtol * |want| element by element, atol a
    scalar or an array of want's shape."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    diff = np.abs(got - want)
    lim = atol + rtol * np.abs(want)
    bad = ~(diff <= lim)
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} elements off; largest error / "
        f"bound {float((diff / lim).max())}, max abs error "
        f"{float(diff.max())}")


# (causal, S, Sk): one row, the 64-row tile's edges, a ragged last tile,
# the training length, Sk > S without the causal mask
FLASH_CASES = [(True, 1, 1), (True, 63, 63), (True, 64, 64), (True, 65, 65),
               (True, 100, 100), (True, 1024, 1024), (False, 40, 72),
               (False, 65, 200), (False, 1, 130)]


def _lens(Sk, cuda):
    """kv_lens of the four sequences: partial, 0, 1, full."""
    return torch.tensor([max(Sk // 2, 1), 0, 1, Sk], dtype=torch.int32,
                        device=cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", FLASH_CASES)
@pytest.mark.parametrize("with_lens", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, D, causal, S, Sk,
                                    with_lens):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(D + S)
    q = torch.randn((4, S, 4, D), generator=g).to(cuda, dt)
    k, v = (torch.randn((4, Sk, 4, D), generator=g).to(cuda, dt)
            for _ in range(2))
    lens = _lens(Sk, cuda) if with_lens else None
    reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, causal=causal, kv_lens=lens)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    assert sum(launch_counts().values()) == 1
    assert o.dtype == dt
    o_r, lse_r = tfa.flash_fwd_reference(q, k, v, causal=causal,
                                         kv_lens=lens)
    assert_flash_close(o, o_r, **flash_tol(q, k, v, dtype, causal,
                                           kv_lens=lens))
    live = lse_r < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    assert torch.equal(lse[~live], lse_r[~live])
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_r[live].cpu().numpy(), atol=1e-4)
    if with_lens:
        assert (o[1] == 0).all()


# K2-carry against its plain version: the output is f32 for both input
# dtypes and both sides accumulate in f32; f32 is held to 1e-5 + 1e-5
# rel, bf16 to flash_tol's 1e-5 plus the bound of the rounding of P of
# its rounded terms (the carry's f32 term is not rounded) with rtol
# 1e-5; lse as K2's.
CARRY_TOL = dict(atol=1e-5, rtol=1e-5)
CARRY_CASES = [(True, 1, 1), (True, 64, 64), (True, 65, 65),
               (True, 100, 100), (True, 1024, 1024), (False, 40, 72),
               (False, 63, 130)]


def _carry_case(B, S, Sk, Hn, D, kind, dt, cuda, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, Hn, D), generator=g).to(cuda, dt)
    k, v = (torch.randn((B, Sk, Hn, D), generator=g).to(cuda, dt)
            for _ in range(2))
    o_c = torch.randn((B, S, Hn, D), generator=g).to(cuda)
    lse_c = (2.0 * torch.randn((B, Hn, S), generator=g) + 3.0).to(cuda)
    if kind == "empty":
        o_c.zero_()
        lse_c.fill_(tfa.NEG_INF)
    elif kind == "mixed":
        lse_c[..., ::3] = tfa.NEG_INF
    return q, k, v, o_c, lse_c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", CARRY_CASES)
@pytest.mark.parametrize("kind", ["empty", "live", "mixed"])
def test_flash_carry_kernel_matches_plain(cuda, dtype, D, causal, S, Sk,
                                          kind):
    """K2-carry over an empty, a live and a row-by-row mixed carry, causal
    and not, S at and off the tiles' edges."""
    dt = getattr(torch, dtype)
    args = _carry_case(3, S, Sk, 4, D, kind, dt, cuda, D + S)
    reset_launches()
    o, lse = tfa.flash_fwd_carry(*args, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_carry"] == 1
    assert launch_counts()["flash_attention"] == 0
    assert o.dtype == torch.float32
    o_r, lse_r = tfa.flash_fwd_carry_reference(*args, causal=causal)
    q, k, v, _, lse_c = args
    assert_flash_close(o, o_r, **flash_tol(q, k, v, dtype, causal,
                                           lse_c=lse_c,
                                           rtol=CARRY_TOL["rtol"]))
    live = lse_r < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_r[live].cpu().numpy(), atol=1e-4)


# (causal, S, Sk) for bf16 K2's TMA ring: 128-row q tiles and key tiles
# of 64 (128 at D 32) off their edges, the ring of stages wrapping many
# times (Sk 1000), a q tile shorter than a key tile
BF16_RING_CASES = [(True, 333, 333), (False, 200, 1000), (False, 129, 65)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", BF16_RING_CASES)
@pytest.mark.parametrize("carry", [False, True])
def test_bf16_flash_kernels_through_the_tma_ring(cuda, D, causal, S, Sk,
                                                 carry):
    """bf16 K2 (kv_lens partial, 0, 1 and full) and K2-carry (a mixed
    carry) on 4 sequences x 40 heads: 480 to 1280 blocks, several waves
    of the card's SMs, each loading through TMA into its ring of stages
    and freeing them by mbarrier; held to ``flash_tol`` as
    ``test_flash_kernel_matches_plain``, the lse within 1e-4 and +1e30
    exactly where no key is live."""
    dt = torch.bfloat16
    if carry:
        q, k, v, o_c, lse_c = _carry_case(4, S, Sk, 40, D, "mixed", dt,
                                          cuda, D + Sk)
        args, lens = (q, k, v, o_c, lse_c), None
        o, lse = tfa.flash_fwd_carry(*args, causal=causal)
        o_r, lse_r = tfa.flash_fwd_carry_reference(*args, causal=causal)
        tol = flash_tol(q, k, v, "bfloat16", causal, lse_c=lse_c,
                        rtol=CARRY_TOL["rtol"])
    else:
        g = torch.Generator().manual_seed(D + Sk)
        q = torch.randn((4, S, 40, D), generator=g).to(cuda, dt)
        k, v = (torch.randn((4, Sk, 40, D), generator=g).to(cuda, dt)
                for _ in range(2))
        lens = _lens(Sk, cuda)
        o, lse = tfa.flash_fwd(q, k, v, causal=causal, kv_lens=lens)
        o_r, lse_r = tfa.flash_fwd_reference(q, k, v, causal=causal,
                                             kv_lens=lens)
        tol = flash_tol(q, k, v, "bfloat16", causal, kv_lens=lens)
    torch.cuda.synchronize()
    assert_flash_close(o, o_r, **tol)
    live = lse_r < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_r[live].cpu().numpy(), atol=1e-4)
    if lens is not None:
        assert (o[1] == 0).all()


# (causal, S, Sk) for the f32 forward's tiles: 64-row q tiles, key tiles
# of 64 (32 at D 128), each crossed just past and just short of an edge
F32_TILE_CASES = [(True, 127, 127), (True, 129, 129), (False, 96, 161),
                  (False, 200, 33), (False, 31, 95)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", F32_TILE_CASES)
@pytest.mark.parametrize("with_lens", [True, False])
def test_f32_flash_kernel_on_the_tensor_cores(cuda, monkeypatch, D, causal,
                                              S, Sk, with_lens):
    """f32 K2 on the tensor cores (three TF32 passes, csrc/flash_fwd.cu)
    at q and key tile edges, kv_lens partial, 0, 1 and full: o within
    f32's 1e-5, lse within 1e-4 (+1e30 exactly where no key is live),
    the kv_lens-0 sequence zero, one launch from the f32 library."""
    from hetu_tpu_torch.kernels import _build
    loaded = []
    library = _build.library
    monkeypatch.setattr(_build, "library",
                        lambda n: loaded.append(n) or library(n))
    g = torch.Generator().manual_seed(3 * D + S + Sk)
    q = torch.randn((4, S, 3, D), generator=g).to(cuda)
    k, v = (torch.randn((4, Sk, 3, D), generator=g).to(cuda)
            for _ in range(2))
    lens = _lens(Sk, cuda) if with_lens else None
    reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, causal=causal, kv_lens=lens)
    torch.cuda.synchronize()
    assert loaded == ["flash_fwd"]
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == \
        {"flash_attention": 1}
    o_r, lse_r = tfa.flash_fwd_reference(q, k, v, causal=causal,
                                         kv_lens=lens)
    assert_flash_close(o, o_r, **TOL["float32"])
    live = lse_r < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_r[live].cpu().numpy(), atol=1e-4)
    if with_lens:
        assert (o[1] == 0).all()


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk", F32_TILE_CASES)
@pytest.mark.parametrize("kind", ["live", "mixed"])
def test_f32_flash_carry_kernel_on_the_tensor_cores(cuda, D, causal, S, Sk,
                                                    kind):
    """f32 K2-carry on the same tiles' edges, a live and a mixed carry:
    o within 1e-5 + 1e-5 rel, lse within 1e-4."""
    args = _carry_case(2, S, Sk, 3, D, kind, torch.float32, cuda,
                       5 * D + S + Sk)
    reset_launches()
    o, lse = tfa.flash_fwd_carry(*args, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_carry"] == 1
    o_r, lse_r = tfa.flash_fwd_carry_reference(*args, causal=causal)
    assert_flash_close(o, o_r, **CARRY_TOL)
    live = lse_r < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               lse_r[live].cpu().numpy(), atol=1e-4)


def test_f32_flash_wrappers_refuse_misaligned_data(cuda):
    """The f32 forward and backward copy 16-byte chunks too: data that
    does not start on a 16-byte boundary is refused, not read, and
    nothing launches."""
    x = torch.randn((1, 8 * 64 + 2), device=cuda)
    bad = x[:, 2:].reshape(1, 8, 1, 64)          # 8 bytes past the start
    assert bad.is_contiguous() and bad.data_ptr() % 16
    y = torch.randn((1, 8, 1, 64), device=cuda)
    reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_fwd(bad, y, y, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_fwd_carry(y, y, y, bad,
                            torch.full((1, 1, 8), tfa.NEG_INF, device=cuda))
    stat = torch.zeros((1, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_bwd_dkv(y, bad, y, None, stat, stat, y, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_bwd_dq(y, y, y, None, stat, stat, bad, causal=True)
    assert not any(launch_counts().values())


def test_flash_carry_autograd_on_the_card(cuda):
    """Autograd through flash_attention_with_carry (K2-carry forward, K3
    backward and the carry's terms) against autograd through the plain
    forward, f32, in all five tensors."""
    args = _carry_case(2, 130, 130, 3, 64, "mixed", torch.float32, cuda, 5)
    g = torch.Generator().manual_seed(6)
    go = torch.randn((2, 130, 3, 64), generator=g).to(cuda)
    gl = torch.randn((2, 3, 130), generator=g).to(cuda)
    xs = [t.clone().requires_grad_() for t in args]
    reset_launches()
    o, lse = tfa.flash_attention_with_carry(*xs, causal=True)
    got = torch.autograd.grad((o * go).sum() + (lse * gl).sum(), xs)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_attention_carry"], counts["flash_attention_bwd_dkv"],
            counts["flash_attention_bwd_dq"]) == (1, 1, 1)
    ys = [t.clone().requires_grad_() for t in args]
    o_r, lse_r = tfa.flash_fwd_carry_reference(*ys, causal=True)
    lse_r = torch.where(lse_r >= 5e29, tfa.NEG_INF, lse_r)
    want = torch.autograd.grad((o_r * go).sum() + (lse_r * gl).sum(), ys)
    for a, b in zip(got, want):
        k3_close(a, b, "float32")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_on_the_card_equals_whole_sequence_flash(cuda, causal):
    """The cp-4 ring on a virtual mesh of the card: equal to K2 over the
    whole sequence, with cp + cp(cp-1)/2 carried launches causal (the
    rotations above the diagonal launch nothing) and cp^2 otherwise."""
    from hetu_tpu_torch.parallel import make_mesh, ring_attention
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((2, 256, 4, 64), generator=g).to(cuda)
               for _ in range(3))
    mesh = make_mesh({"cp": 4})
    reset_launches()
    got = ring_attention(q, k, v, mesh=mesh, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_carry"] == (10 if causal else 16)
    want = tfa.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=2e-4)


def k3_close(got, want, dtype):
    """K3 against its plain version, element by element.  f32: atol 1e-4
    + rtol 1e-4, since the sums over up to S rows run in another order.
    bf16: both sides round P and dS to bf16 before the sums; a pre-
    rounding value one f32 ulp apart may round to the neighbouring bf16
    value, moving a sum by one bf16 ulp of one term, so atol is one bf16
    ulp (2^-7) of the tensor's largest |want| and rtol one ulp; plus 2^-16
    absolute, the f32 noise of dS = P (dP - delta) where dP and delta
    (each ~|dO| |v|) cancel exactly, as they do when every live row has
    one key (dQ and dK are then 0 up to that noise on both sides)."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(
            got, want, rtol=2.0 ** -7,
            atol=2.0 ** -7 * np.abs(want).max() + 2.0 ** -16)


K3_CASES = [(True, 100, 100, True), (False, 100, 100, True),
            (False, 40, 72, True), (True, 40, 72, False),
            (True, 128, 128, False), (True, 1, 1, True),
            (True, 63, 63, False), (True, 64, 64, True),
            (False, 65, 65, True), (True, 1024, 1024, False),
            (False, 65, 200, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,S,Sk,with_lens", K3_CASES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, D, causal, S, Sk,
                                       with_lens):
    """K3's dK/dV and dQ kernels on causal and full attention, kv_lens
    partial, 0, 1 and full, Sk > S, S at and off the 64-row tile's
    edges."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(D + S)
    q, do = (torch.randn((4, S, 4, D), generator=g).to(cuda, dt)
             for _ in range(2))
    k, v = (torch.randn((4, Sk, 4, D), generator=g).to(cuda, dt)
            for _ in range(2))
    lens = _lens(Sk, cuda) if with_lens else None
    o, lse = tfa.flash_fwd_reference(q, k, v, causal=causal, kv_lens=lens)
    delta = tfa.bwd_delta(o, do)
    reset_launches()
    dk, dv = tfa.flash_bwd_dkv(q, k, v, lens, lse, delta, do, causal=causal)
    dq = tfa.flash_bwd_dq(q, k, v, lens, lse, delta, do, causal=causal)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    want_k, want_v = tfa.flash_bwd_dkv_reference(q, k, v, lens, lse, delta,
                                                 do, causal=causal)
    want_q = tfa.flash_bwd_dq_reference(q, k, v, lens, lse, delta, do,
                                        causal=causal)
    for got, want in ((dq, want_q), (dk, want_k), (dv, want_v)):
        assert got.dtype == dt
        k3_close(got, want, dtype)
    if with_lens:
        assert (dq[1] == 0).all() and (dk[1] == 0).all() \
            and (dv[1] == 0).all()
        assert (dk[2, 1:] == 0).all() and (dv[2, 1:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_autograd_on_the_card(cuda, dtype):
    """Autograd through flash_attention (K2 forward, K3 backward) against
    autograd through the plain forward, on the card."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(9)
    q, k, v, do = (torch.randn((2, 130, 3, 64), generator=g).to(cuda, dt)
                   for _ in range(4))
    lens = torch.tensor([130, 77], dtype=torch.int32, device=cuda)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launches()
    o = tfa.flash_attention(*xs, causal=True, kv_lens=lens)
    got = torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd_dkv"],
            counts["flash_attention_bwd_dq"]) == (1, 1, 1)
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    o_r, lse_r = tfa.flash_fwd_reference(*ys, causal=True, kv_lens=lens)
    want = tfa.flash_bwd_reference(*(y.detach() for y in ys), lens,
                                   o_r.detach(), lse_r.detach(), do,
                                   causal=True)
    for a, b in zip(got, want):
        k3_close(a, b, dtype)
    if dtype == "float32":
        auto = torch.autograd.grad(o_r, ys, do)
        for a, b in zip(got, auto):
            k3_close(a, b, dtype)
    with torch.no_grad():
        reset_launches()
        tfa.flash_attention(q, k, v, causal=True)
        assert launch_counts()["flash_attention_bwd_dq"] == 0


# BERT-base's attention shape and padded lengths: none a multiple of a
# tile but the full one, down to a single live key (CLS alone)
BERT_SHAPE = (8, 512, 12, 64)
BERT_LENS = (512, 384, 257, 130, 64, 17, 2, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bert_shape_kv_lens_matches_plain(cuda, dtype):
    """K2 and K3's two kernels at BERT-base's [8, 512, 12, 64], non-causal,
    with a kv_lens padding mask, called as the graph calls them
    (``FlashAttention`` then ``torch.autograd.grad``): o against the plain
    forward within flash_tol, the lse of every row within 1e-4 (rows past
    kv_lens attend to the live keys too), dq, dk and dv against the plain
    backward from the kernel's own (lse, delta) within k3_close; keys
    past kv_lens get zero dk and dv."""
    dt = getattr(torch, dtype)
    B, S, H, D = BERT_SHAPE
    g = torch.Generator().manual_seed(23)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g).to(cuda, dt)
                   for _ in range(4))
    lens = torch.tensor(BERT_LENS, dtype=torch.int32, device=cuda)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launches()
    o, lse = tfa.FlashAttention.apply(*xs, lens, False)
    dq, dk, dv = torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd_dkv"],
            counts["flash_attention_bwd_dq"]) == (1, 1, 1)
    o, lse = o.detach(), lse.detach()
    o_r, lse_r = tfa.flash_fwd_reference(q, k, v, causal=False,
                                         kv_lens=lens)
    assert_flash_close(o, o_r, **flash_tol(q, k, v, dtype, False,
                                           kv_lens=lens))
    assert float((lse - lse_r).abs().max()) <= 1e-4
    args = (q, k, v, lens, lse, tfa.bwd_delta(o, do), do)
    want_k, want_v = tfa.flash_bwd_dkv_reference(*args, causal=False)
    want_q = tfa.flash_bwd_dq_reference(*args, causal=False)
    for got, want in ((dq, want_q), (dk, want_k), (dv, want_v)):
        assert got.dtype == dt
        k3_close(got, want, dtype)
    for b, n in enumerate(BERT_LENS):
        assert (dk[b, n:] == 0).all() and (dv[b, n:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_are_deterministic(cuda, dtype):
    """Two launches of each flash kernel on the same inputs give the same
    bits (no atomics, every sum in one fixed order), one launch each."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn((2, 300, 4, 64), generator=g).to(cuda, dt)
                   for _ in range(4))
    lens = torch.tensor([300, 171], dtype=torch.int32, device=cuda)
    o_c, lse_c = _carry_case(2, 300, 300, 4, 64, "mixed", dt, cuda, 12)[3:]
    outs = []
    for _ in range(2):
        reset_launches()
        o, lse = tfa.flash_fwd(q, k, v, causal=True, kv_lens=lens)
        oc, lc = tfa.flash_fwd_carry(q, k, v, o_c, lse_c, causal=True)
        delta = tfa.bwd_delta(o, do)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, lens, lse, delta, do,
                                   causal=True)
        dq = tfa.flash_bwd_dq(q, k, v, lens, lse, delta, do, causal=True)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert {n: c for n, c in counts.items() if c} == {
            "flash_attention": 1, "flash_attention_carry": 1,
            "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
        outs.append((o, lse, oc, lc, dk, dv, dq))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bf16_flash_wrappers_refuse_misaligned_data(cuda):
    """The bf16 flash kernels copy 16-byte chunks: data that does not
    start on a 16-byte boundary is refused, not read."""
    x = torch.randn((1, 8 * 64 + 4), device=cuda).bfloat16()
    bad = x[:, 4:].reshape(1, 8, 1, 64)          # 8 bytes past the start
    assert bad.is_contiguous() and bad.data_ptr() % 16
    y = torch.randn((1, 8, 1, 64), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_fwd(bad, y, y, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_fwd_carry(y, bad, y,
                            torch.zeros_like(y, dtype=torch.float32),
                            torch.full((1, 1, 8), tfa.NEG_INF, device=cuda))
    stat = torch.zeros((1, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_bwd_dq(y, y, y, None, stat, stat, bad)


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
    y = torch.randn((1, 8, 2, 64), device=cuda)
    stat = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_bwd_dq(y, y, y, None, stat.double(), stat, y)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_bwd_dkv(y, y, y, None, stat, stat, y.transpose(1, 2)
                          .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        tda.paged_decode_attention(x[:, 0], x, x, args[3][:1])
    o_c = torch.zeros_like(y)
    with pytest.raises(TypeError, match="kv_lens"):
        tfa.flash_fwd_carry(y, y, y, o_c, stat, kv_lens=args[3][:1])
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd_carry(y, y, y, o_c.transpose(1, 2).contiguous()
                            .transpose(1, 2), stat)
    rows = torch.randn((6, 32, 6, 64), device=cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tra.ragged_attention(args[0], rows, rows, args[3], args[4])


# ------------------------------------------------------------------- #
# the int8 twins
# ------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_encode_on_the_card_equals_the_cpu(cuda, dtype):
    """The card's encoding of a cache is the CPU's (and so JAX's), payload
    and scales, bit for bit: all-zero rows, and rows over nine decades of
    magnitude."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 96, 12, 64), generator=g) \
        * 10.0 ** torch.randint(-6, 4, (4, 96, 12, 1), generator=g)
    x[1, 5] = 0.0
    x = x.to(getattr(torch, dtype))
    q, s = kv_encode(x.to(cuda))
    qc, sc = kv_encode(x)
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)


def _int8(x, cuda):
    """``kv_encode`` of a float cache, (payload, scales) on the card."""
    q, s = kv_encode(x)
    return q.to(cuda), s.to(cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,bs,Q", [(64, 16, 64), (32, 8, 1),
                                     (128, 16, 40)])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_ragged_int8_kernels_match_plain(cuda, dtype, Dh, bs, Q, layout):
    """K8-int8 over slot rows and K1-int8 through the block tables, q f32
    or bf16, on the mixed wave with a length-0 slot."""
    q, pk, pv, lens, ql, tab = _wave(Dh, bs, Q, seed=6)
    q = q.to(cuda, getattr(torch, dtype))
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    reset_launches()
    if layout == "slots":
        (k, ks), (v, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
        sc = dict(k_scale=ks, v_scale=vs)
        got = tra.ragged_attention(q, k, v, lens_d, ql_d, **sc)
        want = tra.ragged_masked_reference(q, k, v, lens_d, ql_d, ks, vs)
        name = "ragged_attention_int8"
    else:
        (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
        sc = dict(k_scale=ks, v_scale=vs)
        got = tra.ragged_paged_attention(q, k, v, lens_d, ql_d, tab_d, **sc)
        want = tra.ragged_paged_reference(q, k, v, lens_d, ql_d, tab_d, ks,
                                          vs)
        name = "ragged_paged_attention_int8"
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    assert launch_counts()[name[:-5]] == 0
    assert got.dtype == q.dtype
    # bf16 q: the tensor cores split p times the V scale (module doc)
    assert_within(got, want.to(q.dtype), dtype)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 5, 8, 16])
def test_bf16_ragged_int8_narrow_waves(cuda, Dh, Q):
    """K1-int8 and K8-int8 for bf16 q on decode and verify waves (Q <=
    16: split-K on the tensor cores over the widened payload, then the
    merge), the waves of ``test_bf16_ragged_narrow_waves`` over the
    caches' int8 encoding: within TOL alone (P not rounded), one counted
    launch of the int8 twin in the narrow regime and none of its float
    twin, the length-0 slot zero."""
    wave = _long_wave(Dh, Q, [Q, max(Q - 2, 1), 1, 0], seed=Q + Dh + 1)
    for got, want, _, _, name, counts in _bf16_both_layouts(
            cuda, *wave, int8=True):
        assert counts[name] == counts[f"{name}:narrow"] == 1
        assert counts[f"{name}:wide"] == counts[name[:-5]] == 0
        assert_within(got, want, "bfloat16")
        assert (got[3] == 0).all()


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [17, 64, 256])
def test_bf16_ragged_int8_wide_waves(cuda, Dh, Q):
    """K1-int8 and K8-int8 for bf16 q on prompt-chunk waves (Q > 16: the
    wgmma body over the widened payload), the waves of
    ``test_bf16_ragged_wide_waves`` over the caches' int8 encoding:
    within TOL alone (P not rounded), one counted launch of the int8
    twin in the wide regime and none of its float twin, the length-0
    slot zero."""
    wave = _long_wave(Dh, Q, [Q, Q // 2, 0, 0], seed=2 * Q + Dh + 1)
    for got, want, _, _, name, counts in _bf16_both_layouts(
            cuda, *wave, int8=True):
        assert counts[name] == counts[f"{name}:wide"] == 1
        assert counts[f"{name}:narrow"] == counts[name[:-5]] == 0
        assert_within(got, want, "bfloat16")
        assert (got[3] == 0).all()


def _off16(t, nbytes):
    """A copy of ``t`` whose data starts ``nbytes`` past a 16-byte
    boundary (contiguous)."""
    n = nbytes // t.element_size()
    out = torch.zeros(t.numel() + n, device=t.device,
                      dtype=t.dtype)[n:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == nbytes
    return out


def test_bf16_ragged_int8_wrappers_refuse_misaligned_data(cuda):
    """bf16 q's int8 twins of K1/K8 copy 16-byte chunks of the payload: a
    payload 8 bytes off a 16-byte boundary is refused, not read, and so
    is a scale plane 4 bytes off; so does f32 q's twin past 16 rows
    (ragged_tf32.cuh, 16-byte chunks too)."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 8)
    (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    qb = q.to(cuda, torch.bfloat16)
    bad = _off16(k, 8)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(qb, bad, v, lens_d, ql_d, tab_d,
                                   k_scale=ks, v_scale=vs)
    rows = [_slot_rows(x.cpu(), tab).to(cuda) for x in (k, v, ks, vs)]
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_attention(qb, rows[0], rows[1], lens_d, ql_d,
                             k_scale=rows[2], v_scale=_off16(rows[3], 4))
    reset_launches()
    q17 = _wave(64, 16, 17)[0].to(cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tra.ragged_paged_attention(q17, bad, v, lens_d, ql_d, tab_d,
                                   k_scale=ks, v_scale=vs)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,bs,Q", [(64, 16, 1), (32, 8, 1), (128, 16, 1),
                                     (64, 16, 5), (32, 8, 2), (128, 16, 16),
                                     (64, 8, 3)])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_decode_verify_int8_kernels_match_plain(cuda, dtype, Dh, bs, Q,
                                                layout):
    """K4-int8/K5-int8 (Q 1, decode) and K6-int8/K7-int8 (Q 2-16) over
    slot rows and through the block tables, q f32 or bf16, with a
    q_len-0 slot, a length-0 slot and dead verify rows."""
    q, pk, pv, lens, _, tab = _wave(Dh, bs, Q, seed=7)
    ql = np.minimum(np.array([Q, Q - 1, 1, 0, Q, 0], np.int32), lens)
    q = q.to(cuda, getattr(torch, dtype))
    lens_d, ql_d, tab_d = (torch.from_numpy(a).to(cuda)
                           for a in (lens, ql, tab))
    if layout == "slots":
        (k, ks), (v, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
        ops = ((tda.paged_decode_attention, tda.masked_decode_reference)
               if Q == 1 else
               (tda.paged_verify_attention, tda.masked_verify_reference))
        args = (k, v, lens_d) if Q == 1 else (k, v, lens_d, ql_d)
    else:
        (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
        ops = ((tda.paged_block_decode_attention,
                tda.paged_block_decode_reference) if Q == 1 else
               (tda.paged_block_verify_attention,
                tda.paged_block_verify_reference))
        args = (k, v, lens_d, tab_d) if Q == 1 else (k, v, lens_d, ql_d,
                                                     tab_d)
    qq = q[:, 0] if Q == 1 else q
    reset_launches()
    got = ops[0](qq, *args, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    name = ops[0].__name__
    assert launch_counts()[f"{name}_int8"] == 1
    assert launch_counts()[name] == 0
    want = ops[1](qq, *args, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.to(q.dtype).float().cpu().numpy(),
                               **TOL[dtype])
    assert (got[3] == 0).all()


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 2, 5, 8, 16, 17])
def test_bf16_verify_int8_kernel_on_the_tensor_cores(cuda, monkeypatch, Dh,
                                                     Q):
    """K7-int8 for bf16 q (csrc/decode_attention_bf16.cu, the split-K
    body of K1-int8, P times the V scale split into a bf16 pair): over
    the int8 encoding of a pool whose slots cross several 128-position
    key splits, a q-block of Q rows, a shorter one (dead rows), a
    one-row slot sharing a pool block and a length-0 slot, within TOL
    alone; one launch per 16-row group under ``_int8``, the library
    loaded only ``decode_attention_bf16``, the length-0 slot zero."""
    q, pk, pv, lens, ql, tab = _long_wave(
        Dh, Q, [Q, max(Q - 2, 1), 1, 0], seed=5 * Q + Dh)
    (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
    args = [q.to(cuda, torch.bfloat16), k, v] + [
        torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    sc = dict(k_scale=ks, v_scale=vs)
    from hetu_tpu_torch.kernels import _build
    loaded = []
    library = _build.library
    monkeypatch.setattr(_build, "library",
                        lambda n: loaded.append(n) or library(n))
    reset_launches()
    got = tda.paged_block_verify_attention(*args, **sc)
    torch.cuda.synchronize()
    assert set(loaded) == {"decode_attention_bf16"}
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == \
        {"paged_block_verify_attention_int8": -(-Q // 16)}
    want = tda.paged_block_verify_reference(*args, ks, vs)
    if Q <= 16:
        assert_within(got, want.to(torch.bfloat16), "bfloat16")
    else:
        # past 16 rows: every live row as the whole block, every row as
        # its group
        for b, n in enumerate(ql):
            assert_within(got[b, :n], want[b, :n].to(torch.bfloat16),
                          "bfloat16")
        want = torch.cat([tda.paged_block_verify_reference(
            qc, k, v, lc, nc, args[5], ks, vs) for qc, lc, nc in
            tda.verify_groups(args[0], args[3], args[4])], dim=1)
        assert_within(got, want.to(torch.bfloat16), "bfloat16")
    assert (got[3] == 0).all()


def test_bf16_verify_int8_wrapper_refuses_misaligned_data(cuda):
    """K7-int8 copies 16-byte chunks of the payload in either q dtype:
    for bf16 q a payload 8 bytes off a 16-byte boundary, or a scale
    plane 4 bytes off, is refused, not read; so is the payload for f32 q
    (the split-K CUDA-core body), and nothing launches."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 5)
    ql = np.minimum(np.array([5, 4, 1, 0, 5, 0], np.int32), lens)
    (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql, tab)]
    qb = q.to(cuda, torch.bfloat16)
    reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_block_verify_attention(qb, _off16(k, 8), v, *idx,
                                         k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_block_verify_attention(qb, k, v, *idx, k_scale=ks,
                                         v_scale=_off16(vs, 4))
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_block_verify_attention(q.to(cuda), _off16(k, 8), v, *idx,
                                         k_scale=ks, v_scale=vs)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("Q", [1, 2, 5, 8, 16, 17])
def test_bf16_slot_verify_int8_kernel_on_the_tensor_cores(cuda, monkeypatch,
                                                          Dh, Q):
    """K6-int8 for bf16 q (csrc/decode_attention_bf16.cu, the split-K
    body of K8-int8 with the verify rows' limits): over the int8 encoding
    of slot rows crossing several 128-position key splits, a q-block of
    Q rows, a shorter one (dead rows), a one-row slot and a length-0
    slot, within TOL alone; one launch per 16-row group under
    ``_int8``, the library loaded only ``decode_attention_bf16``, the
    length-0 slot zero; at Q <= 16 equal to bf16-q K8-int8 on the same
    wave bit for bit."""
    q, pk, pv, lens, ql, tab = _long_wave(
        Dh, Q, [Q, max(Q - 2, 1), 1, 0], seed=11 * Q + Dh)
    (k, ks), (v, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
    args = [q.to(cuda, torch.bfloat16), k, v] + [
        torch.from_numpy(a).to(cuda) for a in (lens, ql)]
    sc = dict(k_scale=ks, v_scale=vs)
    from hetu_tpu_torch.kernels import _build
    loaded = []
    library = _build.library
    monkeypatch.setattr(_build, "library",
                        lambda n: loaded.append(n) or library(n))
    reset_launches()
    got = tda.paged_verify_attention(*args, **sc)
    torch.cuda.synchronize()
    assert set(loaded) == {"decode_attention_bf16"}
    assert _nonzero_launches() == {"paged_verify_attention_int8":
                                   -(-Q // 16)}
    want = tda.masked_verify_reference(*args, ks, vs)
    if Q <= 16:
        assert_within(got, want.to(torch.bfloat16), "bfloat16")
        assert torch.equal(got, tra.ragged_attention(*args, **sc))
    else:
        # past 16 rows: every live row as the whole block, every row as
        # its group
        for b, n in enumerate(ql):
            assert_within(got[b, :n], want[b, :n].to(torch.bfloat16),
                          "bfloat16")
        want = torch.cat([tda.masked_verify_reference(
            qc, k, v, lc, nc, ks, vs) for qc, lc, nc in
            tda.verify_groups(args[0], args[3], args[4])], dim=1)
        assert_within(got, want.to(torch.bfloat16), "bfloat16")
    assert (got[3] == 0).all()


def test_bf16_slot_verify_int8_wrapper_refuses_misaligned_data(
        cuda, monkeypatch):
    """K6-int8 copies 16-byte chunks of the payload in either q dtype: a
    payload 8 bytes off a 16-byte boundary, or a scale plane 4 bytes off,
    is refused, not read, and nothing launches; for f32 q (the split-K
    CUDA-core body of decode_attention_int8.cu) no library is even
    loaded."""
    q, pk, pv, lens, ql, tab = _wave(64, 16, 5)
    ql = np.minimum(np.array([5, 4, 1, 0, 5, 0], np.int32), lens)
    (k, ks), (v, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
    idx = [torch.from_numpy(a).to(cuda) for a in (lens, ql)]
    qb = q.to(cuda, torch.bfloat16)
    reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(qb, _off16(k, 8), v, *idx, k_scale=ks,
                                   v_scale=vs)
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(qb, k, v, *idx, k_scale=ks,
                                   v_scale=_off16(vs, 4))
    assert not any(launch_counts().values())
    from hetu_tpu_torch.kernels import _build
    loaded = []
    library = _build.library
    monkeypatch.setattr(_build, "library",
                        lambda n: loaded.append(n) or library(n))
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(q.to(cuda), _off16(k, 8), v, *idx,
                                   k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="16-byte"):
        tda.paged_verify_attention(q.to(cuda), k, v, *idx, k_scale=ks,
                                   v_scale=_off16(vs, 4))
    assert loaded == []
    assert not any(launch_counts().values())


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pk, pv, lens, ql, tab = _wave(64, 16, 8)
    (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
    args = [q.to(cuda), k, v] + [torch.from_numpy(a).to(cuda)
                                 for a in (lens, ql, tab)]
    with pytest.raises(ValueError, match="contiguous"):
        tra.ragged_paged_attention(*args, k_scale=ks.transpose(0, 1)
                                   .contiguous().transpose(0, 1),
                                   v_scale=vs)
    with pytest.raises(ValueError, match="4-byte"):
        off = torch.zeros(k.numel() + 1, dtype=torch.int8,
                          device=cuda)[1:].view(k.shape)
        tra.ragged_paged_attention(args[0], off, v, *args[3:], k_scale=ks,
                                   v_scale=vs)
    with pytest.raises(ValueError, match="int8 cache"):
        tra.ragged_paged_attention(args[0], args[1].float(), v, *args[3:],
                                   k_scale=ks, v_scale=vs)


def _int8_decode_case(cuda, layout, Dh, dtype, seed):
    """K4-int8 (``slots``) or K5-int8 (``pool``) over the int8 encoding
    of ``_long_wave``'s slots (lengths 1000, 257, 1, 0: several key
    splits, a shared pool block, a length-0 slot), q of ``dtype``: (the
    wrapper, its plain version, its arguments, its scale keywords, the
    ragged kernel of the same layout and its arguments at Q 1, q_lens
    1 on every slot)."""
    q, pk, pv, lens, _, tab = _long_wave(Dh, 1, [1, 1, 1, 0], seed=seed)
    q = q.to(cuda, getattr(torch, dtype))
    lens_d, tab_d = (torch.from_numpy(a).to(cuda) for a in (lens, tab))
    ones = torch.ones_like(lens_d)
    if layout == "slots":
        (k, ks), (v, vs) = (_int8(_slot_rows(x, tab), cuda) for x in (pk, pv))
        return (tda.paged_decode_attention, tda.masked_decode_reference,
                (q[:, 0], k, v, lens_d), dict(k_scale=ks, v_scale=vs),
                tra.ragged_attention, (q, k, v, lens_d, ones))
    (k, ks), (v, vs) = (_int8(x, cuda) for x in (pk, pv))
    return (tda.paged_block_decode_attention,
            tda.paged_block_decode_reference,
            (q[:, 0], k, v, lens_d, tab_d), dict(k_scale=ks, v_scale=vs),
            tra.ragged_paged_attention, (q, k, v, lens_d, ones, tab_d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("layout", ["slots", "pool"])
def test_int8_decode_kernels_on_the_split_bodies(cuda, monkeypatch, dtype,
                                                 Dh, layout):
    """K4-int8 (``slots``) and K5-int8 (``pool``) run the split-K bodies
    of the ragged int8 twins, one decode row a slot: bf16 q the tensor
    cores (``decode_attention_bf16``'s ``_int8_bf16`` entries, within TOL
    alone: P is not rounded), f32 q the CUDA cores (split_kv_f32.cuh in
    ``decode_attention_int8``, within 1e-5).  Each call loads only that
    library, looks up its workspace entry and its decode entry, counts
    one launch under ``_int8``, and zeroes the length-0 slot; its output
    equals, bit for bit, K8-int8's (slot rows) or K1-int8's (the pool)
    on the same cache at Q 1 with q_len 1: the same body, row limits and
    split order."""
    run, plain, args, sc, ragged, rargs = _int8_decode_case(
        cuda, layout, Dh, dtype, seed=3 * Dh + (layout == "pool"))
    libs, entries = _record_loads(monkeypatch)
    reset_launches()
    got = run(*args, **sc)
    torch.cuda.synchronize()
    name = run.__name__
    entry = f"hetu_{name}_int8"
    if dtype == "bfloat16":
        assert libs == ["decode_attention_bf16"]
        assert entries == ["hetu_verify_bf16_workspace", f"{entry}_bf16"]
    else:
        assert libs == ["decode_attention_int8"]
        assert entries == ["hetu_decode_f32_workspace", entry]
    assert _nonzero_launches() == {f"{name}_int8": 1}
    assert_within(got, plain(*args, *sc.values()).to(got.dtype), dtype)
    assert (got[3] == 0).all()
    want = ragged(*rargs, **sc)
    torch.cuda.synchronize()
    assert torch.equal(got, want[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_wrappers_refuse_misaligned_data(cuda, dtype):
    """K4-int8 and K5-int8 copy 16-byte chunks in either q dtype: a
    payload 8 bytes off a 16-byte boundary, a scale plane 4 bytes off or
    a q 8 bytes off is refused, not read, and nothing launches."""
    for layout in ("slots", "pool"):
        run, _, args, sc, _, _ = _int8_decode_case(cuda, layout, 64, dtype,
                                                   seed=19)
        q, k = args[:2]
        reset_launches()
        with pytest.raises(ValueError, match="16-byte"):
            run(q, _off16(k, 8), *args[2:], **sc)
        with pytest.raises(ValueError, match="16-byte"):
            run(*args, k_scale=sc["k_scale"],
                v_scale=_off16(sc["v_scale"], 4))
        with pytest.raises(ValueError, match="16-byte"):
            run(_off16(q, 8), *args[1:], **sc)
        assert not any(launch_counts().values())
