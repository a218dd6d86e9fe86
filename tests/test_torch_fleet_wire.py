"""The KV handoff wire of the port against the JAX package's, on the CPU.

- The same pool contents in a JAX manager and a port manager, paged and
  contiguous, f32 and int8 pools, exact ("auto") and int8 wires: the
  export payloads are equal — ``k``/``v`` arrays bit for bit, and
  ``layout``, ``block``, ``length``, ``quant``, ``nbytes``,
  ``raw_nbytes``.  ``export_prefix`` of a registered prefix too.
- A JAX payload imports into a port pool and a port payload into a JAX
  pool, leaving equal pools on both sides (requantization of an exact
  wire into an int8 pool included).
- The prefix-spill hook: the same LRU eviction offers both hooks equal
  payloads, and ``spills`` / ``evictions`` / the directory callbacks
  count alike; ``stats()`` carries the handoff fields.
- Inside the port: a bf16 pool's wire is a host bf16 tensor of JAX's
  byte count, and it round-trips exactly; ``import_blocks`` writes the
  resident pool tensors (no new pool).
- The export/import unit scenarios of the JAX package's
  ``tests/test_fleet_kv.py`` (``TestHandoffWire``) on port pools.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import test_fleet_kv as J
from hetu_tpu.serving.kv_manager import KVCacheManager as JKV
from hetu_tpu.serving.kv_manager import PagedKVManager as JPaged
from hetu_tpu_torch.serving.kv_manager import KVCacheManager as TKV
from hetu_tpu_torch.serving.kv_manager import PagedKVManager as TPaged
from torch_fleet_shim import port_span_f32, use_port_helpers

SHAPE = dict(layers=2, heads=2, head_dim=8, slots=2, max_seq_len=32)
PROMPT = list(range(1, 12))                       # 11 tokens, 2 blocks


def _rand_cache(rng, cache):
    """Host contents for one cache of either package: (int8, scales) or
    f32 values."""
    if isinstance(cache, tuple):
        return (rng.randint(-127, 128, tuple(cache[0].shape)).astype(np.int8),
                (rng.rand(*tuple(cache[1].shape)) + 0.01).astype(np.float32))
    return rng.randn(*tuple(cache.shape)).astype(np.float32)


def _set(mgr, contents):
    """Write host contents into a manager of either package."""
    for name, val in zip(("cache_k", "cache_v"), contents):
        cache = getattr(mgr, name)
        if isinstance(cache, torch.Tensor) or (
                isinstance(cache, tuple)
                and isinstance(cache[0], torch.Tensor)):
            planes = cache if isinstance(cache, tuple) else (cache,)
            vals = val if isinstance(val, tuple) else (val,)
            for t, v in zip(planes, vals):
                t.copy_(torch.from_numpy(v))
        else:
            setattr(mgr, name, tuple(jnp.asarray(v) for v in val)
                    if isinstance(val, tuple) else jnp.asarray(val))


def _pool(mgr):
    """A manager's cache pair as host numpy, planes flattened."""
    out = []
    for cache in (mgr.cache_k, mgr.cache_v):
        for t in (cache if isinstance(cache, tuple) else (cache,)):
            out.append(t.numpy() if isinstance(t, torch.Tensor)
                       else np.asarray(t))
    return out


def _pair(paged, pool, seed=0):
    """A JAX manager and a port manager with equal contents."""
    jdt = jnp.int8 if pool == "int8" else jnp.float32
    tdt = "int8" if pool == "int8" else torch.float32
    if paged:
        kw = dict(SHAPE, block=8, prefix_share=True)
        j, t = JPaged(dtype=jdt, **kw), TPaged(dtype=tdt, device="cpu", **kw)
    else:
        j, t = JKV(dtype=jdt, **SHAPE), TKV(dtype=tdt, device="cpu", **SHAPE)
    rng = np.random.RandomState(seed)
    contents = [_rand_cache(rng, c) for c in (j.cache_k, j.cache_v)]
    _set(j, contents)
    _set(t, contents)
    return j, t


def _fill_slot(mgr, paged, prompt=PROMPT, owner="r0"):
    if paged:
        slot, _ = mgr.alloc(owner, prompt, len(prompt) + 4)
        mgr.advance(slot, len(prompt))
    else:
        slot = mgr.alloc(owner, len(prompt))
    return slot


def _host(a):
    if isinstance(a, tuple):
        return tuple(_host(x) for x in a)
    return np.asarray(a)


def assert_payloads_equal(jp, tp):
    """Equal payload dicts: every scalar field, and k/v bit for bit with
    the same dtype and shape."""
    assert set(jp) == set(tp)
    for key in jp:
        if key in ("k", "v"):
            a, b = _host(jp[key]), _host(tp[key])
            if isinstance(a, tuple):
                assert isinstance(b, tuple) and len(a) == len(b)
            else:
                a, b = (a,), (b,)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert np.array_equal(x.view(np.uint8), y.view(np.uint8))
        else:
            assert jp[key] == tp[key], key


@pytest.mark.parametrize("wire", ["auto", "int8"])
@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_export_payload_equals_jax(paged, pool, wire):
    j, t = _pair(paged, pool)
    sj, st = _fill_slot(j, paged), _fill_slot(t, paged)
    assert sj == st
    jp = j.export_blocks(sj, quant_mode=wire)
    tp = t.export_blocks(st, quant_mode=wire)
    assert_payloads_equal(jp, tp)
    assert tp["quant"] == ("int8" if "int8" in (pool, wire) else None)
    if paged:
        assert (t.exports, t.export_bytes) == (j.exports, j.export_bytes)
        assert t.stats() == {**j.stats(), "cache_bytes": t.cache_bytes}


@pytest.mark.parametrize("wire", ["auto", "int8"])
@pytest.mark.parametrize("dst_pool", ["f32", "int8"])
@pytest.mark.parametrize("src_pool", ["f32", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_cross_package_import(paged, src_pool, dst_pool, wire):
    """JAX payload -> port pool and port payload -> JAX pool: the two
    destination pools are equal afterwards, and equal to a same-package
    import on the other side."""
    js, ts = _pair(paged, src_pool, seed=1)
    jd, td = _pair(paged, dst_pool, seed=2)
    s = _fill_slot(js, paged)
    assert _fill_slot(ts, paged) == s
    jp = js.export_blocks(s, quant_mode=wire)
    tp = ts.export_blocks(s, quant_mode=wire)
    kw = dict(prompt=PROMPT) if paged else {}
    a = td.import_blocks(jp, "x", **kw)                 # JAX -> port
    b = jd.import_blocks(tp, "x", **kw)                 # port -> JAX
    assert a == b is not None
    for x, y in zip(_pool(td), _pool(jd)):
        assert x.dtype == y.dtype
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))
    if paged:
        assert td.stats() == {**jd.stats(), "cache_bytes": td.cache_bytes}


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_export_prefix_and_spill_hook_match_jax(pool):
    """A registered prefix exports without a live slot; evicting it
    under pool pressure offers the spill hook its payload first (equal
    across packages), and the counters and directory callbacks agree."""
    kw = dict(SHAPE, block=8, prefix_share=True, pool_blocks=6)
    jdt = jnp.int8 if pool == "int8" else jnp.float32
    tdt = "int8" if pool == "int8" else torch.float32
    j, t = JPaged(dtype=jdt, **kw), TPaged(dtype=tdt, device="cpu", **kw)
    rng = np.random.RandomState(3)
    contents = [_rand_cache(rng, c) for c in (j.cache_k, j.cache_v)]
    _set(j, contents)
    _set(t, contents)
    logs = {}
    for name, m in (("jax", j), ("torch", t)):
        log = logs[name] = {"spill": [], "reg": [], "evict": []}
        m.on_prefix_spill = (lambda toks, pay, _l=log:
                             _l["spill"].append((toks, pay)) or True)
        m.on_prefix_register = (lambda toks, e, _l=log:
                                _l["reg"].append((toks, e.length)))
        m.on_prefix_evict = lambda toks, _l=log: _l["evict"].append(toks)
        s, _ = m.alloc("a", PROMPT, 16)
        m.advance(s, len(PROMPT))
        m.register_prefix(PROMPT, s)
        m.release(s)
    assert_payloads_equal(j.export_prefix(PROMPT, quant_mode="int8"),
                          t.export_prefix(PROMPT, quant_mode="int8"))
    assert t.export_prefix([9, 9, 9]) is None
    for m in (j, t):                                    # evicts both cuts
        assert m.alloc("b", [50, 51], 32)[0] is not None
    assert logs["torch"]["reg"] == logs["jax"]["reg"]
    assert logs["torch"]["evict"] == logs["jax"]["evict"]
    assert len(logs["torch"]["spill"]) == 2
    for (jt, jpay), (tt, tpay) in zip(logs["jax"]["spill"],
                                      logs["torch"]["spill"]):
        assert jt == tt
        assert_payloads_equal(jpay, tpay)
    assert (t.spills, t.evictions) == (j.spills, j.evictions) == (2, 2)
    # spills stay out of the handoff ledger
    assert t.exports == j.exports == 1
    assert t.stats() == {**j.stats(), "cache_bytes": t.cache_bytes}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_bf16_wire_round_trip(paged):
    """A bf16 pool ships a host bf16 tensor (numpy has no bf16) of 2
    bytes an element, as the JAX package counts its ml_dtypes arrays;
    it lands bit for bit in a bf16 pool and exactly (widened) in an f32
    pool, and its int8 wire is the f32 codec of the bf16 values."""
    def mk(dtype):
        if paged:
            return TPaged(dtype=dtype, device="cpu", block=8,
                          prefix_share=True, **SHAPE)
        return TKV(dtype=dtype, device="cpu", **SHAPE)

    src, dst, wide = mk(torch.bfloat16), mk(torch.bfloat16), mk(torch.float32)
    g = torch.Generator().manual_seed(0)
    for c in (src.cache_k, src.cache_v):
        c.copy_(torch.randn(c.shape, generator=g))
    s = _fill_slot(src, paged)
    pay = src.export_blocks(s)
    assert pay["quant"] is None
    assert isinstance(pay["k"], torch.Tensor) and not pay["k"].is_cuda
    assert pay["k"].dtype == torch.bfloat16
    n = pay["k"].numel()
    assert pay["nbytes"] == 2 * 2 * n and pay["raw_nbytes"] == 2 * 4 * n
    d = dst.import_blocks(pay, "x")
    w = wide.import_blocks(pay, "x")
    if paged:
        got, widened = port_span_f32(dst, d), port_span_f32(wide, w)
        want = port_span_f32(src, s)
    else:
        def row(m, slot):
            return [c[:, slot, :len(PROMPT)].float().numpy()
                    for c in (m.cache_k, m.cache_v)]
        got, widened, want = row(dst, d), row(wide, w), row(src, s)
    for a, b, c in zip(want, got, widened):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    p8 = src.export_blocks(s, quant_mode="int8")
    assert p8["quant"] == "int8"
    assert p8["nbytes"] == n * 2 + (n // SHAPE["head_dim"]) * 4 * 2


def test_import_writes_the_resident_pool():
    """Import writes in place: every plane keeps its address."""
    src, dst = _pair(True, "int8")
    s = _fill_slot(src, True)
    ptrs = [x.data_ptr() for c in (dst.cache_k, dst.cache_v) for x in c]
    pay = src.export_blocks(s)
    assert dst.import_blocks(pay, "x") is not None
    assert ptrs == [x.data_ptr() for c in (dst.cache_k, dst.cache_v)
                    for x in c]


class TestTorchHandoffWire(J.TestHandoffWire):
    """``tests/test_fleet_kv.py``'s export/import scenarios on port
    pools (its helpers swapped for the port's: ``torch_fleet_shim``)."""

    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        use_port_helpers(monkeypatch, J)

    def test_contiguous_manager_parity(self):
        """The JAX scenario with the port's contiguous cache filled in
        place (the JAX test assigns jnp arrays to the manager)."""
        src = TKV(device="cpu", **SHAPE)
        dst = TKV(device="cpu", **SHAPE)
        rng = np.random.RandomState(7)
        for c in (src.cache_k, src.cache_v):
            c.copy_(torch.from_numpy(rng.randn(*c.shape).astype(np.float32)))
        slot = src.alloc("r", 11)
        pay = src.export_blocks(slot)
        assert pay["layout"] == "contiguous" and pay["length"] == 11
        slot2 = dst.import_blocks(pay, "r")
        assert torch.equal(src.cache_k[:, slot, :11],
                           dst.cache_k[:, slot2, :11])
        pay8 = src.export_blocks(slot, quant_mode="int8")
        assert pay8["quant"] == "int8"
        assert pay8["nbytes"] < pay["nbytes"]
        with pytest.raises(ValueError):
            J._mgr().import_blocks(pay, "r")              # layout mismatch
