"""The PyTorch port's serving engine and KV managers against the JAX
package's, on the CPU.

- The same operation sequence on both ``PagedKVManager``s leaves equal
  free lists, block tables, refcounts, prefix-cache counters and pool
  contents (exact); on both ``KVCacheManager``s, equal free lists,
  lengths and owners.
- ``ServingEngine(device="cpu")`` emits, request by request, the greedy
  tokens of the JAX ``ServingEngine(paged=True, kv_block=8,
  ragged=True)`` on a trace with queueing (more requests than slots),
  chunked prefill (``prefill_chunk=4``) and prefix sharing — against the
  masked reference configuration (``fast_path=False``) the JAX
  package's own mixed-mode tests pin on the CPU, and against its kernel
  configuration (the ragged kernel in interpret mode) on a short trace.
  The port has one attention path, the ragged wrapper, for both.  The
  other layouts and schedulers are held to JAX in
  test_torch_phase_split.py.
- With bf16 params on both sides, the engine's greedy tokens against the
  JAX engine's under the teacher-forced margin gate.
- Inside the port: engine greedy == offline ``generate_fast``; sampled
  outputs depend on the request alone (seed, prompt, settings), not on
  slot or arrival order; the one option not ported yet (the PS cold
  tier of tiered KV, ROADMAP A10) raises NotImplementedError, whether
  asked for by argument or environment, and the fleet seams refuse bad
  input (test_torch_fleet_*.py, test_torch_weight_sync.py hold them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hetu_tpu.serving import Request, ServingEngine
from hetu_tpu.serving.kv_manager import KVCacheManager, PagedKVManager
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.serving import QueueFull
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TServingEngine
from hetu_tpu_torch.serving.kv_manager import (
    KVCacheManager as TKVCacheManager, PagedKVManager as TPagedKVManager)
from test_torch_gpt_decode import rand_gpt

PREFIX = list(range(20, 32))          # shares one full 8-token block
# (prompt, max_new_tokens, temperature, top_k): greedy and sampled,
# prompts longer than the chunk, a shared prefix, more requests than
# the 4 slots
TRACE = [(PREFIX + [1, 2, 3], 6, 0.0, 0), ([3, 4], 8, 0.0, 0),
         (PREFIX + [5, 6], 5, 0.0, 0), ([1, 2, 3, 4, 5], 4, 0.0, 0),
         ([11], 7, 0.0, 0), (PREFIX + [9] * 6, 5, 0.0, 0),
         (list(range(7, 18)), 5, 0.0, 0), ([2, 3], 6, 0.9, 5),
         ([9, 9, 9], 5, 0.7, 3)]
KW = dict(paged=True, kv_block=8, ragged=True, prefill_chunk=4,
          prefix_share=True)


@pytest.fixture(scope="module")
def model():
    return rand_gpt()


def _reqs(Req, trace, order=None):
    idx = range(len(trace)) if order is None else order
    return [Req(prompt=trace[i][0], max_new_tokens=trace[i][1],
                temperature=trace[i][2], top_k=trace[i][3], seed=i,
                request_id=f"r{i}") for i in idx]


def _run(Eng, Req, p, cfg, trace=TRACE, order=None, slots=4, **kw):
    eng = Eng(p, cfg, slots=slots, **kw)
    res = eng.run(_reqs(Req, trace, order))
    return {k: v.tokens.tolist() for k, v in res.items()}, eng


def _greedy(trace, out):
    return {f"r{i}": out[f"r{i}"] for i, t in enumerate(trace)
            if t[2] == 0.0}


# ------------------------------------------------------------------- #
# the paged KV manager
# ------------------------------------------------------------------- #


def _kv_state(kv):
    return dict(free=list(kv._free), tables=kv.tables.tolist(),
                ref=kv.ref.tolist(), n_table=kv.n_table.tolist(),
                lengths=kv.lengths.tolist(), hits=kv.prefix_hits,
                hit_tokens=kv.prefix_hit_tokens, cow=kv.cow_copies,
                evictions=kv.evictions, entries=sorted(kv._prefix),
                pool=np.asarray(kv.cache_k).tolist())


def test_paged_kv_manager_matches_jax():
    shape = dict(layers=2, heads=2, head_dim=4, slots=4, max_seq_len=64,
                 block=8, pool_blocks=14, prefix_share=True)
    jkv = PagedKVManager(dtype=jnp.float32, **shape)
    tkv = TPagedKVManager(dtype=torch.float32, device="cpu", **shape)
    data = np.random.RandomState(0).randn(
        *tuple(jkv.cache_k.shape)).astype(np.float32)
    jkv.cache_k = jnp.asarray(data)
    tkv.cache_k.copy_(torch.from_numpy(data))
    a = list(range(100, 120))                     # 20-token prompt

    def both(fn):
        r = (fn(jkv), fn(tkv))
        assert r[0] == r[1]
        assert _kv_state(jkv) == _kv_state(tkv)
        return r[0]

    sa, _ = both(lambda kv: kv.alloc("a", a, 30))
    both(lambda kv: kv.advance(sa, 20))
    both(lambda kv: kv.register_prefix(a, sa))
    # a prompt extending a verbatim: two shared blocks + a COW fork
    sb, cached = both(lambda kv: kv.alloc("b", a + [7, 8], 40))
    assert cached == 20 and tkv.cow_copies == 1
    both(lambda kv: kv.release(sa))
    both(lambda kv: kv.advance(sb, 22))
    both(lambda kv: kv.truncate(sb, 9))
    both(lambda kv: kv.match_prefix(a[:17] + [1])[1])
    # pool pressure: the registered prefixes are LRU-evicted
    both(lambda kv: kv.alloc("c", [1, 2, 3], 60))
    assert tkv.evictions > 0
    both(lambda kv: kv.release(sb))


def _slots_state(kv):
    return dict(free=list(kv._free), lengths=kv.lengths.tolist(),
                owner=list(kv.owner), allocs=kv.total_allocs,
                occupancy=kv.occupancy, live=kv.live())


def test_kv_cache_manager_matches_jax():
    shape = dict(layers=2, heads=2, head_dim=4, slots=3, max_seq_len=40,
                 pos_cap=48)
    jkv = KVCacheManager(dtype=jnp.float32, **shape)
    tkv = TKVCacheManager(dtype=torch.float32, device="cpu", **shape)
    assert (tkv.n_slots, tkv.s_max) == (jkv.n_slots, jkv.s_max) == (4, 48)
    assert tuple(tkv.cache_k.shape) == tuple(jkv.cache_k.shape)
    assert tkv.cache_bytes == jkv.cache_bytes
    assert [tkv.bucket_prompt(p) for p in (1, 9, 33, 48)] \
        == [jkv.bucket_prompt(p) for p in (1, 9, 33, 48)]

    def both(fn):
        r = (fn(jkv), fn(tkv))
        assert r[0] == r[1]
        assert _slots_state(jkv) == _slots_state(tkv)
        return r[0]

    def both_raise(fn):
        for kv in (jkv, tkv):
            with pytest.raises(ValueError):
                fn(kv)
        assert _slots_state(jkv) == _slots_state(tkv)

    a = both(lambda kv: kv.alloc("a", 7))
    b = both(lambda kv: kv.alloc("b", 12))
    both(lambda kv: kv.advance(a, 3))
    both(lambda kv: kv.truncate(b, 5))
    both_raise(lambda kv: kv.truncate(b, 6))
    both(lambda kv: kv.release(a))
    both_raise(lambda kv: kv.release(a))
    both_raise(lambda kv: kv.alloc("x", 49))
    for name in "cdef":               # fills the 4 slots, then None
        both(lambda kv: kv.alloc(name, 2))
    both(lambda kv: kv.release(b))
    both(lambda kv: kv.alloc("g", 1))


def test_kv_cache_manager_refuses_what_is_not_ported():
    """Span export and import are ported (test_torch_fleet_wire.py);
    what they refuse, they refuse as the JAX manager does: a free slot,
    a paged payload, a reserve below the payload."""
    shape = dict(layers=1, heads=1, head_dim=4, slots=2, max_seq_len=16)
    kv = TKVCacheManager(device="cpu", **shape)
    jkv = KVCacheManager(**shape)
    for m in (kv, jkv):
        with pytest.raises(ValueError, match="free"):
            m.export_blocks(0)
        with pytest.raises(ValueError, match="paged"):
            m.import_blocks({"layout": "paged"}, "a")
        slot = m.alloc("a", 5)
        pay = m.export_blocks(slot)
        with pytest.raises(ValueError, match="reserve"):
            m.import_blocks(pay, "b", reserve=2)


@pytest.mark.parametrize("paged", [False, True])
def test_kv_managers_default_to_the_card(paged, monkeypatch):
    """A manager built without a device allocates on CUDA, like every
    entry point of the port: without a card it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = dict(layers=1, heads=1, head_dim=4, slots=2, max_seq_len=16)
    cls = TPagedKVManager if paged else TKVCacheManager
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(**shape)


# ------------------------------------------------------------------- #
# the engine against the JAX engine
# ------------------------------------------------------------------- #


def test_engine_greedy_matches_jax_masked(model):
    p, jcfg, tcfg = model
    want, jeng = _run(ServingEngine, Request, p, jcfg, fast_path=False,
                      **KW)
    got, teng = _run(TServingEngine, TRequest, p, tcfg, device="cpu",
                     **KW)
    assert _greedy(TRACE, got) == _greedy(TRACE, want)
    assert teng.kv.prefix_hits == jeng.kv.prefix_hits > 0
    assert teng.prefill_chunks == jeng.prefill_chunks
    assert teng.steps == jeng.steps


def test_engine_greedy_matches_jax_kernel_path(model):
    p, jcfg, tcfg = model
    trace = TRACE[:5]
    want, _ = _run(ServingEngine, Request, p, jcfg, trace=trace,
                   fast_path=True, **KW)
    got, _ = _run(TServingEngine, TRequest, p, tcfg, trace=trace,
                  device="cpu", **KW)
    assert _greedy(trace, got) == _greedy(trace, want)


def test_engine_bf16_greedy_within_the_margin_gate(model):
    """bf16 params on both sides: each greedy request's tokens equal the
    JAX engine's, or first differ at a generated position whose exact
    (f32) top-2 margin is at most 2 delta, delta the largest |bf16 - f32|
    teacher-forced logit gap over JAX's sequence (the int8 gate of
    tests/test_quant.py with bf16 in the place of the fake-quantized
    cache).  Free-running bf16 tokens need not agree past such a
    position; on this trace all seven greedy requests are identical."""
    p, jcfg, tcfg = model
    pbf = {k: jnp.asarray(np.asarray(v, np.float32), jnp.bfloat16)
           for k, v in p.items()}
    want, _ = _run(ServingEngine, Request, pbf, jcfg, fast_path=True, **KW)
    got, teng = _run(TServingEngine, TRequest, p, tcfg, device="cpu",
                     dtype=torch.bfloat16, **KW)
    assert teng.kv.cache_k.dtype == torch.bfloat16
    same = 0
    for rid, w in _greedy(TRACE, want).items():
        g = got[rid]
        if g == w:
            same += 1
            continue
        t = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
        seq = np.asarray(w[:-1], np.int64)
        exact = tgd.teacher_forced_logits(p, tcfg, seq, device="cpu")
        low = tgd.teacher_forced_logits(p, tcfg, seq, device="cpu",
                                        dtype=torch.bfloat16)
        delta = float((low - exact).abs().max())
        top2 = torch.topk(exact[t - 1], 2).values
        prompt = len(TRACE[int(rid[1:])][0])
        assert t >= prompt and float(top2[0] - top2[1]) <= 2 * delta, rid
    assert same >= 1


# ------------------------------------------------------------------- #
# the port's own contracts
# ------------------------------------------------------------------- #


@pytest.mark.parametrize("chunk", [4, 0])
def test_engine_greedy_equals_generate_fast(model, chunk):
    """Chunked (4) and whole-prompt (0) prefill waves alike."""
    p, _, tcfg = model
    got, _ = _run(TServingEngine, TRequest, p, tcfg, device="cpu",
                  **dict(KW, prefill_chunk=chunk))
    for i, (prompt, n, temp, _) in enumerate(TRACE):
        if temp:
            continue
        off = tgd.generate_fast(p, tcfg, [prompt], n, device="cpu")
        assert got[f"r{i}"] == off[0].tolist(), i


def test_sampling_is_per_request(model):
    """Outputs depend on (prompt, seed, settings) only: another arrival
    order on fewer slots gives the same tokens, greedy and sampled."""
    p, _, tcfg = model
    a, _ = _run(TServingEngine, TRequest, p, tcfg, device="cpu", **KW)
    order = list(reversed(range(len(TRACE))))
    b, _ = _run(TServingEngine, TRequest, p, tcfg, device="cpu",
                order=order, slots=2, **KW)
    assert a == b
    sampled = [f"r{i}" for i, t in enumerate(TRACE) if t[2] > 0]
    for rid in sampled:
        assert all(0 <= t < tcfg.vocab_size for t in a[rid])


PR = dict(paged=True, ragged=True)


@pytest.mark.parametrize("kw,env", [
    (dict(PR, tier_store="ps"), None),
    (PR, ("HETU_KV_PS_TIER", "1")),
], ids=["tiers", "env-tiers"])
def test_unported_options_raise(model, monkeypatch, kw, env):
    """The PS cold tier of tiered KV is refused, by argument (a store
    asked for it) or environment variable, naming ROADMAP A10; the host
    tier runs (test_torch_kv_tiers.py), as do speculation, int8 KV and
    MoE configs (test_torch_moe_serving.py)."""
    from hetu_tpu_torch.serving import TieredKVStore
    p, _, tcfg = model
    if env is not None:
        monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        if kw.get("tier_store") == "ps":
            kw = dict(kw, tier_store=TieredKVStore(host_bytes=4096,
                                                   ps_tier=True))
        TServingEngine(p, tcfg, device="cpu", **kw)


def test_swap_params_and_spec_offline_raise(model):
    """Weight swaps are ported (test_torch_weight_sync.py): a push whose
    keys do not match the resident params raises before any tensor
    moves, and a matching push lands in place."""
    p, _, tcfg = model
    eng = TServingEngine(p, tcfg, device="cpu", **KW)
    with pytest.raises(ValueError, match="key mismatch"):
        eng.swap_params({k: v for k, v in p.items()
                         if not k.endswith("_wpe")})
    ptr = eng.params["rg_wpe"].data_ptr()
    eng.swap_params(p, version=3)
    assert eng.weight_version == 3
    assert eng.params["rg_wpe"].data_ptr() == ptr


def test_queue_limit_backpressure(model):
    p, _, tcfg = model
    eng = TServingEngine(p, tcfg, device="cpu", queue_limit=1, **KW)
    eng.submit(TRequest(prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(QueueFull):
        eng.submit(TRequest(prompt=[3], max_new_tokens=2))
    assert len(eng.run()) == 1 and eng.pending == 0
