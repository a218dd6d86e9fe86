"""The PyTorch port's serving engine and paged KV manager against the
JAX package's, on the CPU.

- The same operation sequence on both ``PagedKVManager``s leaves equal
  free lists, block tables, refcounts, prefix-cache counters and pool
  contents (exact).
- ``ServingEngine(device="cpu")`` emits, request by request, the greedy
  tokens of the JAX ``ServingEngine(paged=True, kv_block=8,
  ragged=True)`` on a trace with queueing (more requests than slots),
  chunked prefill (``prefill_chunk=4``) and prefix sharing — against the
  masked reference configuration (``fast_path=False``) the JAX
  package's own mixed-mode tests pin on the CPU, and against its kernel
  configuration (the ragged kernel in interpret mode) on a short trace.
  The port has one attention path, the ragged wrapper, for both.
- Inside the port: engine greedy == offline ``generate_fast``; sampled
  outputs depend on the request alone (seed, prompt, settings), not on
  slot or arrival order; every option not ported yet raises
  NotImplementedError, whether asked for by argument or environment.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hetu_tpu.serving import Request, ServingEngine
from hetu_tpu.serving.kv_manager import PagedKVManager
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.serving import QueueFull
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TServingEngine
from hetu_tpu_torch.serving.kv_manager import (
    PagedKVManager as TPagedKVManager)
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
    (dict(paged=False, ragged=True), None),
    (dict(paged=True, ragged=False), None),
    (dict(PR, spec=2), None),
    (dict(PR, kv_quant="int8"), None),
    (dict(PR, tier_store=object()), None),
    (dict(PR, moe=True), None),
    (dict(ragged=True), ("HETU_KV_BLOCK", "0")),
    (dict(paged=True), ("HETU_SERVE_RAGGED", "0")),
    (PR, ("HETU_SPEC_K", "2")),
    (PR, ("HETU_KV_QUANT", "int8")),
    (PR, ("HETU_KV_HOST_BYTES", "4096")),
], ids=["paged", "ragged", "spec", "int8", "tiers", "moe", "env-paged",
        "env-ragged", "env-spec", "env-int8", "env-tiers"])
def test_unported_options_raise(model, monkeypatch, kw, env):
    p, _, tcfg = model
    if env is not None:
        monkeypatch.setenv(*env)
    kw = dict(kw)
    if kw.pop("moe", False):
        tcfg = copy.copy(tcfg)
        tcfg.num_experts = 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TServingEngine(p, tcfg, device="cpu", **kw)


def test_swap_params_and_spec_offline_raise(model):
    p, _, tcfg = model
    eng = TServingEngine(p, tcfg, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.swap_params(p)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgd.generate_fast(p, tcfg, [[1, 2]], 2, spec=2, device="cpu")


def test_queue_limit_backpressure(model):
    p, _, tcfg = model
    eng = TServingEngine(p, tcfg, device="cpu", queue_limit=1, **KW)
    eng.submit(TRequest(prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(QueueFull):
        eng.submit(TRequest(prompt=[3], max_new_tokens=2))
    assert len(eng.run()) == 1 and eng.pending == 0
