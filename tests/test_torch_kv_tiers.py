"""Tiered KV on port engines, on the CPU: the host-ring scenarios of the
JAX package's ``tests/test_kv_tiers.py`` run unchanged on the port
(``torch_fleet_shim``) and are held to that file's own assertions.

- The ladder: LRU pressure spills an evicted prefix into the host ring
  and a fetch returns the byte-identical wire payload; a refresh is one
  residency; with both knobs off nothing is wired.
- The fleet: a storm of requests sharing an evicted prefix fetches it
  from the ring token-identically; a retirement with no peer room
  spills instead of dropping; a corrupted ring entry degrades to a cold
  admission.
- The directory's tier column and the trace's tier-balance rule.

The parameter-server cold rung waits for the port's PS (ROADMAP A10):
the JAX scenarios that drive it are not collected here, and the port
refuses it, by argument and environment variable, naming A10.
"""

import pytest

import test_kv_tiers as J
from hetu_tpu_torch.serving import ServingEngine, TieredKVStore
from hetu_tpu_torch.serving.router import ServingRouter
from torch_fleet_shim import port_fixture

model = J.model
_fresh = port_fixture(J, helpers=True)


class TestTorchLadder(J.TestLadder):
    test_ring_overflow_demotes_to_ps_in_lru_order = None   # PS rung: A10


class TestTorchFleetTiering(J.TestFleetTiering):
    test_ps_chaos_kill_degrades_to_drop_with_zero_loss = None  # A10


class TestTorchDirectoryTierColumn(J.TestDirectoryTierColumn):
    pass


class TestTorchTierBalanceRule(J.TestTierBalanceRule):
    pass


def test_ps_tier_refused_naming_a10(model, monkeypatch):
    p, cfg = model
    with pytest.raises(NotImplementedError, match="A10"):
        TieredKVStore(host_bytes=1 << 20, ps_tier=True)
    monkeypatch.setenv("HETU_KV_PS_TIER", "1")
    with pytest.raises(NotImplementedError, match="A10"):
        TieredKVStore.from_env()
    with pytest.raises(NotImplementedError, match="A10"):
        ServingRouter(J._factory(model), replicas=1)
    with pytest.raises(NotImplementedError, match="A10"):
        ServingEngine(p, cfg, device="cpu", paged=True)


def test_engine_tier_store_argument(model, monkeypatch):
    """A standalone paged engine given ``tier_store=`` wires it into its
    pool: an evicted prefix spills there and a later request with that
    prefix fetches it, token-identical to a cold engine."""
    p, cfg = model
    store = TieredKVStore(host_bytes=1 << 20)
    kw = dict(device="cpu", slots=2, paged=True, kv_block=8,
              prefix_share=True, pool_blocks=6)
    eng = ServingEngine(p, cfg, tier_store=store, **kw)
    assert eng.kv.tier_store is store
    shared = list(range(1, 18))
    from hetu_tpu_torch.serving import Request
    reqs = [Request(prompt=shared + [20], max_new_tokens=3,
                    request_id="a"),
            Request(prompt=[30, 31, 32] * 6, max_new_tokens=3,
                    request_id="b"),
            Request(prompt=shared + [21], max_new_tokens=3,
                    request_id="c")]
    out = {}
    for r in reqs:
        out.update(eng.run([r]))
    assert eng.kv.spills >= 1 and store.fetches["host"] >= 1
    cold = ServingEngine(p, cfg, **kw)
    want = {}
    for r in reqs:
        want.update(cold.run([Request(prompt=r.prompt, max_new_tokens=3,
                                      request_id=r.request_id)]))
    assert {k: v.tokens.tolist() for k, v in out.items()} == \
        {k: v.tokens.tolist() for k, v in want.items()}
