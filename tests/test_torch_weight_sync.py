"""Live weight swaps on the port, on the CPU.

- ``ServingEngine.swap_params`` copies the new weights into the resident
  tensors: no ``data_ptr()`` changes, the speculative draft (which shares
  the dict) and an MoE model's expert stacks swap with it, and the
  tokens after a swap equal a fresh port engine's on the new weights
  and the JAX engine's after its own swap.
- A push with a wrong shape or a wrong key set is refused before any
  tensor moves: a checksum of every resident tensor is unchanged, also
  when the bad entry comes last in the dict.
- The rollout and rollback scenarios of the JAX package's
  ``tests/test_weight_sync.py`` (the engine swap contract, the rolling
  swap with zero loss and token identity, stale and corrupt pushes,
  chaos kills mid-rollout, the ``hetu_top`` version column and the
  trace's version-coherence rule) on port engines, held to that file's
  own assertions (``torch_fleet_shim``).  Its PS-versioned pull waits
  for the port's parameter server (ROADMAP A10).
"""

import numpy as np
import pytest
import torch

import test_weight_sync as J
from hetu_tpu.serving import Request as JRequest
from hetu_tpu.serving import ServingEngine as JEngine
from hetu_tpu_torch.models import moe_decode as tmd
from hetu_tpu_torch.serving import Request as TRequest
from torch_fleet_shim import CpuEngine, port_fixture

model = J.model
_fresh = port_fixture(J)

PROMPTS = [[5, 6, 7], [1, 2], [9, 3, 4, 8]]


def _reqs(Req):
    return [Req(prompt=pr, max_new_tokens=5, request_id=f"w{i}")
            for i, pr in enumerate(PROMPTS)]


def _tokens(res):
    return {k: v.tokens.tolist() for k, v in res.items()}


def _checksum(params):
    return {k: (v.double().sum().item(), v.double().abs().sum().item())
            for k, v in params.items()}


@pytest.mark.parametrize("kw", [
    dict(paged=True, ragged=True),
    dict(paged=False, ragged=False),
    dict(paged=True, ragged=False, spec=2),
], ids=["paged-mixed", "contiguous-split", "paged-split-spec2"])
def test_swap_in_place_equals_fresh_and_jax(model, kw):
    p1, p2, cfg = model
    eng = CpuEngine(p1, cfg, slots=2, **kw)
    ptrs = {k: v.data_ptr() for k, v in eng.params.items()}
    eng.run(_reqs(TRequest))
    eng.swap_params(p2, version=2)
    assert {k: v.data_ptr() for k, v in eng.params.items()} == ptrs
    got = _tokens(eng.run(_reqs(TRequest)))
    fresh = _tokens(CpuEngine(p2, cfg, slots=2, **kw).run(_reqs(TRequest)))
    assert got == fresh
    jeng = JEngine(p1, cfg, slots=2, fast_path=False, **kw)
    jeng.run(_reqs(JRequest))
    jeng.swap_params(p2, version=2)
    assert got == _tokens(jeng.run(_reqs(JRequest)))
    assert all(r.weight_version == 2
               for r in eng.run(_reqs(TRequest)).values())


@pytest.mark.parametrize("where", ["first", "last"])
def test_bad_push_refused_before_any_tensor_moves(model, where):
    p1, p2, cfg = model
    eng = CpuEngine(p1, cfg, slots=2)
    before = _checksum(eng.params)
    keys = sorted(p2)
    bad = keys[0] if where == "first" else keys[-1]
    order = [k for k in keys if k != bad]
    order = [bad] + order if where == "first" else order + [bad]
    push = {k: p2[k] for k in order}
    push[bad] = np.zeros((3, 3))
    with pytest.raises(ValueError, match="shape"):
        eng.swap_params(push, version=2)
    assert _checksum(eng.params) == before
    extra = dict(p2, ws_extra_weight=np.zeros(2))
    with pytest.raises(ValueError, match="key mismatch"):
        eng.swap_params(extra, version=2)
    assert _checksum(eng.params) == before
    assert eng.weight_version is None


@pytest.mark.parametrize("given", ["numpy", "tensors"])
def test_swap_leaves_the_callers_params_alone(model, given):
    """The engine owns its resident tensors: a swap on one engine
    changes neither the caller's params nor another engine built from
    them (an f32 numpy array on the CPU, or a tensor passed as is,
    would otherwise share its memory)."""
    from hetu_tpu_torch.weights import params_from_numpy
    p1, p2, cfg = model
    src = ({k: np.asarray(v, np.float32) for k, v in p1.items()}
           if given == "numpy" else params_from_numpy(p1, device="cpu"))
    before = {k: np.array(v, copy=True) for k, v in src.items()}
    a = CpuEngine(src, cfg, slots=2)
    b = CpuEngine(src, cfg, slots=2)
    want = _tokens(b.run(_reqs(TRequest)))
    a.swap_params(p2, version=2)
    assert all(np.array_equal(np.asarray(src[k]), before[k]) for k in src)
    assert _tokens(b.run(_reqs(TRequest))) == want


def test_swap_drops_stale_prefixes(model):
    """A prompt whose blocks a v1 request registered is prefilled anew
    after the swap: its tokens equal a fresh v2 engine's.  (The JAX
    engine attaches the v1 blocks there and decodes other tokens:
    ROADMAP Queue C, C5.)"""
    p1, p2, cfg = model
    kw = dict(slots=2, paged=True, kv_block=8, prefix_share=True)
    prompt = list(range(1, 20))                     # two full blocks

    def run(eng):
        req = TRequest(prompt=prompt, max_new_tokens=4)
        return next(iter(eng.run([req]).values())).tokens.tolist()

    eng = CpuEngine(p1, cfg, **kw)
    run(eng)
    assert eng.kv.stats()["prefix_entries"] > 0
    free = eng.kv.free_blocks
    eng.swap_params(p2, version=2)
    assert eng.kv.stats()["prefix_entries"] == 0
    assert eng.kv.free_blocks > free
    assert run(eng) == run(CpuEngine(p2, cfg, **kw))
    assert eng.kv.prefix_hits == 0


def test_moe_expert_stacks_swap_in_place():
    """An MoE model's gate and expert stacks are resident tensors like
    any other: they swap in place, and the tokens equal a fresh engine's
    on the new weights."""
    kw = dict(vocab_size=61, hidden_size=16, num_hidden_layers=2,
              num_attention_heads=2, ffn_mult=2, seq_len=32,
              dropout_rate=0.0, max_position_embeddings=32, num_experts=4,
              top_k=2, moe_every=2)
    cfg = tmd.MoEDecodeConfig(**kw)
    p1 = tmd.init_moe_params(cfg, name="m", seed=0)
    p2 = tmd.init_moe_params(cfg, name="m", seed=1)
    eng = CpuEngine(p1, cfg, slots=2, name="m")
    stack = "m_h1_moe_expert_stack_w1"
    ptr = eng.params[stack].data_ptr()
    eng.swap_params(p2, version=2)
    assert eng.params[stack].data_ptr() == ptr
    assert torch.equal(eng.params[stack],
                       torch.from_numpy(np.asarray(p2[stack], np.float32)))
    got = _tokens(eng.run(_reqs(TRequest)))
    fresh = CpuEngine(p2, cfg, slots=2, name="m")
    assert got == _tokens(fresh.run(_reqs(TRequest)))


class TestTorchEngineSwap(J.TestEngineSwap):
    pass


class TestTorchRollingSwap(J.TestRollingSwap):
    pass


class TestTorchChaosSwap(J.TestChaosSwap):
    pass


class TestTorchTopAndTrace(J.TestTopAndTrace):
    pass


class TestTorchSwapSeam:
    """The scenarios above run through the port: a router built by the
    JAX test module's ``_fleet`` holds port engines."""

    def test_fleet_helper_builds_port_engines(self, model):
        router, coord = J._fleet(model)
        assert all(isinstance(r.engine, CpuEngine) for r in router.replicas)
        assert type(coord).__module__.startswith("hetu_tpu_torch.")
