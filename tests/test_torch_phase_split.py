"""The PyTorch port's engine in the layouts and schedulers beside the
paged mixed one, against the JAX package's engine on the CPU:

- contiguous + phase-split (the auto settings off CUDA, in both
  packages);
- paged (block 8) + phase-split + ``prefill_chunk=4`` +
  ``prefix_share=True``;
- contiguous + mixed.

Each gives the JAX engine's greedy tokens, request by request: against
its masked reference (``fast_path=False``) on the full trace, and
against its kernel path (``fast_path=True``, the Pallas kernels in
interpret mode) on a short one, where the dispatch, chunk, step and
prefix-hit counters and the peak occupancy are equal too.  Inside the
port: phase-split and mixed give the same tokens on each layout,
sampled ones included (each request draws its generator once per
emitted token in both); engine greedy equals ``generate_fast``; a CPU
engine with no layout arguments runs contiguous phase-split.
"""

import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from hetu_tpu.serving import Request, ServingEngine
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TServingEngine
from test_torch_serving import TRACE, _greedy, _run, rand_gpt

CONFIGS = {
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=True, kv_block=8, ragged=False,
                        prefill_chunk=4, prefix_share=True),
    "contiguous-mixed": dict(paged=False, ragged=True),
}


@pytest.fixture(scope="module")
def model():
    return rand_gpt()


def _counters(eng):
    return dict(prefill_dispatches=eng.prefill_dispatches,
                prefill_chunks=eng.prefill_chunks, steps=eng.steps,
                peak_live=eng.peak_live,
                prefix_hits=eng.kv.prefix_hits if eng.paged else 0)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_greedy_matches_jax_masked(model, config):
    p, jcfg, tcfg = model
    kw = CONFIGS[config]
    want, jeng = _run(ServingEngine, Request, p, jcfg, fast_path=False,
                      **kw)
    got, teng = _run(TServingEngine, TRequest, p, tcfg, device="cpu", **kw)
    assert (teng.paged, teng.ragged) == (jeng.paged, jeng.ragged)
    assert _greedy(TRACE, got) == _greedy(TRACE, want)
    assert teng.steps == jeng.steps
    if teng.paged:
        assert teng.kv.prefix_hits == jeng.kv.prefix_hits > 0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_matches_jax_kernel_path(model, config):
    p, jcfg, tcfg = model
    kw = CONFIGS[config]
    trace = TRACE[:5]
    want, jeng = _run(ServingEngine, Request, p, jcfg, trace=trace,
                      fast_path=True, **kw)
    got, teng = _run(TServingEngine, TRequest, p, tcfg, trace=trace,
                     device="cpu", **kw)
    assert _greedy(trace, got) == _greedy(trace, want)
    assert _counters(teng) == _counters(jeng)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_phase_split_equals_mixed(model, paged):
    """The whole trace, greedy and sampled, token for token."""
    p, _, tcfg = model
    kw = CONFIGS["paged-split" if paged else "contiguous-split"]
    split, _ = _run(TServingEngine, TRequest, p, tcfg, device="cpu", **kw)
    mixed, _ = _run(TServingEngine, TRequest, p, tcfg, device="cpu",
                    **dict(kw, ragged=True))
    assert split == mixed
    assert any(t[2] > 0 for t in TRACE)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_greedy_equals_generate_fast(model, config):
    p, _, tcfg = model
    got, _ = _run(TServingEngine, TRequest, p, tcfg, device="cpu",
                  **CONFIGS[config])
    for i, (prompt, n, temp, _) in enumerate(TRACE):
        if temp:
            continue
        off = tgd.generate_fast(p, tcfg, [prompt], n, device="cpu")
        assert got[f"r{i}"] == off[0].tolist(), i


def test_cpu_engine_defaults_to_contiguous_phase_split(model, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the auto settings pick the paged mixed engine "
                    "where CUDA is available")
    p, _, tcfg = model
    for var in ("HETU_KV_BLOCK", "HETU_SERVE_RAGGED"):
        monkeypatch.delenv(var, raising=False)
    eng = TServingEngine(p, tcfg, slots=4, device="cpu")
    assert not eng.paged and not eng.ragged
    got = {k: v.tokens.tolist() for k, v in eng.run(
        [TRequest(prompt=t[0], max_new_tokens=t[1], seed=i,
                  request_id=f"r{i}") for i, t in enumerate(TRACE[:4])]
    ).items()}
    want, _ = _run(TServingEngine, TRequest, p, tcfg, trace=TRACE[:4],
                   device="cpu", **CONFIGS["contiguous-split"])
    assert got == want
