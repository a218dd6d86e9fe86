"""The PyTorch port's MoE serving module (``hetu_tpu_torch.models.
moe_decode``) against the JAX package's ``models/moe_decode.py`` on the
CPU, same numpy inputs on both sides:

- ``moe_capacity`` over a grid of specs and token counts, and
  ``moe_spec_of`` with and without ``$HETU_MOE_CAPACITY``: equal;
- ``init_moe_params`` and ``convert_dense_to_moe``: the same arrays,
  exactly;
- ``moe_ffn`` over experts, top-k, capacity factors (one that binds), a
  ``valid`` mask, with and without biases, and zero gate weights with
  k < E (every gate 1/E: the tie order picks the experts): y within
  1e-5 + 1e-5 rel, per-expert load and drop equal exactly, and every
  row whose k pairs were all dropped, or that is invalid, exactly 0;
- ``moe_ffn`` in bf16 against JAX's jitted bf16 ``moe_ffn``: experts
  with a constant output expose the combine weights, bit for bit; with
  random experts y within 2 bf16 ulps of the largest |y|; load and drop
  equal exactly, ties and a binding capacity included;
- an ``ep_axis`` config carries its axis into the spec as JAX's does
  (expert parallelism itself: tests/test_torch_expert_parallel.py);
- replicated experts with k = E (``convert_dense_to_moe``'s oracle):
  the dense FFN within 2e-5.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from hetu_tpu.models import GPTConfig
from hetu_tpu.models import moe_decode as jmd
from hetu_tpu_torch.models import GPTConfig as TGPTConfig
from hetu_tpu_torch.models import moe_decode as tmd


def _cfgs(**kw):
    base = dict(vocab_size=97, hidden_size=32, num_hidden_layers=4,
                num_attention_heads=2, ffn_mult=2, seq_len=48,
                dropout_rate=0.0, max_position_embeddings=48,
                num_experts=4, top_k=2, capacity_factor=2.0, moe_every=2)
    base.update(kw)
    return jmd.MoEDecodeConfig(**base), tmd.MoEDecodeConfig(**base)


@pytest.mark.parametrize("E,k,cf", [(2, 1, 1.0), (4, 2, 2.0), (4, 2, 0.25),
                                    (8, 2, 1.25), (8, 8, 0.5), (3, 2, 1.0)])
def test_moe_capacity_matches_jax(E, k, cf):
    js, ts = jmd.MoESpec(E, k, cf, 1), tmd.MoESpec(E, k, cf, 1)
    for T in list(range(1, 70)) + [255, 256, 1000, 2048]:
        assert tmd.moe_capacity(ts, T) == jmd.moe_capacity(js, T)


@pytest.mark.parametrize("env", [None, "3.5", "", "0"])
@pytest.mark.parametrize("every,k", [(2, 2), (1, 4), (4, 1)])
def test_moe_spec_of_matches_jax(monkeypatch, env, every, k):
    if env is None:
        monkeypatch.delenv("HETU_MOE_CAPACITY", raising=False)
    else:
        monkeypatch.setenv("HETU_MOE_CAPACITY", env)
    jc, tc = _cfgs(moe_every=every, top_k=k)
    for draft in (False, True):
        js = jmd.moe_spec_of(jc, draft=draft)
        ts = tmd.moe_spec_of(tc, draft=draft)
        assert {f: getattr(js, f) for f in ts._fields} == ts._asdict()
    assert [ts.is_moe_layer(i) for i in range(4)] == \
        [js.is_moe_layer(i) for i in range(4)]
    assert ts.moe_layers(4) == js.moe_layers(4)
    assert tmd.resolve_moe_capacity() == jmd.resolve_moe_capacity()
    dense = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, max_position_embeddings=48,
                 seq_len=48)
    assert tmd.moe_spec_of(TGPTConfig(**dense)) is None
    assert jmd.moe_spec_of(GPTConfig(**dense)) is None


@pytest.mark.parametrize("bad", [dict(num_experts=1), dict(top_k=5),
                                 dict(moe_every=5),
                                 dict(capacity_factor=0.0)])
def test_config_refusals_match_jax(bad):
    with pytest.raises(ValueError):
        _cfgs(**bad)


def test_expert_parallel_config_matches_jax():
    """An ``ep_axis`` config is served: its spec carries the axis, as
    JAX's does, and a config without one has none."""
    jc, tc = _cfgs(ep_axis="ep")
    assert tc.ep_axis == jc.ep_axis == "ep"
    assert tuple(tmd.moe_spec_of(tc)) == tuple(jmd.moe_spec_of(jc))
    assert tmd.moe_spec_of(tc).ep_axis == "ep"
    assert tmd.moe_spec_of(_cfgs()[1]).ep_axis is None


@pytest.mark.parametrize("kw,seed", [(dict(), 0),
                                     (dict(moe_every=1, expert_size=24), 3)])
def test_init_moe_params_matches_jax(kw, seed):
    jc, tc = _cfgs(**kw)
    want = jmd.init_moe_params(jc, name="moe", seed=seed)
    got = tmd.init_moe_params(tc, name="moe", seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("every", [1, 2])
def test_convert_dense_to_moe_matches_jax(every):
    rng = np.random.RandomState(1)
    D, F = 32, 64
    p = {"dn_wte_table": rng.randn(97, D).astype(np.float32)}
    for i in range(4):
        for w, shp in (("ffn_wi", (D, F)), ("ffn_wo", (F, D)),
                       ("attn_q", (D, D))):
            p[f"dn_h{i}_{w}_weight"] = rng.randn(*shp).astype(np.float32)
            p[f"dn_h{i}_{w}_bias"] = rng.randn(shp[1]).astype(np.float32)
    jc, tc = _cfgs(moe_every=every, top_k=4)
    want = jmd.convert_dense_to_moe(p, None, jc, name="dn")
    got = tmd.convert_dense_to_moe(p, None, tc, name="dn")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# (E, k, capacity factor, valid mask, biases, zero gate weights)
FFN_CASES = {
    "E4k2": (4, 2, 2.0, False, True, False),
    "E4k2-valid": (4, 2, 2.0, True, True, False),
    "E4k1-binding": (4, 1, 0.25, False, False, False),
    "E4k2-binding-valid": (4, 2, 0.5, True, True, False),
    "E8k2-nobias": (8, 2, 1.0, False, False, False),
    "E8k3-binding": (8, 3, 0.5, True, True, False),
    "E4k2-ties": (4, 2, 1.0, False, True, True),
    "E4k3-ties-binding-valid": (4, 3, 0.5, True, False, True),
    "E2k2": (2, 2, 1.0, True, True, False),
}


def _ffn_params(rng, us, E, D, F, bias, zero_gate):
    p = {f"{us}_moe_gate_weight": (np.zeros((D, E), np.float32)
                                   if zero_gate else
                                   rng.randn(D, E).astype(np.float32)),
         f"{us}_moe_expert_stack_w1":
             (rng.randn(E, D, F) * 0.1).astype(np.float32),
         f"{us}_moe_expert_stack_w2":
             (rng.randn(E, F, D) * 0.1).astype(np.float32)}
    if bias:
        p[f"{us}_moe_expert_stack_b1"] = \
            (rng.randn(E, F) * 0.1).astype(np.float32)
        p[f"{us}_moe_expert_stack_b2"] = \
            (rng.randn(E, D) * 0.1).astype(np.float32)
    return p


def _all_dropped(gates, k, cap, valid):
    """Rows none of whose k (token, rank) pairs got a slot: the arrival
    order of ``moe_ffn`` (rank by rank, token by token, each pair
    counting against its expert's slots whether kept or not), ties to
    the lowest expert index."""
    T, E = gates.shape
    topi = np.argsort(-gates, axis=1, kind="stable")[:, :k]
    seen = np.zeros(E, int)
    kept = np.zeros((T, k), bool)
    for r in range(k):
        for t in range(T):
            if valid[t]:
                e = topi[t, r]
                kept[t, r] = seen[e] < cap
                seen[e] += 1
    return ~kept.any(axis=1)


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    E, k, cf, masked, bias, zero_gate = FFN_CASES[case]
    rng = np.random.RandomState(sorted(FFN_CASES).index(case))
    D, F, T = 16, 24, 40
    us = "m_h0"
    p = _ffn_params(rng, us, E, D, F, bias, zero_gate)
    x = rng.randn(T, D).astype(np.float32)
    valid = (rng.rand(T) > 0.3) if masked else np.ones(T, bool)
    jspec, tspec = jmd.MoESpec(E, k, cf, 1), tmd.MoESpec(E, k, cf, 1)
    js, ts = {}, {}
    want = np.asarray(jmd.moe_ffn(
        {n: jnp.asarray(v) for n, v in p.items()}, us, jnp.asarray(x),
        jspec, valid=jnp.asarray(valid) if masked else None, stats=js))
    got = tmd.moe_ffn(
        {n: torch.from_numpy(v) for n, v in p.items()}, us,
        torch.from_numpy(x), tspec,
        valid=torch.from_numpy(valid) if masked else None,
        stats=ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ts["load"].numpy(), np.asarray(js["load"]))
    np.testing.assert_array_equal(ts["drop"].numpy(), np.asarray(js["drop"]))
    assert int(ts["load"].sum() + ts["drop"].sum()) == int(valid.sum()) * k
    cap = tmd.moe_capacity(tspec, T)
    assert (ts["load"].numpy() <= cap).all()
    if cf < 1.0 and not zero_gate:
        assert int(ts["drop"].sum()) > 0        # the case binds
    gates = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        p[f"{us}_moe_gate_weight"]), -1).numpy()
    zero = _all_dropped(gates, k, cap, valid) | ~valid
    assert (got[zero] == 0.0).all() and (want[zero] == 0.0).all()


# bf16: (E, k, capacity factor, valid mask, zero gate weights)
BF16_CASES = {
    "E4k2": (4, 2, 2.0, False, False),
    "E4k2-binding-valid": (4, 2, 0.5, True, False),
    "E8k2-valid": (8, 2, 1.0, True, False),
    "E4k2-ties": (4, 2, 1.0, False, True),
    "E4k3-ties-binding-valid": (4, 3, 0.5, True, True),
}


def _bf16_ffn(p, us, x, valid, E, k, cf):
    """JAX's ``moe_ffn`` (jitted, as its engine runs it) and the port's on
    the same params and x cast to bf16, their load and drop held equal:
    (want, got) as f32 numpy and the port's stats."""
    jspec = jmd.MoESpec(E, k, cf, 1)

    def run(pp, xx, vv):
        st = {}
        return jmd.moe_ffn(pp, us, xx, jspec, valid=vv, stats=st), st
    want, js = jax.jit(run)(
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in p.items()},
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(valid))
    ts = {}
    got = tmd.moe_ffn(
        {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in p.items()},
        us, torch.from_numpy(x).to(torch.bfloat16),
        tmd.MoESpec(E, k, cf, 1), valid=torch.from_numpy(valid), stats=ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts["load"].numpy(), np.asarray(js["load"]))
    np.testing.assert_array_equal(ts["drop"].numpy(), np.asarray(js["drop"]))
    return np.asarray(want.astype(jnp.float32)), got.float().numpy(), ts


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_moe_ffn_bf16_combine_weights_match_jax(case):
    """Experts whose output is a constant expose the combine weights: w2
    is zero and expert e's b2 is 1 in column e and s_e in column E, so
    y[t, e] is the bf16 gate of a kept (t, e) pair and y[t, E] the bf16
    sum of s_e times those gates.  Bit for bit JAX's: routing in bf16,
    a gate weight not rounded to bf16 first, or a combine summed in bf16
    each change some of these values (and the tie order which columns
    hold them)."""
    E, k, cf, masked, zero_gate = BF16_CASES[case]
    rng = np.random.RandomState(sorted(BF16_CASES).index(case))
    D, F, T, us = 64, 32, 256, "m_h0"
    b2 = np.zeros((E, D), np.float32)
    b2[np.arange(E), np.arange(E)] = 1.0
    b2[:, E] = 1.0 + rng.rand(E)
    p = {f"{us}_moe_gate_weight": (np.zeros((D, E), np.float32)
                                   if zero_gate else
                                   (rng.randn(D, E) * 0.3).astype(
                                       np.float32)),
         f"{us}_moe_expert_stack_w1":
             (rng.randn(E, D, F) * 0.1).astype(np.float32),
         f"{us}_moe_expert_stack_w2": np.zeros((E, F, D), np.float32),
         f"{us}_moe_expert_stack_b2": b2}
    x = rng.randn(T, D).astype(np.float32)
    valid = (rng.rand(T) > 0.2) if masked else np.ones(T, bool)
    want, got, ts = _bf16_ffn(p, us, x, valid, E, k, cf)
    np.testing.assert_array_equal(got, want)
    assert (got[:, E + 1:] == 0).all() and (got[~valid] == 0).all()
    if zero_gate:       # every gate 1/E: ties go to the lowest index
        assert (got[:, k:E] == 0).all()
    if cf < 1.0:
        assert int(ts["drop"].sum()) > 0


# the bf16 expert products round at other points on the two sides (the
# matmuls' order of summation); measured here at most 1 bf16 ulp of the
# largest |y|
BF16_ULPS = 2


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_moe_ffn_bf16_matches_jax(case):
    """Random experts with biases in bf16: y within 2 bf16 ulps of the
    largest |y|, load and drop equal exactly, dropped and invalid rows
    exactly 0."""
    E, k, cf, masked, zero_gate = BF16_CASES[case]
    rng = np.random.RandomState(10 + sorted(BF16_CASES).index(case))
    D, F, T, us = 64, 96, 256, "m_h0"
    p = _ffn_params(rng, us, E, D, F, True, zero_gate)
    x = rng.randn(T, D).astype(np.float32)
    valid = (rng.rand(T) > 0.2) if masked else np.ones(T, bool)
    want, got, ts = _bf16_ffn(p, us, x, valid, E, k, cf)
    m = float(np.abs(want).max())
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(m)) - 7)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert (got[~valid] == 0).all()
    if cf < 1.0:
        assert int(ts["drop"].sum()) > 0


def test_moe_ffn_dense_oracle():
    """Replicated experts with k = E and non-binding capacity: the dense
    gelu FFN."""
    rng = np.random.RandomState(2)
    D, F, E, T = 16, 32, 4, 12
    wi = (rng.randn(D, F) * 0.1).astype(np.float32)
    wo = (rng.randn(F, D) * 0.1).astype(np.float32)
    bi = (rng.randn(F) * 0.1).astype(np.float32)
    bo = (rng.randn(D) * 0.1).astype(np.float32)
    p = {"m_h0_moe_gate_weight": np.zeros((D, E), np.float32),
         "m_h0_moe_expert_stack_w1": np.broadcast_to(wi, (E, D, F)).copy(),
         "m_h0_moe_expert_stack_b1": np.broadcast_to(bi, (E, F)).copy(),
         "m_h0_moe_expert_stack_w2": np.broadcast_to(wo, (E, F, D)).copy(),
         "m_h0_moe_expert_stack_b2": np.broadcast_to(bo, (E, D)).copy()}
    x = rng.randn(T, D).astype(np.float32)
    y = tmd.moe_ffn({n: torch.from_numpy(v) for n, v in p.items()}, "m_h0",
                    torch.from_numpy(x), tmd.MoESpec(E, E, 8.0, 1)).numpy()
    h = x @ wi + bi
    want = (0.5 * h * (1.0 + np.tanh(0.7978845608028654
                                     * (h + 0.044715 * h ** 3)))) @ wo + bo
    np.testing.assert_allclose(y, want, atol=2e-5, rtol=0)
