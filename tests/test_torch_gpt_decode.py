"""The PyTorch port's GPT decode cores against the JAX package's, on the
CPU, same numpy weights and inputs on both sides: ``_prefill_forward``
logits and K/V, one ``_mixed_step`` over the paged pool (against both
JAX attention paths, the ragged kernel and the masked reference), and
greedy ``generate_fast`` tokens (against both JAX prefills).  Plus the
port's own contracts: the weights bridge keeps dtypes, entry points
refuse to run on the CPU unasked, both cores attend through the kernel
wrappers whatever the environment says, and importing the port loads
neither JAX nor the JAX package.

Tolerance for logits and K/V: f32 ``atol 1e-4`` (the same arithmetic,
matmuls and softmax summed in another order).
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hetu_tpu.models import GPTConfig
from hetu_tpu.models import gpt_decode as jgd
from hetu_tpu_torch.models import GPTConfig as TGPTConfig
from hetu_tpu_torch.models import gpt_decode as tgd
from hetu_tpu_torch.weights import params_from_numpy

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
L, H, Dh, V, S = 2, 4, 16, 128, 128


def rand_gpt(name="rg", seed=0):
    """Random GPT weights as float64 numpy (the ``_rand_gpt`` recipe of
    tests/test_ragged_kernel.py) with both packages' configs: 2 layers,
    hidden 64, 4 heads, vocab 128, 128 positions."""
    rng = np.random.RandomState(seed)
    hd = H * Dh
    p = {f"{name}_wte_table": rng.randn(V, hd) * 0.05,
         f"{name}_wpe": rng.randn(S, hd) * 0.05,
         f"{name}_ln_f_scale": np.ones(hd),
         f"{name}_ln_f_bias": np.zeros(hd)}
    for i in range(L):
        us = f"{name}_h{i}"
        for w, shp in [("attn_q", (hd, hd)), ("attn_k", (hd, hd)),
                       ("attn_v", (hd, hd)), ("attn_proj", (hd, hd)),
                       ("ffn_wi", (hd, 4 * hd)), ("ffn_wo", (4 * hd, hd))]:
            p[f"{us}_{w}_weight"] = rng.randn(*shp) * 0.05
            p[f"{us}_{w}_bias"] = np.zeros(shp[1])
        for ln in ("ln1", "ln2"):
            p[f"{us}_{ln}_scale"] = np.ones(hd)
            p[f"{us}_{ln}_bias"] = np.zeros(hd)
    kw = dict(vocab_size=V, hidden_size=hd, num_hidden_layers=L,
              num_attention_heads=H, max_position_embeddings=S,
              batch_size=1, seq_len=S, dropout_rate=0.0)
    return p, GPTConfig(**kw), TGPTConfig(**kw)


@pytest.fixture(scope="module")
def model():
    p, jcfg, tcfg = rand_gpt()
    jp = {k: jgd._prep_param(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    return p, jp, tp, jcfg, tcfg


CFG = ("rg", L, H, Dh, S)


def test_prefill_forward_matches_jax(model):
    _, jp, tp, _, _ = model
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, V, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 1], np.int32)
    jl, jk, jv = jgd._prefill_forward(jp, CFG, jnp.asarray(tokens),
                                      jnp.asarray(lens))
    tl, tk, tv = tgd._prefill_forward(
        tp, CFG, torch.from_numpy(tokens).long(), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=0)


def _mixed_wave(seed=2, bs=8, T=4):
    """Four slots over a permuted pool: a 5-token prompt chunk at
    position 3, a decode token at 10, an inert slot, a first decode token
    at 0 — in one Q=8 wave."""
    rng = np.random.RandomState(seed)
    N = 1 + 4 * T
    tables = rng.permutation(np.arange(1, N)).reshape(4, T).astype(np.int32)
    pool = rng.randn(2, L, N, bs, H, Dh).astype(np.float32)
    pos = np.array([3, 10, 0, 0], np.int32)
    q_len = np.array([5, 1, 0, 1], np.int32)
    tokens = np.zeros((4, 8), np.int32)
    for b in range(4):
        tokens[b, :q_len[b]] = rng.randint(0, V, q_len[b])
    fresh = np.array([True, False, False, False])
    return pool, tables, pos, q_len, tokens, fresh


@pytest.mark.parametrize("attn", ["ragged", "masked"])
def test_mixed_step_matches_jax(model, attn):
    """The port's one path against each JAX attention path: the ragged
    kernel (interpret mode off-TPU) and the masked reference with its
    fresh-self softmax."""
    _, jp, tp, _, _ = model
    pool, tables, pos, q_len, tokens, fresh = _mixed_wave()
    jl, jk, jv = jgd._mixed_step(
        jp, CFG, jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        jnp.asarray(pos), jnp.asarray(tokens), jnp.asarray(q_len),
        jnp.asarray(fresh), block_tables=jnp.asarray(tables), attn=attn,
        has_fresh=attn == "masked")
    ck = torch.from_numpy(pool[0].copy())
    cv = torch.from_numpy(pool[1].copy())
    tl = tgd._mixed_step(
        tp, CFG, ck, cv, torch.from_numpy(pos),
        torch.from_numpy(tokens).long(), torch.from_numpy(q_len),
        torch.from_numpy(tables))
    live = np.arange(8)[None, :] < q_len[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=0)
    # the pool writes, scratch block 0 aside
    np.testing.assert_allclose(ck.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(cv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("prefill", ["flash", "scan"])
@pytest.mark.parametrize("eos", [False, True])
def test_generate_fast_greedy_matches_jax(model, prefill, eos):
    """The port's flash prefill against each JAX prefill."""
    p, _, tp, jcfg, tcfg = model
    prompts = np.random.RandomState(3).randint(0, V, (3, 7))
    want = jgd.generate_fast(p, jcfg, prompts, 12, prefill=prefill)
    eos_id = None
    if eos:
        eos_id = int(want[0, 7 + 3])      # a token the greedy run emits
        want = jgd.generate_fast(p, jcfg, prompts, 12, prefill=prefill,
                                 eos_id=eos_id, pad_id=5)
    got = tgd.generate_fast(tp, tcfg, prompts, 12, eos_id=eos_id,
                            pad_id=5, device="cpu")
    assert got.dtype == np.int32 and got.shape == (3, 19)
    np.testing.assert_array_equal(got, want)


def test_generate_fast_sampling_is_seeded(model):
    _, _, tp, _, tcfg = model
    prompts = np.random.RandomState(4).randint(0, V, (2, 5))

    def run(seed):
        return tgd.generate_fast(tp, tcfg, prompts, 16, temperature=0.9,
                                 top_k=8, seed=seed, device="cpu")
    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < V)).all()


def test_weights_bridge_keeps_dtypes():
    src = {"f64": np.arange(4, dtype=np.float64),
           "f32": np.arange(4, dtype=np.float32),
           "bf16": np.asarray(jnp.arange(4, dtype=jnp.bfloat16)),
           "i64": np.arange(4, dtype=np.int64)}
    got = params_from_numpy(src, device="cpu")
    assert set(got) == set(src)
    assert got["f64"].dtype == torch.float32
    assert got["f32"].dtype == torch.float32
    assert got["bf16"].dtype == torch.bfloat16
    assert got["i64"].dtype == torch.int32
    for k, v in got.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(src[k], np.float32))
    cast = params_from_numpy(src, device="cpu", dtype=torch.bfloat16)
    assert cast["f32"].dtype == torch.bfloat16


def test_entry_points_refuse_cpu_unasked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from hetu_tpu_torch.serving import ServingEngine
    p, _, _, _, tcfg = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgd.generate_fast(p, tcfg, [[1, 2, 3]], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(p, tcfg, paged=True, ragged=True)


@pytest.mark.parametrize("val,want", [("mixed", True), ("phase", False)])
def test_resolution_rules(monkeypatch, val, want):
    monkeypatch.setenv("HETU_SERVE_RAGGED", val)
    assert tgd.resolve_serve_ragged() is want
    # an explicit argument wins
    assert tgd.resolve_serve_ragged(not want) is (not want)
    monkeypatch.setenv("HETU_SERVE_RAGGED", "auto")
    assert tgd.resolve_serve_ragged() is torch.cuda.is_available()


def _counting(monkeypatch, name):
    """Replace the core's reference to kernel wrapper ``name`` with one
    that counts its calls."""
    calls = []
    fn = getattr(tgd, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(tgd, name, wrapped)
    return calls


@pytest.mark.parametrize("fast", ["0", "1"])
@pytest.mark.parametrize("entry", ["engine", "generate_fast"])
def test_cores_attend_through_the_kernels(model, monkeypatch, fast,
                                          entry):
    """The JAX package's ``$HETU_SERVE_FAST=0`` picks its masked/scan
    reference; the port has no such path, so the engine calls the
    ragged wrapper once per layer per step and ``generate_fast`` the
    flash wrapper once per layer, whatever the variable says (on a card
    every call is a kernel launch)."""
    from hetu_tpu_torch.serving import Request, ServingEngine
    p, _, _, _, tcfg = model
    monkeypatch.setenv("HETU_SERVE_FAST", fast)
    ragged = _counting(monkeypatch, "ragged_paged_attention")
    flash = _counting(monkeypatch, "flash_attention")
    if entry == "engine":
        eng = ServingEngine(p, tcfg, slots=2, paged=True, kv_block=8,
                            ragged=True, device="cpu")
        eng.run([Request(prompt=[1, 2, 3], max_new_tokens=3),
                 Request(prompt=[4] * 11, max_new_tokens=2)])
        assert len(ragged) == L * eng.steps > 0 and not flash
    else:
        tgd.generate_fast(p, tcfg, [[1, 2, 3]], 4, device="cpu")
        assert len(flash) == L and not ragged


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|hetu_tpu)(\.|\s|$)",
                        re.MULTILINE)


def test_port_sources_import_no_jax():
    files = sorted((REPO / "hetu_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT_RE.finditer(f.read_text())]
    assert not bad, bad


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import hetu_tpu_torch, hetu_tpu_torch.serving.engine\n"
        "import hetu_tpu_torch.kernels.flash_attention\n"
        "import hetu_tpu_torch.kernels.ragged_attention\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'hetu_tpu' or "
        "m.startswith('hetu_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
