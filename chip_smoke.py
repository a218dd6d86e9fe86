#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit.  Phases (any failed check raises; the script exits
non-zero and prints no result line):

1. The card's name and power limit (``nvidia-smi``); both kernels built
   by ``nvcc`` from ``hetu_tpu_torch/kernels/csrc`` (seconds printed).
2. Each kernel against its plain PyTorch version on the card at the main
   path's shapes, f32 and bf16, with the max abs error beside a stated
   tolerance, and CUDA-event times (median of several warm runs) of the
   kernel, its plain version and one PyTorch library call as a
   yardstick (never called by the port), beside the least time the
   card could take for the same work.
3. Offline ``generate_fast`` on GPT-2-small at full width and depth
   (vocab 50257, hidden 768, 12 layers, 12 heads, 1024 positions),
   weights drawn from ``--seed``: 4 prompts x 128 tokens, 32 new tokens,
   greedy, f32 then bf16; the flash kernel launched layers x prefill
   calls times.
4. ``ServingEngine`` on the same model, f32 then bf16, with its auto
   settings (paged block 16, mixed ragged waves), slots 8,
   prefix sharing, prefill chunks of 256: 16 requests of 32-600 prompt
   tokens (four share a 128-token prefix; four are phase 3's prompts),
   64 new tokens each, greedy except four sampled at temperature 0.8,
   top_k 40.  The ragged kernel is launched layers x steps times; the
   f32 engine's greedy tokens for phase 3's prompts equal offline
   ``generate_fast``'s (two different kernels, one answer).

With ``--profile DIR`` the serving run is then repeated under
torch.profiler and its device time by kernel written into DIR.

The line before the last is one JSON object with every kernel's
numbers; the last line is the device record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# flop/s by operand type (f32 on the CUDA cores, bf16 on tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# kernel vs plain version, element by element: |got - want| <= atol +
# rtol * |want|.  Both sides accumulate in f32; in bf16 both round their
# f32 result to bf16, which may land one bf16 ulp (<= 2^-7 of the value)
# apart.  The outputs here are ~0.05-4 in magnitude.
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2.0 ** -12, 2.0 ** -7)}
LSE_TOL = 1e-4          # the f32 logsumexp, both dtypes


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- #
# timing
# ---------------------------------------------------------------- #


def time_ms(torch, fn, reps=20, warm=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after ``warm``
    warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(got, want, dtype):
    """(max abs error, True when every element is within TOL[dtype])."""
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(got.isfinite().all()
              and (diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------- #


def k1_case(torch, dtype, seed):
    """A mixed wave of 8 slots at GPT-2-small head shapes: q_len in
    {0, 1, 5, 256}, lengths up to 1024, slots 1 and 6 sharing their
    first 8 pool blocks, slot 3 of length 0."""
    H, Dh, bs, T = 12, 64, 16, 64
    lengths = np.array([1024, 600, 37, 0, 1, 300, 512, 129], np.int32)
    q_lens = np.array([256, 1, 5, 0, 1, 256, 1, 5], np.int32)
    B, Q = len(lengths), 256
    rng = np.random.default_rng(seed)
    n_blocks = 1 + int(sum(-(-int(n) // bs) for n in lengths))
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // bs)):
            tables[b, j] = free.pop()
    tables[6, :8] = tables[1, :8]              # a shared prefix
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    pool_k = torch.randn((n_blocks, bs, H, Dh), generator=g,
                         device="cuda").to(dt)
    pool_v = torch.randn((n_blocks, bs, H, Dh), generator=g,
                         device="cuda").to(dt)
    q = torch.randn((B, Q, H, Dh), generator=g, device="cuda").to(dt)
    dev = {n: torch.from_numpy(a).cuda() for n, a in
           (("lengths", lengths), ("q_lens", q_lens), ("tables", tables))}
    # bytes the function must move: q of the slots with a length (a
    # length-0 slot outputs zeros unread), o in full, each pool row some
    # slot's length reaches once (shared rows once), the table entries
    # of those blocks, lengths and q_lens
    es = q.element_size()
    live = lengths > 0
    rows = {(int(tables[b, p // bs]), p % bs) for b in range(B)
            for p in range(int(lengths[b]))}
    n_tab = int(sum(-(-int(n) // bs) for n in lengths))
    nbytes = (int(live.sum()) * Q * H * Dh * es + q.numel() * es
              + 2 * len(rows) * H * Dh * es
              + 4 * n_tab + lengths.nbytes + q_lens.nbytes)
    flops = 0
    for b in range(B):
        if lengths[b] == 0:
            continue
        posq = np.clip(lengths[b] - q_lens[b] + np.arange(Q), 0,
                       lengths[b] - 1)
        flops += int(4 * (posq + 1).sum() * H * Dh)
    return dict(q=q, pool_k=pool_k, pool_v=pool_v, lengths=lengths,
                q_lens=q_lens, tables=tables, dev=dev, nbytes=nbytes,
                flops=flops)


def check_k1(torch, F, dtype, seed):
    from hetu_tpu_torch.kernels import ragged_attention as ra
    c = k1_case(torch, dtype, seed)
    d = c["dev"]
    args = (c["q"], c["pool_k"], c["pool_v"], d["lengths"], d["q_lens"],
            d["tables"])
    got = ra.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    want = ra.ragged_paged_reference(*args).to(c["q"].dtype)
    err, ok = compare(got, want, dtype)
    if not ok:
        fail(f"ragged_paged_attention {dtype}: max abs err {err}, past "
             f"atol + rtol*|want| with (atol, rtol) = {TOL[dtype]}")
    if got[3].abs().max() != 0:
        fail("ragged_paged_attention: zero-length slot not zero")
    ms = time_ms(torch, lambda: ra.ragged_paged_attention(*args))
    plain_ms = time_ms(torch, lambda: ra.ragged_paged_reference(*args),
                       reps=5)
    # yardstick: SDPA over the pre-gathered dense view with the
    # equivalent mask (the gather itself excluded)
    B, Q, H, Dh = c["q"].shape
    T, bs = c["tables"].shape[1], c["pool_k"].shape[1]
    idx = d["tables"].long()
    kd = c["pool_k"][idx].reshape(B, T * bs, H, Dh).transpose(1, 2)
    vd = c["pool_v"][idx].reshape(B, T * bs, H, Dh).transpose(1, 2)
    qd = c["q"].transpose(1, 2)
    L, ql = d["lengths"].long(), d["q_lens"].long()
    posq = torch.minimum(torch.clamp(
        (L - ql)[:, None] + torch.arange(Q, device="cuda")[None], min=0),
        torch.clamp(L - 1, min=0)[:, None])
    mask = (torch.arange(T * bs, device="cuda")[None, None, :]
            <= posq[:, :, None])[:, None]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    b_ms, b_by = bound(c["nbytes"], c["flops"], dtype)
    log(f"  K1 ragged_paged_attention {dtype}: max_abs_err {err:.3e} "
        f"(within atol + rtol*|want|, (atol, rtol) = {TOL[dtype]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, SDPA on the pre-gathered view (gather excluded) "
        f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({c['nbytes']} B, {c['flops']} flop)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def check_k2(torch, F, dtype, seed):
    from hetu_tpu_torch.kernels import flash_attention as fa
    N, P, H, D = 8, 512, 12, 64
    kv = np.array([512, 300, 0, 77, 512, 1, 250, 450], np.int32)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((N, P, H, D), generator=g,
                           device="cuda").to(dt) for _ in range(3))
    kv_d = torch.from_numpy(kv).cuda()
    o, lse = fa.flash_fwd(q, k, v, causal=True, kv_lens=kv_d)
    torch.cuda.synchronize()
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True, kv_lens=kv_d)
    err, ok = compare(o, o_r, dtype)
    live = lse_r < 1e29
    lse_err = float((lse - lse_r)[live].abs().max())
    if not ok or lse_err > LSE_TOL \
            or not torch.equal(lse[~live], lse_r[~live]):
        fail(f"flash_attention {dtype}: max abs err {err}, lse err "
             f"{lse_err} ((atol, rtol) {TOL[dtype]}, lse {LSE_TOL})")
    ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                            kv_lens=kv_d))
    plain_ms = time_ms(torch, lambda: fa.flash_fwd_reference(
        q, k, v, causal=True, kv_lens=kv_d), reps=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    # bytes the function must move: q of the prompts with a live key
    # (a kv_lens-0 prompt outputs zeros unread), the kv_lens[b] live K
    # and V rows of each prompt, o and lse in full, kv_lens
    es = q.element_size()
    nbytes = (int((kv > 0).sum()) * P * H * D * es
              + 2 * int(kv.sum()) * H * D * es + q.numel() * es
              + N * H * P * 4 + kv.nbytes)
    rows = np.arange(P)
    flops = int(sum(4 * np.minimum(rows + 1, n).sum() * H * D
                    for n in kv))
    b_ms, b_by = bound(nbytes, flops, dtype)
    log(f"  K2 flash_attention {dtype}: max_abs_err {err:.3e} "
        f"(within atol + rtol*|want|, (atol, rtol) = {TOL[dtype]}; lse "
        f"{lse_err:.3e}, tol {LSE_TOL:g}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA is_causal on [8,12,512,64] "
        f"without the kv_lens mask {lib_ms:.4f} ms; bound {b_ms:.4f} ms "
        f"by {b_by} ({nbytes} B, {flops} flop)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------- #
# phases 3 and 4: the main path
# ---------------------------------------------------------------- #


def gpt2_small_params(cfg, seed, name="gpt"):
    """GPT-2-small weights drawn from ``seed`` (numpy, f32): N(0, 0.02)
    matrices and embeddings, unit LN scales, zero biases."""
    rng = np.random.default_rng(seed)
    hd, V, S = cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings

    def w(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    p = {f"{name}_wte_table": w(V, hd), f"{name}_wpe": w(S, hd, std=0.01),
         f"{name}_ln_f_scale": np.ones(hd, np.float32),
         f"{name}_ln_f_bias": np.zeros(hd, np.float32)}
    for i in range(cfg.num_hidden_layers):
        us = f"{name}_h{i}"
        for wn, shp in [("attn_q", (hd, hd)), ("attn_k", (hd, hd)),
                        ("attn_v", (hd, hd)), ("attn_proj", (hd, hd)),
                        ("ffn_wi", (hd, 4 * hd)), ("ffn_wo", (4 * hd, hd))]:
            p[f"{us}_{wn}_weight"] = w(*shp)
            p[f"{us}_{wn}_bias"] = np.zeros(shp[1], np.float32)
        for ln in ("ln1", "ln2"):
            p[f"{us}_{ln}_scale"] = np.ones(hd, np.float32)
            p[f"{us}_{ln}_bias"] = np.zeros(hd, np.float32)
    return p


def offline(torch, htt, params, cfg, prompts, dtype):
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    dt = getattr(torch, dtype)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = htt.generate_fast(params, cfg, prompts, 32, dtype=dt)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    L = cfg.num_hidden_layers
    if counts["flash_attention"] != L * 1:
        fail(f"offline {dtype}: flash launched "
             f"{counts['flash_attention']} times, want {L} (layers x 1 "
             f"prefill call)")
    if out.shape != (len(prompts), 128 + 32) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all() \
            or not (out[:, :128] == prompts).all():
        fail(f"offline {dtype}: malformed output {out.shape}")
    log(f"  generate_fast {dtype}: 4 x (128 + 32) tokens in {sec:.3f} s; "
        f"launches {counts}")
    return out, counts


def serve(torch, htt, params, cfg, reqs_spec, dtype, prof=None):
    """One engine run over the request set; ``prof`` (a
    torch.profiler.profile) wraps the run alone when given."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.serving import Request
    dt = getattr(torch, dtype)
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=dt,
                            prefix_share=True, prefill_chunk=256)
    if not (eng.paged and eng.kv.block == 16 and eng.ragged):
        fail("the engine's auto settings are not paged-16 / mixed")
    reqs = [Request(prompt=pr, max_new_tokens=64, temperature=t, top_k=k,
                    seed=i, request_id=f"r{i}")
            for i, (pr, t, k) in enumerate(reqs_spec)]
    torch.cuda.synchronize()
    reset_launches()
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = launch_counts()
    L = cfg.num_hidden_layers
    if counts["ragged_paged_attention"] != L * eng.steps:
        fail(f"serve {dtype}: ragged kernel launched "
             f"{counts['ragged_paged_attention']} times, want "
             f"{L} x {eng.steps} steps")
    if len(res) != len(reqs):
        fail(f"serve {dtype}: {len(res)} of {len(reqs)} requests done")
    if eng.kv.prefix_hits < 3:
        fail(f"serve {dtype}: {eng.kv.prefix_hits} prefix hits; the three "
             f"later requests of the shared 128-token prefix should hit")
    for i, (pr, _, _) in enumerate(reqs_spec):
        toks = res[f"r{i}"].tokens
        if len(toks) != len(pr) + 64 or list(toks[:len(pr)]) != list(pr) \
                or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"serve {dtype}: request r{i} malformed")
    gen = sum(r.n_generated for r in res.values())
    ttft = np.array([r.ttft_s for r in res.values()]) * 1e3
    stats = dict(tokens_per_s=gen / sec, seconds=sec, steps=eng.steps,
                 generated=gen, ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p99_ms=float(np.percentile(ttft, 99)),
                 prefix_hits=eng.kv.prefix_hits)
    log(f"  ServingEngine {dtype}: {gen} tokens in {sec:.3f} s = "
        f"{stats['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.1f} ms p99 {stats['ttft_p99_ms']:.1f} "
        f"ms, {eng.steps} steps, prefix hits {eng.kv.prefix_hits}, "
        f"launches {counts}")
    return res, counts, stats


# kernel kinds of the profile, by name, first match wins
KINDS = (("K1 ragged_paged_attention", re.compile("ragged_paged")),
         ("matmul", re.compile("gemm|nvjet|splitK")),
         ("KV writes (index_put)", re.compile("index_elementwise")),
         ("reductions", re.compile("reduce_kernel")),
         ("elementwise", re.compile("elementwise")))


def kind_of(name):
    return next((k for k, rx in KINDS if rx.search(name)), "other")


def profile_serve(torch, htt, params, cfg, spec, out_dir):
    """Where the serving run's device time goes: the phase-4 engine run
    again, f32 and bf16, under torch.profiler; device time by kind and
    by kernel (top 15, and the table in ``out_dir``) and the device's
    busy share of the run's wall time (host tracing overhead inflates
    the wall, so the busy share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for dtype in ("float32", "bfloat16"):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, _, st = serve(torch, htt, params, cfg, spec, dtype, prof=prof)
        # kernel rows only: an operator row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            fail("the profiler recorded no device time")
        rows.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        lines = [f"{'kernel':64s} {'calls':>7s} {'device ms':>11s} share"]
        lines += [f"{e.key[:64]:64s} {e.count:7d} "
                  f"{e.self_device_time_total / 1e3:11.3f} "
                  f"{e.self_device_time_total / 1e6 / busy:6.1%}"
                  for e in rows]
        (out_dir / f"profile_serve_{dtype}.txt").write_text(
            "\n".join(lines) + "\n")
        log(f"  profile {dtype}: device busy {busy:.4f} s of "
            f"{st['seconds']:.4f} s wall ({busy / st['seconds']:.1%}) "
            f"under the profiler")
        kinds = collections.Counter()
        for e in rows:
            kinds[kind_of(e.key)] += e.self_device_time_total / 1e3
        for k, ms in kinds.most_common():
            log(f"    {k}: {ms:.3f} ms ({ms / 1e3 / busy:.1%})")
        log("  top kernels:")
        for line in lines[:16]:
            log("    " + line)


def request_set(prompts, seed, V):
    """16 requests: phase 3's four 128-token prompts (greedy), four that
    share a 128-token prefix, and eight of 32-600 tokens, four of them
    sampled."""
    rng = np.random.default_rng(seed + 7)
    spec = [(list(map(int, p)), 0.0, 0) for p in prompts]
    prefix = rng.integers(0, V, 128).tolist()
    for n in (40, 100, 200, 300):
        spec.append((prefix + rng.integers(0, V, n).tolist(), 0.0, 0))
    for i, n in enumerate((32, 77, 150, 256, 333, 420, 512, 600)):
        t, k = (0.8, 40) if i % 2 else (0.0, 0)
        spec.append((rng.integers(0, V, n).tolist(), t, k))
    return spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="after the checks, profile the serving run and "
                         "write device time by kernel into DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "hetu_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {repo} holds no hetu_tpu_torch package",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import torch.nn.functional as F

    import hetu_tpu_torch as htt
    from hetu_tpu_torch.kernels import _build
    # f32 parity: full-precision matmuls (the JAX package runs f32 at
    # Precision.HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- phase 1 ---- #
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  kernels built (or found built) in "
        f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_ROOT}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- phase 2 ---- #
    log("phase 2: kernels vs plain versions on the card")
    k1 = {dt: check_k1(torch, F, dt, args.seed)
          for dt in ("float32", "bfloat16")}
    k2 = {dt: check_k2(torch, F, dt, args.seed)
          for dt in ("float32", "bfloat16")}

    # ---- phase 3 ---- #
    log("phase 3: offline generate_fast, GPT-2-small")
    cfg = htt.GPTConfig()
    t0 = time.perf_counter()
    params = htt.params_from_numpy(gpt2_small_params(cfg, args.seed))
    log(f"  weights from seed {args.seed} in "
        f"{time.perf_counter() - t0:.2f} s")
    prompts = np.random.default_rng(args.seed + 3).integers(
        0, cfg.vocab_size, (4, 128))
    off_f32, c_off32 = offline(torch, htt, params, cfg, prompts, "float32")
    _, c_off16 = offline(torch, htt, params, cfg, prompts, "bfloat16")

    # ---- phase 4 ---- #
    log("phase 4: ServingEngine, GPT-2-small")
    spec = request_set(prompts, args.seed, cfg.vocab_size)
    res32, c_s32, s32 = serve(torch, htt, params, cfg, spec, "float32")
    for i in range(4):
        got = res32[f"r{i}"].tokens[128:128 + 32]
        if list(got) != list(off_f32[i, 128:]):
            fail(f"f32 engine greedy tokens of r{i} differ from "
                 f"generate_fast: {list(got)} vs {list(off_f32[i, 128:])}")
    log("  f32 engine greedy tokens == generate_fast tokens (4 prompts)")
    res16, c_s16, s16 = serve(torch, htt, params, cfg, spec, "bfloat16")
    agree = [int(np.argmax(np.append(
        res16[f"r{i}"].tokens != res32[f"r{i}"].tokens, True)))
        - len(spec[i][0]) for i in range(len(spec)) if spec[i][1] == 0]
    log(f"  bf16 vs f32 greedy: identical leading generated tokens per "
        f"request {agree} (of 64)")
    log(f"  serving on {card}: f32 {s32['tokens_per_s']:.1f} tok/s, "
        f"TTFT p50 {s32['ttft_p50_ms']:.1f} p99 {s32['ttft_p99_ms']:.1f} "
        f"ms; bf16 {s16['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{s16['ttft_p50_ms']:.1f} p99 {s16['ttft_p99_ms']:.1f} ms")

    src = "hetu_tpu_torch/kernels/csrc/"
    kernels = []
    for dt in ("float32", "bfloat16"):
        launches = (c_s32 if dt == "float32" else c_s16)[
            "ragged_paged_attention"]
        kernels.append(dict(
            name=f"ragged_paged_attention[{dt}]", route="cuda",
            source=src + "ragged_paged.cu",
            replaces="hetu_tpu/kernels/ragged_attention.py:184",
            launches=launches, max_abs_err=k1[dt]["err"],
            ms=k1[dt]["ms"], plain_ms=k1[dt]["plain_ms"],
            bound_ms=k1[dt]["bound_ms"], bound_by=k1[dt]["bound_by"],
            library_ms=k1[dt]["library_ms"]))
    for dt in ("float32", "bfloat16"):
        launches = (c_off32 if dt == "float32" else c_off16)[
            "flash_attention"]
        kernels.append(dict(
            name=f"flash_attention[{dt}]", route="cuda",
            source=src + "flash_fwd.cu",
            replaces="hetu_tpu/kernels/flash_attention.py:173",
            launches=launches, max_abs_err=k2[dt]["err"],
            ms=k2[dt]["ms"], plain_ms=k2[dt]["plain_ms"],
            bound_ms=k2[dt]["bound_ms"], bound_by=k2[dt]["bound_by"],
            library_ms=k2[dt]["library_ms"]))
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    if args.profile:
        log("profile: the serving run under torch.profiler")
        profile_serve(torch, htt, params, cfg, spec, args.profile)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
