#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit.  Phases (any failed check raises; the script exits
non-zero and prints no result line):

1. The card's name and power limit (``nvidia-smi``); every kernel
   library built by ``nvcc`` from ``hetu_tpu_torch/kernels/csrc``, all
   sources at once (seconds printed); one line per instance of the
   kernels on the tensor cores (f32 K2 and K2-carry, f32 K3's two and
   the f32 wide ragged kernel of f32 K1/K8 and of their f32-q int8
   twins (Q > 16, csrc/ragged_tf32.cuh) on mma.sync TF32, three passes;
   bf16 K2 and K2-carry on wgmma fed by TMA from a producer warp, bf16
   K3's two on mma.sync, K1/K8's wide kernel on wgmma and split kernel
   on mma.sync, each over a bf16 and an int8 cache, and K4-K7's split
   kernel on mma.sync, also over an int8 cache), and of the f32 split
   kernel on the CUDA cores (f32 K1 over the pool, f32 K8 over slot
   rows, f32-q K1-int8 over an int8 pool, f32-q K8-int8 over int8 slot
   rows, f32-q K4-int8/K5-int8 over either): registers and spills
   (``ptxas -v``), dynamic shared
   memory, and the HGMMA / HMMA (TF32 among them) / FFMA / UTMALDG
   instructions of its SASS where the toolkit has ``cuobjdump`` (a
   tensor-core instance with no HGMMA or HMMA, an f32 flash or f32 wide
   ragged kernel with no TF32 one, bf16 K2 with no TMA load, the f32
   split kernel with any tensor-core instruction or no FFMA, or an
   instance with a spill, fails); the host time of bf16 K2's three TMA
   tensor maps, encoded on each call.
2. Each kernel against its plain PyTorch version on the card at the main
   path's shapes, f32 and bf16, with the max abs error beside a stated
   tolerance, and CUDA-event times (median of several warm runs) of the
   kernel, its plain version and one PyTorch library call as a
   yardstick (never called by the port), beside the least time the
   card could take for the same work (the flash kernels also timed over
   ten back-to-back calls, the device time once the host runs ahead):
   K1 ragged_paged_attention on a mixed pool wave (Q 256), K2
   flash_attention on 8 prompts, K4/K5 decode over 8 slot rows / pool
   slots, K6/K7 verify over the same slot rows / pool slots (Q 5, q_lens
   {5, 5, 3, 0, 1, 5, 2, 5}), K8 ragged_attention on a contiguous wave
   with a 1024-row prompt q-block; then K1 and K8 on a decode wave (Q 1)
   and a verify wave (Q 8, K6's q_lens) over the same slots (K1 and K8
   also timed ten back to back; the narrow waves of f32 K1, f32 K8 and,
   in phase 7, f32-q K1-int8 and K8-int8 run the split-K CUDA-core
   body, csrc/split_kv_f32.cuh, their mixed waves the TF32 body,
   csrc/ragged_tf32.cuh, whose bound counts 3 x the flops at TF32's
   rate, all held to 1e-5); then f32 K8 equal to f32
   K1 bit for bit on the same decode wave (Q 1) over the pool's slot
   rows and the pool, and f32-q K8-int8 equal to f32-q K1-int8 the same
   way over the pool's int8 encoding; bf16-q K6-int8 equal to
   bf16-q K8-int8 bit for
   bit on the same Q 5 verify wave over the same int8 slot rows; last,
   in both q dtypes at head dims 32, 64 and 128, K5-int8 equal to
   K1-int8 over an int8 pool and K4-int8 to K8-int8 over its slot rows
   on the Q 1 decode wave, bit for bit, each on its split body, and a
   misaligned int8 payload refused with nothing launched.  bf16
   K1 and K8 (csrc/ragged_paged_bf16.cu) round P to bf16 before P V as
   the Pallas body does and their plain
   versions do not: they are held to TOL plus
   ``ragged_attention.ragged_rounding_bound`` (2^-8 sum(p |v_d|) / l of
   the row, one rounding of P), and the largest err / bound is logged;
   so are bf16 K4-K7 (csrc/decode_attention_bf16.cu, the split-K body
   of K1/K8's narrow waves), here and K6/K7 at Q 17 in phase 6.  K4-K7
   are also timed ten back to back and on the device.  f32 K2 (here,
   at phase 8's training shape and as K2-carry in phase 9) runs three
   TF32 passes on the tensor cores and keeps f32's 1e-5; its bound
   counts 3 x its flops at TF32's 495 TFLOP/s (``TF32X3``), and so do
   f32 K3's (phase 8), which runs the same way.
   bf16 K2 (here, at phase 8's training shape and as K2-carry in phase
   9) is held element by element to 2^-7 sum(p |v_d|) / l of its row
   (``bf16_rounding_bound``) + 1e-5, and 2^-7 rel: it rounds P to bf16
   against its running max at each key tile, the plain version against
   the row's final max, so the two P differ by up to 2^-7 p.
3. Offline ``generate_fast`` on GPT-2-small at full width and depth
   (vocab 50257, hidden 768, 12 layers, 12 heads, 1024 positions),
   weights drawn from ``--seed``: 4 prompts x 128 tokens, 32 new tokens,
   greedy, f32 then bf16; the flash kernel launched layers x 1 times,
   the contiguous decode kernel (K4) layers x 31 decode positions.
4. ``ServingEngine`` on the same model, f32 then bf16, with its auto
   settings (paged block 16, mixed ragged waves), slots 8,
   prefix sharing, prefill chunks of 256: 16 requests of 32-600 prompt
   tokens (four share a 128-token prefix; four are phase 3's prompts),
   64 new tokens each, greedy except four sampled at temperature 0.8,
   top_k 40.  The ragged kernel is launched layers x steps times; the
   f32 engine's greedy tokens for phase 3's prompts equal offline
   ``generate_fast``'s (two different kernels, one answer).
5. The same request set, f32 then bf16, through the three other engine
   configurations: contiguous + phase-split; paged 16 + phase-split +
   prefill chunks of 256 + prefix sharing; contiguous + mixed.  Each
   launches exactly layers x decode waves of K4 or K5, layers x flash
   groups of K2, layers x chunk passes of K1, or layers x steps of K8;
   in f32 every greedy request's tokens equal phase 4's.
6. Speculation (``spec=4``, the auto draft of 3 of 12 layers, adaptive k)
   on the same request set through all four configurations, f32 then
   bf16: the phase-split verify waves launch K6 (contiguous) or K7
   (paged) layers x waves times, the mixed waves carry verify rows on
   K8/K1, and the draft launches K4 3 x (k + 1) per wave and K2 3 x per
   admission; in f32 every greedy request's tokens equal phase 4's and
   every sampled request's equal its configuration's phase 4/5 run.
   Then the high-acceptance arm: layers 3-11 output-zeroed, all requests
   greedy, paged phase-split and paged mixed in f32 — tokens equal a
   non-speculative run on those weights, acceptance >= 0.9, fewer waves
   than generated tokens.  Then offline ``generate_fast(spec=4)`` on
   phase 3's prompts equals phase 3's f32 tokens.  Last, speculation
   deeper than the verify kernels' 16 rows: K6/K7 at Q 17 (two 16-row
   groups, two launches) against their plain versions, f32 and bf16;
   GPT-2-small cut to 4 layers, f32, phase-split
   ``ServingEngine(spec=16, spec_adapt=False)`` on the slot rows and on
   the pool, and ``generate_fast(spec=16)``: greedy tokens equal
   ``spec=0``'s, two verify launches per layer per wave.
7. The int8 KV cache (``kv_quant="int8"``).  First the six int8 twins
   (K1-int8, K4-int8 ... K8-int8) at phase 2's shapes, over phase 2's
   f32 K/V encoded by ``quant.kv_encode`` on the card (equal to the CPU
   encoding, payload and scales), q f32 and bf16, held to their plain
   versions with phase 2's tolerances (both sides form the same f32
   product payload x scale; every bf16-q twin, on the tensor cores,
   splits p times the V scale into a bf16 pair before
   P V_int, two products, and hold TOL alone as the Pallas int8 body,
   which never rounds P, does), timed
   beside an SDPA yardstick over the pre-dequantized K/V (the
   dequantization not timed) and a bound from the int8 bytes; K1-int8
   and K8-int8 at their mixed, decode and verify waves, also timed ten
   back to back and on the device.  Then the request set through all
   four engine configurations with an int8 cache, f32 then bf16: each
   int8 twin launched exactly where its float twin was, the float twin
   never; the footprint what the shapes give; every f32 greedy request
   equal to phase 4's or first differing where the exact top-2 logit
   margin is at most twice the int8 logit error
   (``teacher_forced_logits``, the JAX package's gate).  Last
   ``spec=4`` with int8 in all four, whose f32 tokens, greedy and
   sampled, equal the non-speculative int8 run's.

8. Training (``Executor`` over ``GPTForCausalLM``).  8a: K3, the flash
   backward's dK/dV and dQ kernels, against their plain versions on the
   card: f32 and bf16, head dims 32/64/128, causal and not, kv_lens with
   a 0, Sk > S, S not a multiple of the tile; then at the training
   shape (8 x 1024 tokens, 12 heads of 64, causal), timed beside their
   bounds, their plain versions and the backward of
   ``scaled_dot_product_attention(is_causal=True)`` as a yardstick (its
   backend named), with K2 at the same shape.  8b: GPT-2-small at full
   width and depth, B 8, S 1024, AdamW 3e-4 (weight decay 0.01, clip
   1.0), the synthetic task.  First, in f32 from one set of weights on
   one batch, the loss and every gradient through the flash path (K2
   forward, K3 backward) against the unfused path, which runs no kernel:
   the loss within 1e-5 relative, each gradient within 1e-4 of its
   tensor's max |g|.  Then 8 steps, f32 then the bf16 policy: every
   loss finite, the eval loss of the first step's batch lower after the
   steps than before (the optimizer moves), launches exact (K2 12 per
   step and per eval forward, each K3 kernel 12 per step); step ms,
   tokens/s, peak memory.  8c: the
   trained f32 weights through the serving ``teacher_forced_logits`` on
   one 1024-token sequence equal the training model's eval logits of it
   within 1e-4.

9. Context parallelism (``hetu_tpu_torch.parallel``) on a virtual mesh
   of the card.  9a: K2-carry (``flash_attention_carry``, the carried
   flash forward) against its plain version: f32 and bf16, head dims
   32/64/128, causal and not, a carry that is empty, live or mixed row
   by row, S 100 and 40 (1e-5 + 1e-5 rel: the output is f32 for both
   dtypes; bf16 adds K2's rounding bound of P); then at the ring's
   block shape [1, 2048, 12, 64] with a live
   carry, timed beside its bound and its plain version (no single
   PyTorch call computes a carried forward).  9b: ``ring_attention``
   (``impl=None``: the flash path) at cp 4 over B 1, S 8192, 12 heads of
   64, f32 and bf16, causal and not: the forward equal to K2 over the
   whole sequence (f32 2e-5 + 2e-4 rel, bf16 2e-5 + K2's rounding
   bound + one ulp:
   the ring's carry and K2 round P against different maxima), the
   gradients of
   sum(o * g) through K2-carry + K3 equal to autograd through K2 + K3
   over the whole sequence (f32 1e-4 of each tensor's max, bf16 cp
   ulps), exactly cp + cp(cp - 1)/2 = 10 (causal) or cp^2 = 16
   K2-carry launches and as many of each K3 kernel (a rotation above
   the diagonal launches nothing); the ring's forward and forward +
   backward times beside whole-sequence K2 (+ K3) and SDPA, peak
   memory.  9c: ``ulysses_attention`` at cp 4 with the port's
   ``flash_attention`` as ``attn_fn``: within 1e-6 of K2 over the whole
   sequence, with cp K2 launches.

10. MoE serving: the MoE GPT at GPT-2-small width (``MOE``: the
   dense widths, 4 experts of 1536, top-2, capacity factor 2.0, every
   second block routed; random weights from ``--seed`` through
   ``moe_decode.init_moe_params``), on phase 4's request set.
   Offline ``generate_fast`` (f32, launches as phase 3's); the four
   engine configurations in f32 (launches as phases 4-5, every greedy
   request equal to paged-mixed's, phase 3's prompts to
   ``generate_fast``'s); paged-mixed in bf16 under the bf16 margin
   gate (``margin_gate(low="bf16")``: the bf16 teacher-forced pass in
   the place of int8's); ``spec=4`` on paged phase-split (all tokens
   equal the non-speculative run's, ``moe_ffn`` called MoE blocks x
   target calls times: the draft routes nothing); an int8 cache on
   paged-mixed under phase 7's gate through the MoE
   ``teacher_forced_logits``; capacity factor 0.25 (drops > 0); every
   engine's load + drop == routed positions x top_k x MoE blocks on
   every step record; the dense oracle (phase 3's weights through
   ``convert_dense_to_moe``, k = E = 4: teacher-forced logits of 1024
   tokens within 1e-4 of the dense model's).  Then two windows of the
   paged mixed engine, f32 and bf16, under torch.profiler: the device
   ms of the kernels ``moe_ffn`` launches against attention's, and the
   host share; tok/s and TTFT beside phase 4-5's dense runs.

11. The serving fleet (``ServingRouter``): two replicas of phase 4's
   f32 engine (paged 16, mixed waves, 8 slots each, phase 3's weights
   copied onto the card per replica), phase 4's 16 requests.  First a
   plain fleet run: every token equal to phase 4's, each replica's
   launches exactly layers x steps of K1, ``trace --check`` clean; fleet
   tok/s and TTFT p50/p99 beside phase 4's one engine.  11a: a seeded
   ``HETU_CHAOS`` kill of replica 0 mid-run (``FLEET_CHAOS``): every
   request retires exactly once, its tokens (greedy and sampled) equal
   phase 4's, the peer logs ``router_hop`` records, replica 0 restarts,
   ``trace --check`` passes on the run's log.  11b: roles prefill,decode:
   each request prefills on A, its blocks leave at retirement
   (``export_blocks``) and land on B (``import_blocks``), which decodes;
   the exact wire's tokens equal phase 4's, the int8 wire's
   (``HETU_HANDOFF_QUANT=int8``) pass phase 7's margin gate; B's own
   launches (K1, layers x steps) run over the imported blocks; export
   and import ms and bytes for each wire.  11c: ``WeightSyncCoordinator``
   rolls v2 (the weights of ``--seed`` + 1) over both replicas under
   live traffic: each result equals its stamped version's engine, after
   the commit every replica is at v2 and its tokens equal a fresh v2
   engine's, no resident tensor's ``data_ptr()`` changed, swap ms; a
   push with one wrong shape is refused and leaves every replica's
   params' checksum as it was.  11d: pools of ``TIER_POOL_BLOCKS``
   blocks and ``HETU_KV_HOST_BYTES``: the shared 128-token prefix is
   evicted into the host ring (spills >= 1) and fetched back at a later
   admission (a counted fetch), the tokens equal phase 4's.

With ``--profile DIR`` three more training steps of each dtype run under
torch.profiler in phase 8 (``train_gpt.profile_steps``), and after the
checks each serving configuration is run again under it (without and
with speculation, and with an int8 cache); device time by kernel goes
into DIR.

The line before the last is one JSON object with every kernel's
numbers (``dev_ms`` its device time per call under torch.profiler,
without the wrapper's host time, held to half the CUDA-event time of
the call queued behind a sleep kernel at least, or "not measured"); the
last line is the device record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import io
import itertools
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
# the f32 flash kernels (K2, K2-carry and K3's two) run each f32 product
# as three TF32 products on the tensor cores (495 TFLOP/s): their least
# time for the same work counts 3 x the flops at that rate
TF32X3 = (3, 495e12)
# kernel vs plain version, element by element: |got - want| <= atol +
# rtol * |want|.  Both sides accumulate in f32; in bf16 both round their
# f32 result to bf16, which may land one bf16 ulp (<= 2^-7 of the value)
# apart.  The outputs here are ~0.05-4 in magnitude.
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2.0 ** -12, 2.0 ** -7)}
LSE_TOL = 1e-4          # the f32 logsumexp, both dtypes
# The bf16 flash forward (K2, K2-carry) against its plain version: the
# kernel rounds P = exp(s - m) to bf16 against its running max at each
# key tile, the plain version against the row's final max, so each
# element of o may differ by fa.bf16_rounding_bound (2^-7 sum(p |v_d|) /
# l of its row: each rounding is within 2^-8 of p) plus TOL's f32 atol
# (the sums and exp in another order) before its own rounding to bf16,
# one more ulp (rtol 2^-7).  Masks show in the lse (LSE_TOL).  f32 keeps
# TOL.


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


def time_run_ms(torch, fn, n=10, reps=5, warm=2):
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls of ``fn()``, divided by ``n``: the device time of one call
    once the host runs ahead of the card (time_ms, one call between its
    events, also counts the host's launch work when the card waits for
    it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def queued_ms(torch, fn, n=10):
    """The CUDA-event time of one call of ``fn()`` with the host ahead of
    the card: a sleep kernel holds the stream while ``n`` calls are
    queued, each between two events, so each pair times the call's
    kernels and the gaps between them, not the host's launch work;
    the median over the calls."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(int(2e7))
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def device_ms(torch, fn, n=10):
    """The device time of one call of ``fn()``: under torch.profiler over
    ``n`` calls, each kernel's mean time times its launches per call
    (its count over ``n``, at least one), summed over the kernels (host
    time and the gaps between kernels excluded).  A kernel whose count
    is not a multiple of ``n`` lost events in the profiler: the mean of
    the events it kept stands for it, and the loss is logged.  The sum is
    held to the call's CUDA-event time with the host ahead (``queued_ms``,
    the kernels plus their gaps): a window that reads under half of it
    lost events (or recorded no device time at all), is logged with each
    kernel's profiled time per call beside the event time, and is
    profiled again, up to three windows; after three such windows the
    device time is not measured: None, logged, and printed as "not
    measured" (the profiler loses events in long runs on this card; the
    kernel's other times and its checks stand)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    event_ms = queued_ms(torch, fn, n)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kinds = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            if e.count % n:
                log(f"    (the profiler kept {e.count} events of "
                    f"{e.key[:60]} over {n} calls)")
            kinds[e.key] = (e.self_device_time_total / e.count
                            * max(1, round(e.count / n)) / 1e3)
        total = sum(kinds.values())
        if total >= 0.5 * event_ms:
            return total
        log(f"    (the profiler read {total:.4f} ms a call, under half the "
            f"call's CUDA-event time {event_ms:.4f} ms: "
            + ("; ".join(f"{k[:60]} {v:.4f} ms" for k, v in kinds.items())
               or "no device time")
            + "; profiling again)")
    log(f"    (the profiler read under half the CUDA-event time "
        f"{event_ms:.4f} ms in three windows: the device time is not "
        f"measured)")
    return None


def ms_text(x):
    """A time in ms as the logs print it, or "not measured" (None)."""
    return "not measured" if x is None else f"{x:.4f}"


def compare(got, want, dtype):
    """(max abs error, True when every element is within TOL[dtype])."""
    err, _, ok = close(got, want, *TOL[dtype])
    return err, ok


def flash_compare(got, want, q, k, v, dtype, *, causal, kv_lens=None,
                  lse_c=None, rtol=None):
    """compare() for the flash forward (with ``lse_c``, the carried one):
    atol TOL's f32 atol in both dtypes, plus fa.bf16_rounding_bound of
    (q, k, v) in bf16; rtol TOL's (or the given one).  Returns (max abs
    error, the largest error over its bound, ok)."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    atol, rt = TOL["float32"][0], TOL[dtype][1]
    if dtype == "bfloat16":
        atol = atol + fa.bf16_rounding_bound(q, k, v, causal=causal,
                                             kv_lens=kv_lens, lse_c=lse_c)
    return close(got, want, atol, rt if rtol is None else rtol)


def close(got, want, atol, rtol):
    """(max abs error, the largest |got - want| / (atol + rtol * |want|),
    True when every element is finite and within its bound); atol may
    be a tensor of want's shape."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    lim = atol + rtol * want.abs()
    ok = bool(got.isfinite().all() and (diff <= lim).all())
    return float(diff.max()), float((diff / lim).max()), ok


def bound(nbytes, flops, dtype, method=None):
    """(least ms, "bytes" or "operations"): the larger of the bytes at
    HBM_BYTES_S and the flops at the dtype's peak, or with ``method`` =
    (passes, rate) passes x the flops at that rate (the f32 flash
    kernels: ``TF32X3``)."""
    passes, rate = method or (1, PEAK_FLOPS[dtype])
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = passes * flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_method(dtype):
    """The bound's method of the flash kernels (K2, K2-carry, K3) in
    ``dtype``: f32 runs each product as three TF32 products."""
    return TF32X3 if dtype == "float32" else None


# ---------------------------------------------------------------- #
# phase 1: the tensor-core kernels' build report
# ---------------------------------------------------------------- #

# the tensor-core libraries and their kernels (symbol substring, entry
# of the dynamic shared memory query and its arguments after Dh, and a
# regular expression the instances' mangled names must match, one at
# least; the bf16 ragged, decode and verify kernels' query also takes
# the cache, 1 for int8): the f32 flash forward, the f32 wide ragged
# kernel (f32 K1 over the pool, f32 K8 over slot rows, and the f32-q
# int8 twins of both, its own library) and K3's two f32 kernels on TF32,
# then the bf16 kernels (K2 and K2-carry fed by TMA); the split kernel of
# decode_attention_bf16 once for K4/K5 and K4-int8/K5-int8 (DecodeLim),
# once more for K4-int8/K5-int8 alone (int8, "a"), once for K6/K7,
# K6-int8 and K7-int8 (VerifyLim) and once more for K6-int8 alone (int8
# over SlotRows); last the f32 split kernel of the narrow waves, which
# runs on the CUDA cores, once for f32 K1 (TableRows), once for f32 K8
# (SlotRows), once each for f32-q K1-int8 and K8-int8 (its own library),
# once each for f32 K4/K5 (DecodeLim) and K6/K7 (VerifyLim,
# decode_attention) and once each for f32-q K4-int8/K5-int8 (DecodeLim)
# and K6-int8/K7-int8 (VerifyLim, decode_attention_int8): its SASS must
# show FFMA and no HMMA or HGMMA (``FFMA_KERNELS``)
TC_KERNELS = (("flash_fwd", "flash_fwd_f32_kernel",
               "hetu_flash_fwd_smem", (), ""),
              ("ragged_paged", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), "TableRows"),
              ("ragged_paged", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), "SlotRows"),
              ("ragged_paged_int8", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), r"ILi\d+Ea.*TableRows"),
              ("ragged_paged_int8", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), r"ILi\d+Ea.*SlotRows"),
              ("flash_bwd", "flash_bwd_dkv_kernel",
               "hetu_flash_bwd_smem", (1,), ""),
              ("flash_bwd", "flash_bwd_dq_kernel",
               "hetu_flash_bwd_smem", (0,), ""),
              ("flash_fwd_bf16", "flash_fwd_bf16_kernel",
               "hetu_flash_fwd_bf16_smem", (), ""),
              ("flash_bwd_bf16", "flash_bwd_dkv_bf16_kernel",
               "hetu_flash_bwd_bf16_smem", (1,), ""),
              ("flash_bwd_bf16", "flash_bwd_dq_bf16_kernel",
               "hetu_flash_bwd_bf16_smem", (0,), ""),
              ("ragged_paged_bf16", "ragged_wide_kernel",
               "hetu_ragged_bf16_smem", (0,), ""),
              ("ragged_paged_bf16", "split_kv_kernel",
               "hetu_ragged_bf16_smem", (1,), ""),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (), "DecodeLim"),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (), r"ILi\d+Ea.*DecodeLim"),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (), "VerifyLim"),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (),
               r"ILi\d+EaNS_8SlotRows.*VerifyLim"),
              ("ragged_paged", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), "TableRows"),
              ("ragged_paged", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), "SlotRows"),
              ("ragged_paged_int8", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), r"ILi\d+Ea.*TableRows"),
              ("ragged_paged_int8", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), r"ILi\d+Ea.*SlotRows"),
              ("decode_attention", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "DecodeLim"),
              ("decode_attention", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "VerifyLim"),
              ("decode_attention_int8", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "DecodeLim"),
              ("decode_attention_int8", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "VerifyLim"))
# the kernels of TC_KERNELS that run on the CUDA cores, by symbol
FFMA_KERNELS = ("split_kv_f32_kernel",)
# the kernels that must show TF32 HMMA: the f32 flash forward and
# backward, and the f32 wide ragged kernel (f32 K1/K8 and their f32-q
# int8 twins at Q > 16)
TF32_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "ragged_tf32_kernel")
# the kernels that must load by TMA (UTMALDG): bf16 K2 and K2-carry
TMA_KERNELS = ("flash_fwd_bf16_kernel",)


def ptxas_entries(log):
    """{mangled kernel name: (registers, spill stores, spill loads)} from
    an ``nvcc -Xptxas -v`` log."""
    out, name, spills = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + spills
            name = None
    return out


def sass_mma_counts(lib_path):
    """{mangled kernel name: (HMMA, HGMMA, TF32 HMMA, FFMA, UTMALDG
    instruction count)} from ``cuobjdump -sass``, or None where the
    toolkit has no cuobjdump."""
    import os
    import shutil
    cands = [shutil.which("cuobjdump")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(str(Path(os.environ[env]) / "bin" / "cuobjdump"))
    cands.append("/usr/local/cuda/bin/cuobjdump")
    tool = next((c for c in cands if c and Path(c).is_file()), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0, 0, 0]
        elif name and re.search(r"\bUTMALDG\b", line):
            out[name][4] += 1
        elif name and re.search(r"\bHGMMA\b", line):
            out[name][1] += 1
        elif name and re.search(r"\bHMMA\b", line):
            out[name][0] += 1
            out[name][2] += "TF32" in line
        elif name and re.search(r"\bFFMA\b", line):
            out[name][3] += 1
    return {k: tuple(v) for k, v in out.items()}


def tc_report(_build, paths):
    """One line per instance of a tensor-core kernel (f32 K2 and
    K2-carry, the f32 wide ragged kernel of f32 K1/K8 and of their f32-q
    int8 twins and f32 K3's two on TF32, bf16 K2 and K2-carry, bf16 K3's
    two, the wide and split ragged kernels of K1/K8 and of their int8
    twins, the split kernel of K4-K7 and of their int8 twins) and of the
    f32 split kernel of f32 K1, f32 K8, f32 K4-K7 and f32-q K1-int8,
    K8-int8 and K4-int8 to K7-int8 on the CUDA cores: registers and
    spills (ptxas, from this process's build), dynamic shared memory,
    and the HMMA (TF32
    among them) / HGMMA / FFMA / UTMALDG instructions of its SASS; fails
    when a tensor-core instance has no tensor-core instruction, when a
    ``TF32_KERNELS`` instance has no TF32 one, when a ``TMA_KERNELS``
    instance has no TMA load, when a CUDA-core instance
    (``FFMA_KERNELS``) has a tensor-core instruction or no FFMA, when it
    spills, or when a row of ``TC_KERNELS`` has no instance in the
    SASS; then ``no_decode_body`` over every library's SASS."""
    sass = {}
    for lib_name, sym, smem_fn, extra, kind in TC_KERNELS:
        if lib_name not in sass:
            sass[lib_name] = sass_mma_counts(paths[lib_name])
        regs = ptxas_entries(_build.BUILD_LOG.get(lib_name, ""))
        lib = _build.library(lib_name)
        names = sorted(n for n in (sass[lib_name] or regs)
                       if sym in n and re.search(kind, n))
        if sass[lib_name] is not None and not names:
            fail(f"{lib_name}: no {sym} instance {kind} in its SASS")
        for name in names:
            m = re.search(sym + r"ILi(\d+)E(?:Lb([01])E)?", name)
            D = int(m.group(1))
            carry = m.group(2) == "1"
            # the cache element type follows D in the ragged kernels'
            # template arguments: signed char (mangled "a") for int8
            int8 = bool(re.search(sym + r"ILi\d+Ea", name))
            by_cache = lib_name in ("ragged_paged_bf16",
                                    "decode_attention_bf16")
            smem = getattr(lib, smem_fn)(D, *extra,
                                         *((int(int8),) if by_cache else ()))
            what = "".join((", carry" if carry else "",
                            ", decode" if "DecodeLim" in name else "",
                            ", verify" if "VerifyLim" in name else "",
                            ", int8" if int8 else "",
                            ", pool" if "TableRows" in name else "",
                            ", slots" if "SlotRows" in name else ""))
            r = regs.get(name)
            ptx = (f"{r[0]} registers, spill stores {r[1]} B, loads {r[2]} B"
                   if r else "not rebuilt in this process")
            mma = sass[lib_name]
            count = (f"HMMA {mma[name][0]} (TF32 {mma[name][2]}), HGMMA "
                     f"{mma[name][1]}, FFMA {mma[name][3]}, UTMALDG "
                     f"{mma[name][4]}"
                     if mma is not None else "no cuobjdump")
            ffma = sym in FFMA_KERNELS
            log(f"  {'CUDA' if ffma else 'tensor'} cores: {sym}<D {D}"
                f"{what}>: {ptx}, dynamic shared {smem} B; SASS {count}")
            if mma is not None and ffma and (mma[name][0] + mma[name][1]
                                             or not mma[name][3]):
                fail(f"{name} is not FFMA-only: {count}")
            if mma is not None and not ffma and mma[name][0] + mma[name][1] \
                    == 0:
                fail(f"{name} has no HMMA or HGMMA instruction")
            if mma is not None and sym in TF32_KERNELS \
                    and mma[name][2] == 0:
                fail(f"{name} has no TF32 HMMA instruction")
            if mma is not None and sym in TMA_KERNELS and mma[name][4] == 0:
                fail(f"{name} has no TMA load (UTMALDG)")
            if r and (r[1] or r[2]):
                fail(f"{name} spills: {r[1]} B stores, {r[2]} B loads")
    for lib_name in paths:
        if lib_name not in sass:
            sass[lib_name] = sass_mma_counts(paths[lib_name])
    no_decode_body(sass)


def no_decode_body(sass):
    """Every decode and verify kernel runs a split-K body: fails if the
    SASS of any library (``sass``: library -> ``sass_mma_counts``) holds
    an instance of the retired one-block-per-slot body,
    ``decode_kernel``."""
    if any(v is None for v in sass.values()):
        log("  decode_kernel instances: no cuobjdump")
        return
    found = sorted(f"{lib}: {n}" for lib, names in sass.items()
                   for n in names if "decode_kernel" in n)
    if found:
        fail(f"decode_kernel instances in the SASS: {found}")
    log(f"  decode_kernel instances: none in the {len(sass)} libraries")


def tma_map_us(_build, n=1000):
    """The host time of the three tensor maps bf16 K2 and K2-carry build
    on each call (``hetu_flash_fwd_bf16_map_us``: cuTensorMapEncodeTiled
    at the training shape over a device buffer, which it does not read;
    mean of ``n``), in microseconds; fails if the driver refuses them."""
    import ctypes

    import torch
    fn = _build.library("flash_fwd_bf16").hetu_flash_fwd_bf16_map_us
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_double
    buf = torch.empty(16, dtype=torch.bfloat16, device="cuda")
    us = fn(buf.data_ptr(), n)
    if us < 0:
        fail("cuTensorMapEncodeTiled refused bf16 K2's tensor maps")
    return us


# ---------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------- #

# main-path head shapes (GPT-2-small), pool block and table width, and
# the slot lengths of the 8-slot waves below: a full row, a long prompt,
# short ones, a length-0 slot and a single position
H, DH, BS, T_WIDTH = 12, 64, 16, 64
LENGTHS = np.array([1024, 600, 37, 0, 1, 300, 512, 129], np.int32)
# the 8 slots of a decode wave at short lengths, each within one
# 128-position split (the split body's fixed cost and its merge's
# launch weigh most there), slot 3 again of length 0
SHORT_LENGTHS = np.array([127, 64, 37, 0, 1, 100, 128, 16], np.int32)


def pool_case(torch, dtype, seed, Dh=DH, lengths=LENGTHS):
    """The 8 slots of ``lengths`` in a permuted block pool [N, 16, 12,
    Dh], slots 1 and 6 sharing their first blocks, up to 8 (a prefix of
    up to 128 positions); dead table entries at scratch block 0.
    Returns the pools, the host tables and the count of distinct pool
    rows some slot's length reaches (each read once: a shared row
    once)."""
    B = len(lengths)
    rng = np.random.default_rng(seed)
    need = [-(-int(n) // BS) for n in lengths]
    n_blocks = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((B, T_WIDTH), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    shared = min(8, need[1], need[6])
    tables[6, :shared] = tables[1, :shared]    # a shared prefix
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    pool_k, pool_v = (torch.randn((n_blocks, BS, H, Dh), generator=g,
                                  device="cuda").to(dt) for _ in range(2))
    rows = {(int(tables[b, p // BS]), p % BS) for b in range(B)
            for p in range(int(lengths[b]))}
    return pool_k, pool_v, tables, len(rows)


def slot_rows_case(torch, dtype, seed):
    """Slot-contiguous caches [8, 1024, 12, 64] of random K/V."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn((len(LENGTHS), 1024, H, DH), generator=g,
                             device="cuda").to(dt) for _ in range(2))


def ragged_flops(lengths, q_lens, Q):
    """Score and PV flops of a ragged wave: every row of every slot with
    a length, dead rows at their clipped positions."""
    flops = 0
    for n, ql in zip(lengths, q_lens):
        if n == 0:
            continue
        posq = np.clip(n - ql + np.arange(Q), 0, n - 1)
        flops += int(4 * (posq + 1).sum() * H * DH)
    return flops


def length_mask(torch, lengths, q_lens, Q, span):
    """[B, 1, Q, span] bool: the ragged kernels' live keys per row (a
    length-0 slot keeps position 0, so the yardstick's softmax has a
    key), for the SDPA yardstick."""
    L = torch.from_numpy(lengths).cuda().long()
    ql = torch.from_numpy(q_lens).cuda().long()
    posq = torch.minimum(torch.clamp(
        (L - ql)[:, None] + torch.arange(Q, device="cuda")[None], min=0),
        torch.clamp(L - 1, min=0)[:, None])
    return (torch.arange(span, device="cuda")[None, None, :]
            <= posq[:, :, None])[:, None]


def int8_kv(torch, k, v):
    """Phase 2's f32 K/V encoded on the card by ``quant.kv_encode``, held
    to the CPU encoding exactly (payload and scales): ((k payload, k
    scales), (v payload, v scales))."""
    from hetu_tpu_torch.quant import kv_encode
    out = []
    for x in (k, v):
        q, s = kv_encode(x)
        qc, sc = kv_encode(x.cpu())
        if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
            fail("kv_encode on the card differs from the CPU encoding")
        out.append((q, s))
    return out


def kv_operands(torch, k, v, dtype, int8):
    """A float K/V pair of ``dtype`` or, with ``int8``, its encoding:
    (k, v), the wrapper's keyword scales, the plain version's trailing
    scale arguments, the dense (dequantized) K/V for the SDPA yardstick
    (the dequantization not timed), and the bytes one (position, head)
    row of K and V takes."""
    dt = getattr(torch, dtype)
    if not int8:
        k, v = k.to(dt), v.to(dt)
        return (k, v), {}, (), (k, v), 2 * DH * k.element_size()
    from hetu_tpu_torch.quant import kv_decode
    (kq, ks), (vq, vs) = int8_kv(torch, k, v)
    dense = (kv_decode(kq, ks).to(dt), kv_decode(vq, vs).to(dt))
    return ((kq, vq), dict(k_scale=ks, v_scale=vs), (ks, vs), dense,
            2 * (DH + 4))


def measure(torch, label, dtype, run, plain, library, nbytes, flops,
            dead=3, rounding=None, b2b=False, method=None):
    """Hold ``run()`` (the kernel) to ``plain()`` element by element,
    check that slot ``dead`` (length 0) is zero, and time the kernel,
    its plain version and the ``library()`` yardstick beside the
    bound.  ``rounding()`` (bf16 only) adds the per-element bound of a
    rounding of P the plain version does not make to TOL's atol, and
    the largest err / (atol + rtol*|want|) is logged; ``b2b`` also
    times ten back-to-back kernel calls (``run_ms``) and the kernels'
    device time per call (``dev_ms``, ``device_ms``); ``method`` is the
    bound's (``bound``: ``TF32X3`` for a kernel on three TF32 passes)."""
    got = run()
    torch.cuda.synchronize()
    want = plain().to(got.dtype)
    atol, rtol = TOL[dtype]
    with_bound = rounding is not None and dtype == "bfloat16"
    if with_bound:
        atol = atol + rounding()
    err, ratio, ok = close(got, want, atol, rtol)
    tol = (f"atol + rtol*|want|, (atol, rtol) = {TOL[dtype]}"
           + (" + ragged_rounding_bound" if with_bound else ""))
    if not ok:
        fail(f"{label} {dtype}: max abs err {err}, largest err / bound "
             f"{ratio}, past {tol}")
    if got[dead].abs().max() != 0:
        fail(f"{label}: zero-length slot not zero")
    ms = time_ms(torch, run)
    run_ms = time_run_ms(torch, run) if b2b else None
    dev = device_ms(torch, run) if b2b else None
    plain_ms = time_ms(torch, plain, reps=5)
    lib_ms = time_ms(torch, library)
    b_ms, b_by = bound(nbytes, flops, dtype, method)
    log(f"  {label} {dtype}: max_abs_err {err:.3e}, largest err / bound "
        f"{ratio:.4f} (within {tol}); kernel {ms:.4f} ms"
        + (f" ({run_ms:.4f} back to back, {ms_text(dev)} on the device)"
           if b2b else "")
        + f", plain {plain_ms:.4f} ms, SDPA yardstick {lib_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop"
        f"{', 3 TF32 passes' if method == TF32X3 else ''})")
    return dict(err=err, ratio=ratio, ms=ms, run_ms=run_ms, dev_ms=dev,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


# the verify wave of phase 2: Q = spec 4 + 1, each slot's live rows
VERIFY_QLENS = np.array([5, 5, 3, 0, 1, 5, 2, 5], np.int32)
# K1's and K8's waves over the 8 slots of LENGTHS, (Q, q_lens): their
# mixed waves (K1: prompt chunks of 256 beside decode and verify rows;
# K8: a 600-token prompt at its pow2 bucket 1024), and for both a
# decode wave (Q 1, q_len 1 on every slot with a length: most of a
# serving run's waves) and a verify wave (Q 8, the pow2 bucket of
# VERIFY_QLENS, spec 4)
MIXED_WAVES = {"K1": (256, np.array([256, 1, 5, 0, 1, 256, 1, 5], np.int32)),
               "K8": (1024, np.array([1, 600, 1, 0, 1, 300, 1, 1], np.int32))}
NARROW_WAVES = {"decode": (1, (LENGTHS > 0).astype(np.int32)),
                "verify": (8, VERIFY_QLENS)}


# bf16 q over an int8 cache rounds p times the V scale to bf16 once
# (the kernels before the split of that product, as kernel_times.py
# meets them in an older checkout): bf16 K1-int8/K8-int8 are then held
# to TOL plus ragged_rounding_bound of the dequantized cache; this
# checkout's kernels hold TOL alone
INT8_ROUNDS_P = False


def int8_rounding(int8, bound):
    """The ``rounding`` of ``measure`` for bf16 K1/K8 and their int8
    twins: ``bound`` over a bf16 cache, none over an int8 one (unless
    ``INT8_ROUNDS_P``)."""
    return bound if not int8 or INT8_ROUNDS_P else None


def ragged_method(dtype, wave):
    """The bound's method of K1/K8 and their int8 twins on ``wave``: f32
    q's mixed waves (Q > 16) run three TF32 passes (``TF32X3``), the
    narrow ones and bf16 q one pass."""
    return TF32X3 if dtype == "float32" and wave == "mixed" else None


def wave_of(kernel, wave):
    """(Q, q_lens, label suffix) of ``kernel``'s wave ``wave``: "mixed",
    or one of ``NARROW_WAVES``."""
    if wave == "mixed":
        return (*MIXED_WAVES[kernel], "")
    Q, q_lens = NARROW_WAVES[wave]
    return Q, q_lens, f" {wave} Q {Q}"


def check_k1(torch, F, dtype, seed, int8=False, wave="mixed"):
    """K1 on a wave of the 8 pool slots (``wave_of``: the mixed
    wave has q_len in {0, 1, 5, 256}, Q 256); with ``int8`` K1-int8 over
    the f32 pool's encoding, q of ``dtype``.  bf16 over a bf16 pool adds
    ``ragged_rounding_bound`` to TOL (the kernel rounds P, as the Pallas
    body does there); over an int8 pool TOL alone (neither rounds P).  Yardstick: SDPA over the pre-gathered dense (with ``int8``,
    dequantized) view with the equivalent mask (the gather itself
    excluded)."""
    from hetu_tpu_torch.kernels import ragged_attention as ra
    pool_k, pool_v, tables, n_rows = pool_case(
        torch, "float32" if int8 else dtype, seed)
    (pool_k, pool_v), sc, sc_plain, dense, row_bytes = kv_operands(
        torch, pool_k, pool_v, dtype, int8)
    Q, q_lens, suffix = wave_of("K1", wave)
    B = len(LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    q = torch.randn((B, Q, H, DH), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    args = (q, pool_k, pool_v, torch.from_numpy(LENGTHS).cuda(),
            torch.from_numpy(q_lens).cuda(), torch.from_numpy(tables).cuda())
    idx = args[5].long()
    span = T_WIDTH * BS
    kd, vd = (x[idx].reshape(B, span, H, DH).transpose(1, 2)
              for x in dense)
    qd = q.transpose(1, 2)
    mask = length_mask(torch, LENGTHS, q_lens, Q, span)
    # bytes the function must move: q of the slots with a length (a
    # length-0 slot outputs zeros unread), o in full, each pool row some
    # slot's length reaches once (with int8 its scales too), the table
    # entries of those blocks, lengths and q_lens
    es = q.element_size()
    n_tab = int(sum(-(-int(n) // BS) for n in LENGTHS))
    nbytes = (int((LENGTHS > 0).sum()) * Q * H * DH * es + q.numel() * es
              + n_rows * H * row_bytes + 4 * n_tab + LENGTHS.nbytes
              + q_lens.nbytes)
    return measure(
        torch, f"K1{'-int8' if int8 else ''} ragged_paged_attention{suffix}",
        dtype, lambda: ra.ragged_paged_attention(*args, **sc),
        lambda: ra.ragged_paged_reference(*args, *sc_plain),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
        nbytes, ragged_flops(LENGTHS, q_lens, Q)
        + (2 * n_rows * H * DH if int8 else 0),
        rounding=int8_rounding(
            int8, lambda: ra.ragged_rounding_bound(*args, **sc)),
        b2b=True, method=ragged_method(dtype, wave))


def check_k8(torch, F, dtype, seed, int8=False, wave="mixed"):
    """K8 on a wave of the 8 slot rows (``wave_of``: the mixed wave
    has a wide prompt q-block, a 600-token prompt at Q 1024, its pow2
    bucket, a 300-token prompt, decode tokens, a length-0 slot); with
    ``int8`` K8-int8 over the f32 rows' encoding; bf16 over bf16 rows
    within TOL plus ``ragged_rounding_bound``, over int8 rows within TOL
    alone, as ``check_k1``.  Yardstick: SDPA over
    the (dequantized) slot rows with the equivalent mask."""
    from hetu_tpu_torch.kernels import ragged_attention as ra
    k, v = slot_rows_case(torch, "float32" if int8 else dtype, seed + 7)
    (k, v), sc, sc_plain, dense, row_bytes = kv_operands(torch, k, v,
                                                         dtype, int8)
    Q, q_lens, suffix = wave_of("K8", wave)
    B = len(LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    q = torch.randn((B, Q, H, DH), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    args = (q, k, v, torch.from_numpy(LENGTHS).cuda(),
            torch.from_numpy(q_lens).cuda())
    qd, kd, vd = (x.transpose(1, 2) for x in (q, *dense))
    mask = length_mask(torch, LENGTHS, q_lens, Q, k.shape[1])
    es = q.element_size()
    nbytes = (int((LENGTHS > 0).sum()) * Q * H * DH * es + q.numel() * es
              + int(LENGTHS.sum()) * H * row_bytes + LENGTHS.nbytes
              + q_lens.nbytes)
    r = measure(
        torch, f"K8{'-int8' if int8 else ''} ragged_attention{suffix}",
        dtype, lambda: ra.ragged_attention(*args, **sc),
        lambda: ra.ragged_masked_reference(*args, *sc_plain),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
        nbytes, ragged_flops(LENGTHS, q_lens, Q)
        + (2 * int(LENGTHS.sum()) * H * DH if int8 else 0),
        rounding=int8_rounding(
            int8, lambda: ra.ragged_rounding_bound(*args, **sc)),
        b2b=True, method=ragged_method(dtype, wave))
    if int8 or wave != "mixed":
        return r
    # the dead-row cost: the same slots with no dead row, each prompt
    # slot launched at Q = its q_len and the decode slots at Q = 1
    waves = []
    for rows, width in (([1], 600), ([5], 300), ([0, 2, 4, 6, 7], 1)):
        idx = torch.tensor(rows, device="cuda")
        waves.append((q[idx, :width].contiguous(), k[idx].contiguous(),
                      v[idx].contiguous(), args[3][idx].contiguous(),
                      args[4][idx].contiguous()))
    live_ms = device_ms(torch, lambda: [ra.ragged_attention(*w)
                                        for w in waves])
    if live_ms is not None and r["dev_ms"] is not None:
        log(f"  K8 {dtype}: the same slots without dead rows (three "
            f"launches at Q = 600, 300, 1) {live_ms:.4f} ms on the device "
            f"against {r['dev_ms']:.4f} ms for the Q 1024 wave: dead rows "
            f"take {1 - live_ms / r['dev_ms']:.1%} of the wave's device "
            f"time")
    return r


def check_decode(torch, F, dtype, seed, paged, verify=False, int8=False,
                 lengths=None):
    """The 8 slots of ``LENGTHS`` (or ``lengths``, a decode wave's:
    ``SHORT_LENGTHS``) through the tables of the pool (K5, or with
    ``verify`` K7), else over slot rows (K4, or K6): one query per slot,
    or with ``verify`` a Q-5 verify block of q_lens ``VERIFY_QLENS``
    (dead rows included in the comparison); with ``int8`` the int8 twin
    over the f32 K/V's encoding, q of ``dtype``.
    bf16 K4-K7 over a bf16 cache add ``ragged_rounding_bound`` to TOL
    (they round P as bf16 K1/K8 do); every kernel is also timed back to
    back and on the device.  Yardstick: SDPA with a per-query length
    mask over the pre-gathered (dequantized) view (the gather excluded)
    or the slot rows."""
    from hetu_tpu_torch.kernels import decode_attention as da
    short = lengths is not None
    L = lengths if short else LENGTHS
    B = len(L)
    q_lens = VERIFY_QLENS if verify else np.ones(B, np.int32)
    Q = int(q_lens.max())
    seed += 3 if verify else 0
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Q, H, DH), generator=g, device="cuda").to(dt)
    if not verify:
        q = q[:, 0]
    lens = torch.from_numpy(L).cuda()
    extra = (torch.from_numpy(q_lens).cuda(),) if verify else ()
    es = q.element_size()
    kv_dtype = "float32" if int8 else dtype
    if paged:
        pool_k, pool_v, tables, n_rows = pool_case(torch, kv_dtype,
                                                   seed + 10, lengths=L)
        (pool_k, pool_v), sc, sc_plain, dense, row_bytes = kv_operands(
            torch, pool_k, pool_v, dtype, int8)
        tab = torch.from_numpy(tables).cuda()
        args = (q, pool_k, pool_v, lens) + extra + (tab,)
        kd, vd = (x[tab.long()].reshape(B, T_WIDTH * BS, H, DH)
                  for x in dense)
        n_tab = int(sum(-(-int(n) // BS) for n in L))
        kv_bytes = n_rows * H * row_bytes + 4 * n_tab
        label, run, plain = (
            ("K7 paged_block_verify_attention",
             da.paged_block_verify_attention,
             da.paged_block_verify_reference) if verify else
            ("K5 paged_block_decode_attention",
             da.paged_block_decode_attention,
             da.paged_block_decode_reference))
    else:
        n_rows = int(L.sum())
        k, v = slot_rows_case(torch, kv_dtype, seed + 11)
        (k, v), sc, sc_plain, (kd, vd), row_bytes = kv_operands(
            torch, k, v, dtype, int8)
        args = (q, k, v, lens) + extra
        kv_bytes = n_rows * H * row_bytes
        label, run, plain = (
            ("K6 paged_verify_attention", da.paged_verify_attention,
             da.masked_verify_reference) if verify else
            ("K4 paged_decode_attention", da.paged_decode_attention,
             da.masked_decode_reference))
    qd = (q if verify else q[:, None]).transpose(1, 2)
    kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
    mask = length_mask(torch, L, q_lens, Q, kd.shape[1])
    # q of the slots with a length (a length-0 slot outputs zeros
    # unread), o in full, the K/V rows up to each slot's length once (a
    # shared pool row once, plus the table entries of those blocks),
    # lengths and the verify block's q_lens
    nbytes = (int((L > 0).sum()) * Q * H * DH * es + q.numel() * es
              + kv_bytes + L.nbytes + (q_lens.nbytes if verify else 0))
    if int8:
        label = label.replace(" ", "-int8 ", 1)
    if short:
        label += " short"
    from hetu_tpu_torch.kernels import ragged_attention as ra

    def rounding():
        """``ragged_rounding_bound`` of the call (a decode call as a
        ragged wave of one row)."""
        if verify:
            return ra.ragged_rounding_bound(*args)
        return ra.ragged_rounding_bound(q[:, None], *args[1:4],
                                        torch.ones_like(lens),
                                        *args[4:])[:, 0]
    return measure(
        torch, label, dtype, lambda: run(*args, **sc),
        lambda: plain(*args, *sc_plain),
        lambda: F.scaled_dot_product_attention(qd, kt, vt, attn_mask=mask),
        nbytes, ragged_flops(L, q_lens, Q)
        + (2 * n_rows * H * DH if int8 else 0),
        rounding=None if int8 else rounding, b2b=True)


def check_k8_equals_k1(torch, seed, int8=False):
    """f32 K8 (``ragged_attention`` over slot rows) and f32 K1
    (``ragged_paged_attention`` through the tables) on phase 2's decode
    wave (Q 1) over the same K/V: the pool of ``pool_case`` and its slot
    rows gathered through the tables; with ``int8`` f32-q K8-int8 and
    f32-q K1-int8 over the pool's encoding on the card (payload and
    scales gathered alike).  One split body, one row limit, one split
    order (the span of both is 1024 positions), only the row addresses
    differ, so the outputs are equal bit for bit."""
    from hetu_tpu_torch.kernels import ragged_attention as ra
    pool_k, pool_v, tables, _ = pool_case(torch, "float32", seed + 13)
    Q, q_lens = NARROW_WAVES["decode"]
    B, span = len(LENGTHS), T_WIDTH * BS
    lens, ql, tab = (torch.from_numpy(x).cuda()
                     for x in (LENGTHS, q_lens, tables))
    pools, sc = (pool_k, pool_v), {}
    if int8:
        (kq, ks), (vq, vs) = int8_kv(torch, pool_k, pool_v)
        pools, sc = (kq, vq), dict(k_scale=ks, v_scale=vs)

    def rows(x):
        """The slot rows of pool ``x`` (or of its scale plane)."""
        return x[tab.long()].reshape(B, span, *x.shape[2:]).contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    q = torch.randn((B, Q, H, DH), generator=g, device="cuda")
    k1 = ra.ragged_paged_attention(q, *pools, lens, ql, tab, **sc)
    k8 = ra.ragged_attention(q, *(rows(x) for x in pools), lens, ql,
                             **{n: rows(x) for n, x in sc.items()})
    torch.cuda.synchronize()
    what = "-int8" if int8 else ""
    if not torch.equal(k1, k8):
        fail(f"f32 K8{what} differs from f32 K1{what} on the same decode "
             f"wave: max abs diff {float((k1 - k8).abs().max())}")
    log(f"  K8{what} ragged_attention float32 == K1{what} "
        f"ragged_paged_attention float32 on the Q 1 decode wave over the "
        f"same {'int8 ' if int8 else ''}K/V (slot rows, pool), bit for bit")


def off16(torch, t, nbytes=8):
    """A copy of ``t`` on the card whose data starts ``nbytes`` past a
    16-byte boundary (contiguous)."""
    n = nbytes // t.element_size()
    out = torch.zeros(t.numel() + n, dtype=t.dtype,
                      device="cuda")[n:].view(t.shape)
    out.copy_(t)
    return out


def check_decode_equals_ragged(torch, seed):
    """K4/K5 on their split bodies wherever they take f32 q or an int8
    cache, head dim 32, 64 and 128: f32 K4/K5 (f32 q over an f32 cache)
    and K4-int8/K5-int8 (f32 and bf16 q over an int8 cache), over the 8
    slots of ``LENGTHS`` in the f32 pool of ``pool_case`` (or its
    encoding on the card) and its slot rows gathered through the tables.
    K5 (``paged_block_decode_attention``) equals K1
    (``ragged_paged_attention``) on phase 2's decode wave (Q 1) over the
    pool, and K4 (``paged_decode_attention``) equals K8
    (``ragged_attention``) over the slot rows, bit for bit, and so do
    their int8 twins: one split body, row limits that agree at q_len 1
    (DecodeLim is RaggedLim there), one split order.  Each decode call
    counts one launch under its name (``_int8``); a cache or payload 8
    bytes off a 16-byte boundary is refused with nothing launched."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.kernels import ragged_attention as ra
    Q, q_lens = NARROW_WAVES["decode"]
    B, span = len(LENGTHS), T_WIDTH * BS
    lens, ql = (torch.from_numpy(x).cuda() for x in (LENGTHS, q_lens))
    for dtype, cache in (("float32", "float"), ("float32", "int8"),
                         ("bfloat16", "int8")):
        what = "-int8" if cache == "int8" else ""
        sfx = what.replace("-", "_")
        for Dh in (32, 64, 128):
            pool_k, pool_v, tables, _ = pool_case(torch, "float32",
                                                  seed + 15 + Dh, Dh=Dh)
            tab = torch.from_numpy(tables).cuda()
            pools, sc = (pool_k, pool_v), {}
            if cache == "int8":
                (kq, ks), (vq, vs) = int8_kv(torch, pool_k, pool_v)
                pools, sc = (kq, vq), dict(k_scale=ks, v_scale=vs)

            def rows(x):
                """The slot rows of pool ``x`` (or of its scale plane)."""
                return x[tab.long()].reshape(B, span, *x.shape[2:]) \
                    .contiguous()
            slots = tuple(rows(x) for x in pools)
            g = torch.Generator(device="cuda").manual_seed(seed + 16 + Dh)
            q = torch.randn((B, Q, H, Dh), generator=g, device="cuda").to(
                getattr(torch, dtype))
            rsc = {n: rows(x) for n, x in sc.items()}
            reset_launches()
            k5 = da.paged_block_decode_attention(q[:, 0], *pools, lens, tab,
                                                 **sc)
            k4 = da.paged_decode_attention(q[:, 0], *slots, lens, **rsc)
            torch.cuda.synchronize()
            counts = {k: n for k, n in launch_counts().items() if n}
            want = {f"paged_block_decode_attention{sfx}": 1,
                    f"paged_decode_attention{sfx}": 1}
            if counts != want:
                fail(f"{dtype} K4{what}/K5{what} launches {counts}, not "
                     f"{want}")
            k1 = ra.ragged_paged_attention(q, *pools, lens, ql, tab, **sc)
            k8 = ra.ragged_attention(q, *slots, lens, ql, **rsc)
            torch.cuda.synchronize()
            for got, ref, pair in ((k5, k1[:, 0], f"K5{what} vs K1{what}"),
                                   (k4, k8[:, 0], f"K4{what} vs K8{what}")):
                if not torch.equal(got, ref):
                    diff = float((got.float() - ref.float()).abs().max())
                    fail(f"{dtype} {pair} at Dh {Dh} on the Q 1 decode "
                         f"wave: max abs diff {diff}")
            reset_launches()
            for label, call in (
                    (f"K5{what}", lambda: da.paged_block_decode_attention(
                        q[:, 0], off16(torch, pools[0]), pools[1], lens,
                        tab, **sc)),
                    (f"K4{what}", lambda: da.paged_decode_attention(
                        q[:, 0], slots[0], off16(torch, slots[1]), lens,
                        **rsc))):
                try:
                    call()
                except ValueError as e:
                    if "16-byte" not in str(e):
                        raise
                else:
                    fail(f"{dtype} {label} took a cache 8 bytes off a "
                         f"16-byte boundary")
            if any(launch_counts().values()):
                fail(f"{dtype} K4{what}/K5{what} launched on a refused "
                     f"cache")
        log(f"  K5{what} paged_block_decode_attention {dtype} == "
            f"K1{what} ragged_paged_attention, K4{what} "
            f"paged_decode_attention == K8{what} ragged_attention, on the "
            f"Q 1 decode wave over the same {cache} pool / slot rows at "
            f"Dh 32, 64 and 128, bit for bit; a misaligned cache refused")


def check_f32_verify_equals_ragged(torch, seed):
    """f32 K6/K7 and f32-q K6-int8/K7-int8 on the split-K CUDA-core body,
    on phase 2's verify wave (Q 5, ``VERIFY_QLENS``): the 8 slots of
    ``LENGTHS`` in the f32 pool of ``pool_case`` and its slot rows
    gathered through the tables, then in the pool's encoding on the card
    (payload and scales gathered alike).  K7
    (``paged_block_verify_attention``) equals K1
    (``ragged_paged_attention``) over the pool and K6
    (``paged_verify_attention``) equals K8 (``ragged_attention``) over
    the slot rows, bit for bit, and so do their f32-q int8 twins:
    one split body, row limits that agree (VerifyLim is RaggedLim's
    clip), one split order.  Each verify call counts one launch under
    its name (``_int8``); an f32 pool, f32 slot rows or an int8 payload
    8 bytes off a 16-byte boundary is refused with nothing launched."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.kernels import ragged_attention as ra
    pool_k, pool_v, tables, _ = pool_case(torch, "float32", seed + 17)
    B, span, Q = len(LENGTHS), T_WIDTH * BS, int(VERIFY_QLENS.max())
    lens, ql, tab = (torch.from_numpy(x).cuda()
                     for x in (LENGTHS, VERIFY_QLENS, tables))
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    q = torch.randn((B, Q, H, DH), generator=g, device="cuda")

    def rows(x):
        """The slot rows of pool ``x`` (or of its scale plane)."""
        return x[tab.long()].reshape(B, span, *x.shape[2:]).contiguous()
    (kq, ks), (vq, vs) = int8_kv(torch, pool_k, pool_v)
    for what, pools, sc in (("", (pool_k, pool_v), {}),
                            ("-int8", (kq, vq), dict(k_scale=ks,
                                                     v_scale=vs))):
        slots = tuple(rows(x) for x in pools)
        rsc = {n: rows(x) for n, x in sc.items()}
        sfx = what.replace("-", "_")
        reset_launches()
        k7 = da.paged_block_verify_attention(q, *pools, lens, ql, tab, **sc)
        k6 = da.paged_verify_attention(q, *slots, lens, ql, **rsc)
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts().items() if n}
        want = {f"paged_block_verify_attention{sfx}": 1,
                f"paged_verify_attention{sfx}": 1}
        if counts != want:
            fail(f"f32 K6{what}/K7{what} launches {counts}, not {want}")
        k1 = ra.ragged_paged_attention(q, *pools, lens, ql, tab, **sc)
        k8 = ra.ragged_attention(q, *slots, lens, ql, **rsc)
        torch.cuda.synchronize()
        for got, ref, pair in ((k7, k1, f"K7{what} vs K1{what}"),
                               (k6, k8, f"K6{what} vs K8{what}")):
            if not torch.equal(got, ref):
                fail(f"f32 {pair} on the Q {Q} verify wave: max abs diff "
                     f"{float((got - ref).abs().max())}")
    slots8 = dict(k_scale=rows(ks), v_scale=rows(vs))
    refused = (
        ("f32 K7: a pool", lambda: da.paged_block_verify_attention(
            q, off16(torch, pool_k), pool_v, lens, ql, tab)),
        ("f32 K6: slot rows", lambda: da.paged_verify_attention(
            q, rows(pool_k), off16(torch, rows(pool_v)), lens, ql)),
        ("f32-q K7-int8: a payload", lambda: da.paged_block_verify_attention(
            q, off16(torch, kq), vq, lens, ql, tab, k_scale=ks,
            v_scale=vs)),
        ("f32-q K6-int8: a payload", lambda: da.paged_verify_attention(
            q, rows(kq), off16(torch, rows(vq)), lens, ql, **slots8)))
    reset_launches()
    for label, call in refused:
        try:
            call()
        except ValueError as e:
            if "16-byte" not in str(e):
                raise
        else:
            fail(f"{label} 8 bytes off a 16-byte boundary was taken")
    if any(launch_counts().values()):
        fail(f"f32 K6/K7 launched on refused data: {launch_counts()}")
    log(f"  K7 paged_block_verify_attention float32 == K1 "
        f"ragged_paged_attention, K6 paged_verify_attention == K8 "
        f"ragged_attention, and their f32-q int8 twins alike, on the Q {Q} "
        f"verify wave over the same pool / slot rows, bit for bit; an f32 "
        f"cache and an int8 payload 8 bytes off 16 refused, nothing "
        f"launched")


def check_k6_int8_equals_k8_int8(torch, seed):
    """bf16-q K6-int8 (``paged_verify_attention`` over an int8 cache) and
    bf16-q K8-int8 (``ragged_attention``) on phase 2's verify wave (Q 5,
    ``VERIFY_QLENS``) over the same int8 slot rows (phase 2's K/V
    encoded on the card): one split body, one layout, the same row
    limits, so the two outputs are equal bit for bit."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import ragged_attention as ra
    k, v = slot_rows_case(torch, "float32", seed + 11)
    (kq, ks), (vq, vs) = int8_kv(torch, k, v)
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    q = torch.randn((len(LENGTHS), int(VERIFY_QLENS.max()), H, DH),
                    generator=g, device="cuda").bfloat16()
    args = (q, kq, vq, torch.from_numpy(LENGTHS).cuda(),
            torch.from_numpy(VERIFY_QLENS).cuda())
    k6 = da.paged_verify_attention(*args, k_scale=ks, v_scale=vs)
    k8 = ra.ragged_attention(*args, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    if not torch.equal(k6, k8):
        fail(f"bf16-q K6-int8 differs from bf16-q K8-int8 on the same "
             f"verify wave: max abs diff "
             f"{float((k6.float() - k8.float()).abs().max())}")
    log("  K6-int8 paged_verify_attention bfloat16 == K8-int8 "
        "ragged_attention bfloat16 on the Q 5 verify wave over the same "
        "int8 slot rows, bit for bit")


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
    err, ratio, ok = flash_compare(o, o_r, q, k, v, dtype, causal=True,
                                   kv_lens=kv_d)
    live = lse_r < 1e29
    lse_err = float((lse - lse_r)[live].abs().max())
    if not ok or lse_err > LSE_TOL \
            or not torch.equal(lse[~live], lse_r[~live]):
        fail(f"flash_attention {dtype}: max abs err {err}, largest err / "
             f"bound {ratio}, lse err {lse_err} (lse {LSE_TOL})")
    ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                            kv_lens=kv_d))
    run_ms = time_run_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                                     kv_lens=kv_d))
    dev = device_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
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
    b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
    log(f"  K2 flash_attention {dtype}: max_abs_err {err:.3e}, largest "
        f"err / bound {ratio:.4f} (flash_compare); lse {lse_err:.3e}, tol "
        f"{LSE_TOL:g}; kernel "
        f"{ms:.4f} ms ({run_ms:.4f} back to back, {ms_text(dev)} on the "
        f"device), plain {plain_ms:.4f} ms, SDPA is_causal on "
        f"[8,12,512,64] without the kv_lens mask {lib_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop"
        f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    return dict(err=err, ratio=ratio, ms=ms, run_ms=run_ms, dev_ms=dev,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


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
    P, n_new = prompts.shape[1], 32
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L, paged_decode_attention=L * (n_new - 1))
    if counts != want:
        fail(f"offline {dtype}: launches {counts}, want {want} (layers x "
             f"1 prefill call, layers x {n_new - 1} decode positions)")
    if out.shape != (len(prompts), P + n_new) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all() \
            or not (out[:, :P] == prompts).all():
        fail(f"offline {dtype}: malformed output {out.shape}")
    log(f"  generate_fast {dtype}: {len(prompts)} x ({P} + {n_new}) tokens "
        f"in {sec:.3f} s; launches {counts}")
    return out, counts


# the engine configurations: phase 4 is the auto settings on CUDA (the
# paged pool, block 16, mixed waves); phase 5 the three others
CONFIGS = {
    "paged-mixed": dict(prefix_share=True, prefill_chunk=256),
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=True, ragged=False, prefix_share=True,
                        prefill_chunk=256),
    "contiguous-mixed": dict(paged=False, ragged=True),
}
LAYOUT = {"paged-mixed": (True, True), "contiguous-split": (False, False),
          "paged-split": (True, False), "contiguous-mixed": (False, True)}


def verify_launches(eng):
    """Launches of the verify kernel per layer per phase-split wave: one
    per 16-row group of the k + 1 row block (k fixed when the engine does
    not adapt it; an adaptive k stays within one group up to spec 15)."""
    if not eng.spec_k:
        return 1
    if eng.spec_adapt and eng.spec_k >= 16:
        fail("an adaptive k past 15 has no fixed count of verify groups")
    return -(-(eng.spec_k + 1) // 16)


def want_launches(eng, L):
    """The exact launches of one engine run: mixed, the ragged kernel of
    the layout per layer per step (verify rows ride the wave);
    phase-split, the flash kernel per layer per flash group, the ragged
    paged kernel per layer per chunk pass, and per layer per wave the
    decode kernel of the layout, or with speculation its verify kernel
    (once per 16-row group of the block, ``verify_launches``).  With an
    int8 cache each of those but flash (which attends to the fresh K/V)
    is the int8 twin, and its float twin launches never.  A
    speculative engine's draft (never quantized) adds the contiguous
    decode kernel per draft layer per draft step (k + 1 a wave) and the
    flash kernel per draft layer per admission."""
    from hetu_tpu_torch.kernels import KERNELS
    want = dict.fromkeys(KERNELS, 0)
    q = "_int8" if eng.kv_quant else ""
    if eng.ragged:
        want[("ragged_paged_attention" if eng.paged
              else "ragged_attention") + q] = L * eng.steps
    else:
        want["flash_attention"] = L * (eng.prefill_dispatches
                                       - eng.prefill_chunks)
        want["ragged_paged_attention" + q] = L * eng.prefill_chunks
        wave = (("paged_block_verify_attention", "paged_verify_attention")
                if eng.spec_k else
                ("paged_block_decode_attention", "paged_decode_attention"))
        want[(wave[0] if eng.paged else wave[1]) + q] = \
            L * eng.steps * verify_launches(eng)
    if eng.spec_k:
        Ld = eng.spec_draft_layers
        want["paged_decode_attention"] += Ld * (eng.spec_k_sum
                                                + eng.spec_waves)
        want["flash_attention"] += Ld * eng.spec_draft_prefills
    return want


def serve(torch, htt, params, cfg, reqs_spec, dtype, config, prof=None,
          **engine_kw):
    """One engine run of ``config`` (plus ``engine_kw``) over the request
    set, its launches held to ``want_launches``; ``prof`` (a
    torch.profiler.profile) wraps the run alone when given."""
    from hetu_tpu_torch.kernels import (launch_counts, regime_counts,
                                        reset_launches)
    from hetu_tpu_torch.serving import Request
    dt = getattr(torch, dtype)
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=dt,
                            **CONFIGS[config], **engine_kw)
    if (eng.paged, eng.ragged) != LAYOUT[config] \
            or (eng.paged and eng.kv.block != 16):
        fail(f"{config}: the engine runs paged={eng.paged} "
             f"ragged={eng.ragged} block {getattr(eng.kv, 'block', 0)}")
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
    counts, regimes = launch_counts(), regime_counts()
    L = cfg.num_hidden_layers
    want = want_launches(eng, L)
    if counts != want or not eng.steps:
        fail(f"{config} {dtype}: launches {counts}, want {want} ({L} "
             f"layers, {eng.steps} steps, {eng.prefill_dispatches} "
             f"prefill dispatches, {eng.prefill_chunks} chunk passes, "
             f"spec {eng.spec_k}, kv_quant {eng.kv_quant})")
    if len(res) != len(reqs):
        fail(f"{config} {dtype}: {len(res)} of {len(reqs)} requests done")
    hits = eng.kv.prefix_hits if eng.paged else 0
    if eng.paged and hits < 3:
        fail(f"{config} {dtype}: {hits} prefix hits; the three later "
             f"requests of the shared 128-token prefix should hit")
    for i, (pr, _, _) in enumerate(reqs_spec):
        toks = res[f"r{i}"].tokens
        if len(toks) != len(pr) + 64 or list(toks[:len(pr)]) != list(pr) \
                or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{config} {dtype}: request r{i} malformed")
    gen = sum(r.n_generated for r in res.values())
    ttft = np.array([r.ttft_s for r in res.values()]) * 1e3
    stats = dict(tokens_per_s=gen / sec, seconds=sec, steps=eng.steps,
                 generated=gen, ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p99_ms=float(np.percentile(ttft, 99)),
                 prefix_hits=hits,
                 prefill_dispatches=eng.prefill_dispatches,
                 prefill_chunks=eng.prefill_chunks,
                 cache_bytes=eng.kv.cache_bytes,
                 cache_rows=(eng.kv.n_blocks * eng.kv.block if eng.paged
                             else eng.kv.n_slots * eng.kv.s_max))
    tag = " int8 KV;" if eng.kv_quant else ""
    if eng.moe is not None:
        stats.update(moe_accounting(eng, L))
        tag += (f" MoE load {stats['expert_load']} drops "
                f"{stats['expert_drops']} over {stats['moe_tokens']} "
                f"routed positions, imbalance "
                f"{stats['expert_imbalance']:.4f}, drop rate "
                f"{stats['expert_drop_rate']:.4f};")
    if eng.spec_k:
        stats.update(spec_waves=eng.spec_waves,
                     acceptance=eng.spec_acceptance,
                     mean_k=eng.spec_mean_k,
                     tokens_per_wave=eng.spec_emitted / eng.spec_waves,
                     draft_prefills=eng.spec_draft_prefills)
        tag += (f" spec {eng.spec_k} (draft {eng.spec_draft_layers} "
               f"layers): acceptance {eng.spec_acceptance:.4f}, mean k "
               f"{eng.spec_mean_k:.3f}, {stats['tokens_per_wave']:.3f} "
               f"tokens per wave (all slots) over {eng.spec_waves} "
               f"waves;")
    log(f"  {config} {dtype}:{tag} {gen} tokens in {sec:.3f} s = "
        f"{stats['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.1f} ms p99 {stats['ttft_p99_ms']:.1f} "
        f"ms, {eng.steps} steps, {eng.prefill_dispatches} prefill "
        f"dispatches ({eng.prefill_chunks} chunk passes), prefix hits "
        f"{hits}, launches {counts}")
    return res, {**counts, **regimes}, stats


def moe_accounting(eng, L):
    """An MoE engine's routing record after a run, each step's and the
    lifetime's load + drop == routed positions x top_k x MoE layers (or
    a failure)."""
    n = eng.moe.top_k * eng.moe.moe_layers(L)
    recs = [e for e in eng.metrics.events if "moe_tokens" in e]
    bad = [e.get("step") for e in recs
           if e["moe_routed"] + e["moe_dropped"] != e["moe_tokens"] * n]
    total = int(eng.expert_load.sum() + eng.expert_drops.sum())
    if bad or not recs or total != eng.moe_tokens * n \
            or sum(e["moe_tokens"] for e in recs) != eng.moe_tokens:
        fail(f"MoE accounting: load + drop {total} over "
             f"{eng.moe_tokens} positions x {n}; steps breaking it {bad}")
    return dict(expert_load=eng.expert_load.tolist(),
                expert_drops=eng.expert_drops.tolist(),
                moe_tokens=eng.moe_tokens, moe_steps=len(recs),
                expert_imbalance=eng.expert_imbalance,
                expert_drop_rate=eng.expert_drop_rate)


# kernel kinds of the profile, by name, first match wins.  K4-K7 in
# either q dtype and their int8 twins (an int8 twin's element type,
# signed char, makes it the twin in kind_of) are split and merge kernels
# of their own row-limit types (DecodeLim<layout>, VerifyLim<layout>),
# ahead of K1/K8's and their twins'; K1/K8 are the
# f32 TF32 ragged kernel (f32 q, Q > 16), the f32 split kernel and its
# merge (f32 q, Q <= 16: f32 K1 and K8, and f32-q K1-int8 and K8-int8,
# whose signed char makes them the twins; the merge's template names the
# cache type and layout too) and the bf16 wide, split and merge kernels
# (bf16 q, either cache), told apart by their layout
RAGGED = ("(ragged_tf32_kernel|ragged_wide_kernel|"
          "split_kv_kernel|split_kv_f32_kernel|split_merge_kernel)")
KINDS = (("K4 paged_decode_attention",
          re.compile("DecodeLim<hetu::SlotRows")),
         ("K5 paged_block_decode_attention",
          re.compile("DecodeLim<hetu::TableRows")),
         ("K6 paged_verify_attention",
          re.compile("VerifyLim<hetu::SlotRows")),
         ("K7 paged_block_verify_attention",
          re.compile("VerifyLim<hetu::TableRows")),
         ("K1 ragged_paged_attention", re.compile(RAGGED + ".*TableRows")),
         ("K8 ragged_attention", re.compile(RAGGED + ".*SlotRows")),
         ("K2 flash_attention", re.compile("flash_fwd")),
         ("matmul", re.compile("gemm|nvjet|splitK")),
         ("KV writes (index_put)", re.compile("index_elementwise")),
         ("reductions", re.compile("reduce_kernel")),
         ("elementwise", re.compile("elementwise")))


def kind_of(name):
    """The kind of a profiled kernel; an attention kernel over an int8
    cache (element type int8_t, which demangles as signed char, never
    the last template argument: the bf16 ragged kernels and their merge
    take it second, after D) is its int8 twin, K1-int8 ... K8-int8."""
    kind = next((k for k, rx in KINDS if rx.search(name)), "other")
    if re.match(r"K\d ", kind) and ", signed char," in name:
        kind = kind.replace(" ", "-int8 ", 1)
    return kind


# every profiled serving run: (configuration, spec, kv_quant, dtype)
PROFILE_RUNS = tuple((config, spec_k, quant, dtype)
                     for config, (spec_k, quant), dtype in itertools.product(
                         CONFIGS, ((0, None), (4, None), (0, "int8")),
                         ("float32", "bfloat16")))


def profile_serve(torch, htt, params, cfg, spec, out_dir,
                  runs=PROFILE_RUNS):
    """Where each serving configuration's device time goes, without and
    with speculation (``spec=4``) and with an int8 cache (no
    speculation), or in the given ``runs``: its engine run again, f32
    and bf16, under torch.profiler; device time by kind and by kernel
    (top 15, and the table in ``out_dir``) and the device's busy share
    of the run's wall time (host tracing overhead inflates the wall, so
    the busy share is a lower bound).  Returns {(label, dtype): the
    engine's stats plus ``busy_s`` and ``kinds``, {kind: [device ms,
    launches]}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for config, spec_k, quant, dtype in runs:
        label = (f"{config}{'-spec' if spec_k else ''}"
                 f"{'-int8' if quant else ''}")
        t_prof = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, _, st = serve(torch, htt, params, cfg, spec, dtype, config,
                         prof=prof, spec=spec_k, kv_quant=quant)
        # kernel rows only: an operator row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            fail("the profiler recorded no device time")
        rows.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        lines = [f"{'kernel':64s} {'calls':>7s} {'device ms':>11s} "
                 f"share"]
        lines += [f"{e.key[:64]:64s} {e.count:7d} "
                  f"{e.self_device_time_total / 1e3:11.3f} "
                  f"{e.self_device_time_total / 1e6 / busy:6.1%}"
                  for e in rows]
        (out_dir / f"profile_{label}_{dtype}.txt").write_text(
            "\n".join(lines) + "\n")
        log(f"  profile {label} {dtype}: device busy {busy:.4f} s of "
            f"{st['seconds']:.4f} s wall "
            f"({busy / st['seconds']:.1%}) under the profiler; "
            f"{time.perf_counter() - t_prof:.1f} s with the profile's "
            f"analysis")
        kinds = collections.Counter()
        calls = collections.Counter()
        for e in rows:
            kinds[kind_of(e.key)] += e.self_device_time_total / 1e3
            calls[kind_of(e.key)] += e.count
        for k, ms in kinds.most_common():
            log(f"    {k}: {ms:.3f} ms ({ms / 1e3 / busy:.1%}, "
                f"{calls[k]} launches)")
        log("  top kernels:")
        for line in lines[:16]:
            log("    " + line)
        out[label, dtype] = dict(st, busy_s=busy, kinds={
            k: [ms, calls[k]] for k, ms in kinds.items()})
    return out


def zero_late_layers(torch, params, cfg, first, name="gpt"):
    """Output-zero the blocks from ``first`` on (their attention and FFN
    output projections): a draft of ``first`` layers then computes the
    target's logits, so greedy drafts are accepted."""
    hp = dict(params)
    for i in range(first, cfg.num_hidden_layers):
        for wn in ("attn_proj_weight", "attn_proj_bias", "ffn_wo_weight",
                   "ffn_wo_bias"):
            k = f"{name}_h{i}_{wn}"
            hp[k] = torch.zeros_like(params[k])
    return hp


def phase6(torch, htt, params, cfg, spec, runs, res32, prompts, off_f32,
           card, seed):
    """Speculation through all four engine configurations, the
    high-acceptance arm and offline ``generate_fast(spec=4)``.  Returns
    {(config, dtype): (results, launches, stats)} of the speculative runs
    on the random weights."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    K = 4
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    sampled = [i for i, (_, t, _) in enumerate(spec) if t > 0]
    spec_runs = {}
    for config in CONFIGS:
        for dt in ("float32", "bfloat16"):
            spec_runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                          config, spec=K)
        res = spec_runs[config, "float32"][0]
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(res32[f"r{i}"].tokens)]
        if bad:
            fail(f"spec {config} f32 greedy tokens differ from phase 4's "
                 f"for requests {bad}")
        plain = runs[config, "float32"][0]
        bad = [i for i in sampled
               if list(res[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
        if bad:
            fail(f"spec {config} f32 sampled tokens differ from the "
                 f"non-speculative run for requests {bad}")
        log(f"  spec {config} f32: greedy tokens == phase 4's "
            f"({len(greedy)}), sampled == non-speculative ({len(sampled)})")
    for (config, dt), (_, _, st) in spec_runs.items():
        log(f"  spec serving on {card}: {config} {dt} "
            f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms, "
            f"acceptance {st['acceptance']:.4f}, mean k {st['mean_k']:.3f}, "
            f"{st['tokens_per_wave']:.3f} tokens per wave")

    log("  high-acceptance arm: layers 3-11 output-zeroed, all greedy")
    hp = zero_late_layers(torch, params, cfg, 3)
    hspec = [(pr, 0.0, 0) for pr, _, _ in spec]
    plain, _, _ = serve(torch, htt, hp, cfg, hspec, "float32", "paged-mixed")
    for config in ("paged-split", "paged-mixed"):
        res, _, st = serve(torch, htt, hp, cfg, hspec, "float32", config,
                           spec=K)
        bad = [r for r in res if list(res[r].tokens)
               != list(plain[r].tokens)]
        if bad:
            fail(f"high-acceptance {config}: tokens differ from the "
                 f"non-speculative run for {bad}")
        if st["acceptance"] < 0.9 or st["spec_waves"] >= st["generated"]:
            fail(f"high-acceptance {config}: acceptance "
                 f"{st['acceptance']:.4f} (want >= 0.9), "
                 f"{st['spec_waves']} waves for {st['generated']} tokens")
        log(f"  high-acceptance {config} f32 on {card}: tokens == "
            f"non-speculative; acceptance {st['acceptance']:.4f}, mean k "
            f"{st['mean_k']:.3f}, {st['tokens_per_wave']:.3f} tokens per "
            f"wave ({st['spec_waves']} waves, {st['generated']} tokens), "
            f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms")

    # offline: flash prefill of the target (12 layers) and the draft (3),
    # then per wave K4 3 x (K + 1) and K6 12 x 1
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = htt.generate_fast(params, cfg, prompts, 32, spec=K,
                            dtype=torch.float32)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    L, Ld = cfg.num_hidden_layers, cfg.num_hidden_layers // 4
    waves = counts["paged_verify_attention"] // L
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L + Ld, paged_verify_attention=L * waves,
                paged_decode_attention=Ld * (K + 1) * waves)
    if counts != want or not waves:
        fail(f"offline spec: launches {counts}, want {want}")
    if out.tolist() != off_f32.tolist():
        fail("offline generate_fast(spec=4) f32 tokens differ from "
             "phase 3's")
    log(f"  generate_fast spec {K} f32: tokens == phase 3's; {waves} "
        f"verify waves for {out.shape[0]} x 32 tokens in {sec:.3f} s; "
        f"launches {counts}")
    deep_spec(torch, htt, params, cfg, spec, prompts, seed)
    return spec_runs


# the long verify wave: Q = spec 16 + 1 over phase 2's slots, q_lens of
# a full block, one ending on the 16-row edge, shorter ones, an inert
# slot and a length-0 one
LONG_QLENS = np.minimum(np.array([17, 16, 9, 0, 1, 17, 2, 17], np.int32),
                        LENGTHS)


def check_long_verify(torch, dtype, seed, paged):
    """K7 (``paged``) or K6 on a 17-row verify block: two launches (the
    16-row groups), every live row within TOL of the plain version over
    the whole block (bf16 plus ``ragged_rounding_bound``, whose largest
    err / bound is logged).  Returns the max abs error."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.kernels import ragged_attention as ra
    B, Q = len(LENGTHS), 17
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    q = torch.randn((B, Q, H, DH), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    lens, ql = (torch.from_numpy(a).cuda() for a in (LENGTHS, LONG_QLENS))
    if paged:
        pool_k, pool_v, tables, _ = pool_case(torch, dtype, seed + 32)
        args = (q, pool_k, pool_v, lens, ql, torch.from_numpy(tables).cuda())
        run, plain = (da.paged_block_verify_attention,
                      da.paged_block_verify_reference)
    else:
        k, v = slot_rows_case(torch, dtype, seed + 33)
        args = (q, k, v, lens, ql)
        run, plain = da.paged_verify_attention, da.masked_verify_reference
    reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    n = launch_counts()[run.__name__]
    want = plain(*args).to(q.dtype)
    if n != 2:
        fail(f"{run.__name__} {dtype} Q {Q}: {n} launches (want 2)")
    atol, rtol = TOL[dtype]
    bf16 = dtype == "bfloat16"
    if bf16:
        atol = atol + ra.ragged_rounding_bound(*args)
    worst = ratio = 0.0
    for b, m in enumerate(LONG_QLENS):
        if m == 0:
            continue
        err, r, ok = close(got[b, :m], want[b, :m],
                           atol[b, :m] if bf16 else atol, rtol)
        worst, ratio = max(worst, err), max(ratio, r)
        if not ok:
            fail(f"{run.__name__} {dtype} Q {Q}: slot {b} max abs err "
                 f"{err}, largest err / bound {r} (TOL {TOL[dtype]}"
                 f"{' + ragged_rounding_bound' if bf16 else ''})")
    log(f"  {run.__name__} {dtype} at Q {Q} (two 16-row groups, 2 "
        f"launches): live rows == plain version, max abs err {worst:.3e}, "
        f"largest err / bound {ratio:.4f}"
        f"{' (TOL + ragged_rounding_bound)' if bf16 else ''}")
    return worst


def deep_spec(torch, htt, params, cfg, spec, prompts, seed):
    """Speculation deeper than the verify kernels' 16 rows: K6/K7 at Q 17
    against their plain versions; then GPT-2-small cut to 4 layers, f32:
    phase-split ``ServingEngine(spec=16, spec_adapt=False)`` on the slot
    rows and on the pool, and ``generate_fast(spec=16)``, each with the
    greedy tokens of its ``spec=0`` run and two verify launches per layer
    per wave."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    for paged in (False, True):
        for dt in ("float32", "bfloat16"):
            check_long_verify(torch, dt, seed, paged)
    L, K = 4, 16
    cfg4 = htt.GPTConfig(num_hidden_layers=L)
    layer = re.compile(r"gpt_h(\d+)_")
    p4 = {k: v for k, v in params.items()
          if not layer.match(k) or int(layer.match(k).group(1)) < L}
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    for config in ("contiguous-split", "paged-split"):
        plain, _, _ = serve(torch, htt, p4, cfg4, spec, "float32", config)
        res, _, st = serve(torch, htt, p4, cfg4, spec, "float32", config,
                           spec=K, spec_adapt=False)
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
        if bad:
            fail(f"spec {K} {config} ({L} layers): greedy tokens differ "
                 f"from spec 0's for requests {bad}")
        log(f"  spec {K} {config} f32, {L} layers: greedy tokens == spec "
            f"0's ({len(greedy)} requests), {st['spec_waves']} waves")
    want_tok = htt.generate_fast(p4, cfg4, prompts, 32, dtype=torch.float32)
    torch.cuda.synchronize()
    reset_launches()
    out = htt.generate_fast(p4, cfg4, prompts, 32, spec=K,
                            dtype=torch.float32)
    torch.cuda.synchronize()
    counts = launch_counts()
    Ld = L // 4
    waves = counts["paged_verify_attention"] // (2 * L)
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L + Ld,
                paged_verify_attention=2 * L * waves,
                paged_decode_attention=Ld * (K + 1) * waves)
    if counts != want or not waves:
        fail(f"offline spec {K}: launches {counts}, want {want}")
    if out.tolist() != want_tok.tolist():
        fail(f"offline generate_fast(spec={K}) f32 tokens differ from "
             f"spec 0's ({L} layers)")
    log(f"  generate_fast spec {K} f32, {L} layers: tokens == spec 0's; "
        f"{waves} verify waves, launches {counts}")


def margin_gate(torch, params, cfg, want, got, prompt_len, oracle,
                low="int8"):
    """The JAX package's int8 criterion (``teacher_forced_logits``): the
    int8 run's greedy tokens ``got`` equal the f32 run's ``want``, or
    they first differ at a position whose exact top-2 margin is at most
    2 delta, delta the largest |fake-quant - exact| logit gap over the
    f32 sequence.  ``low="bf16"`` is the same gate for a bf16 run, with
    the bf16 teacher-forced pass in the place of the fake-quantized one.
    ``oracle`` caches the two teacher-forced passes per sequence.
    Returns None when identical, else (position, margin, delta); fails
    past the gate."""
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    want, got = list(want), list(got)
    if want == got:
        return None
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    key = tuple(want)
    if key not in oracle:
        seq = np.asarray(want[:-1], np.int64)
        exact = teacher_forced_logits(params, cfg, seq, dtype=torch.float32)
        fake = teacher_forced_logits(
            params, cfg, seq, kv_fake_quant=low == "int8",
            dtype=torch.float32 if low == "int8" else torch.bfloat16)
        oracle[key] = (exact, float((fake - exact).abs().max()))
    exact, delta = oracle[key]
    top2 = torch.topk(exact[t - 1], 2).values
    margin = float(top2[0] - top2[1])
    if t < prompt_len or margin > 2 * delta:
        fail(f"{low} greedy tokens first differ from f32 at position {t} "
             f"(prompt {prompt_len}), exact top-2 margin {margin:.4e} > "
             f"2 delta = {2 * delta:.4e}")
    return t, margin, delta


def phase7(torch, htt, params, cfg, spec, res32, card):
    """The int8 KV cache (``kv_quant="int8"``) through all four engine
    configurations, f32 then bf16: exact launches of the int8 twins (and
    none of their float twins), the footprint from the shapes, and the
    margin gate of every f32 greedy request against phase 4; then
    ``spec=4`` in all four, f32 then bf16, whose f32 tokens (greedy and
    sampled) equal the non-speculative int8 run's.  Returns
    ({(config, dtype): (results, launches, stats)} without speculation,
    the same with)."""
    L = cfg.num_hidden_layers
    Dh = cfg.hidden_size // cfg.num_attention_heads
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    runs, spec_runs, oracle = {}, {}, {}
    for config in CONFIGS:
        for dt in ("float32", "bfloat16"):
            runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                     config, kv_quant="int8")
        st = runs[config, "float32"][2]
        want = 2 * L * st["cache_rows"] * cfg.num_attention_heads * (Dh + 4)
        f32 = 2 * L * st["cache_rows"] * cfg.num_attention_heads * Dh * 4
        if st["cache_bytes"] != want:
            fail(f"int8 {config}: cache_bytes {st['cache_bytes']}, the "
                 f"shapes give {want}")
        res = runs[config, "float32"][0]
        gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                             res[f"r{i}"].tokens, len(spec[i][0]), oracle)
                 for i in greedy]
        same = sum(g is None for g in gates)
        log(f"  int8 {config}: KV {st['cache_bytes']} B = "
            f"{st['cache_bytes'] / f32:.4f} of f32's {f32} B; f32 greedy "
            f"tokens identical to phase 4's for {same} of {len(greedy)} "
            f"requests, the rest first differ within the margin gate "
            f"(position, exact top-2 margin, delta): "
            f"{[g for g in gates if g is not None]}")
    for config in CONFIGS:
        for dt in ("float32", "bfloat16"):
            spec_runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                          config, kv_quant="int8", spec=4)
        res = spec_runs[config, "float32"][0]
        plain = runs[config, "float32"][0]
        bad = [i for i in range(len(spec))
               if list(res[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
        if bad:
            fail(f"int8 spec {config} f32 tokens differ from the "
                 f"non-speculative int8 run for requests {bad}")
        log(f"  int8 spec {config} f32: all {len(spec)} requests' tokens "
            f"(greedy and sampled) == the non-speculative int8 run's")
    for tag, rs in (("", runs), (" spec 4", spec_runs)):
        for (config, dt), (_, _, st) in rs.items():
            log(f"  int8 serving on {card}: {config}{tag} {dt} "
                f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
                f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms")
    return runs, spec_runs


# ---------------------------------------------------------------- #
# phase 8: training
# ---------------------------------------------------------------- #

# K3 vs its plain version.  f32: atol 1e-4 + rtol 1e-4, the sums over up
# to 1024 rows run in another order.  bf16: both sides round P and dS to
# bf16 before the sums, and a value one f32 ulp apart may round to the
# neighbouring bf16 value, moving a sum by one bf16 ulp of one term; so
# atol is one bf16 ulp (2^-7) of the tensor's largest |want| and rtol
# one ulp.
K3_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
# the training shape: GPT-2-small at B 8, S 1024
TB, TS = 8, 1024


def k3_compare(got, want, dtype):
    """(max abs error, True when every element is within K3_TOL)."""
    atol, rtol = K3_TOL[dtype]
    got, want = got.float(), want.float()
    if dtype == "bfloat16":
        atol = atol * float(want.abs().max())
    diff = (got - want).abs()
    ok = bool(got.isfinite().all()
              and (diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def k3_inputs(torch, B, S, Sk, D, dtype, seed, Hn=H):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, S, Hn, D), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hn, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    return q, k, v, do


def check_k3_cases(torch, dtype, seed):
    """K3's two kernels against their plain versions on small cases: head
    dims 32/64/128; causal and not; kv_lens with a 0 and a full length;
    Sk > S (causal and not); S not a multiple of the 64-row tile.  The
    lse comes from the plain forward; sequence 1 (kv_lens 0) must get
    zero gradients."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    cases = [(True, 100, 100, True), (False, 100, 100, True),
             (False, 40, 72, True), (True, 40, 72, False),
             (True, 128, 128, False)]
    worst = 0.0
    for D in (32, 64, 128):
        for causal, S, Sk, with_lens in cases:
            q, k, v, do = k3_inputs(torch, 3, S, Sk, D, dtype, seed + D, 4)
            lens = (torch.tensor([Sk - 3, 0, Sk], dtype=torch.int32,
                                 device="cuda") if with_lens else None)
            o, lse = fa.flash_fwd_reference(q, k, v, causal=causal,
                                            kv_lens=lens)
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, lens, lse, delta, do)
            dk, dv = fa.flash_bwd_dkv(*args, causal=causal)
            dq = fa.flash_bwd_dq(*args, causal=causal)
            torch.cuda.synchronize()
            wk, wv = fa.flash_bwd_dkv_reference(*args, causal=causal)
            wq = fa.flash_bwd_dq_reference(*args, causal=causal)
            for name, got, want in (("dq", dq, wq), ("dk", dk, wk),
                                    ("dv", dv, wv)):
                err, ok = k3_compare(got, want, dtype)
                worst = max(worst, err)
                if not ok or (with_lens and got[1].abs().max() != 0):
                    fail(f"K3 {name} {dtype} D {D} causal {causal} S {S} "
                         f"Sk {Sk} kv_lens {with_lens}: max abs err {err} "
                         f"((atol, rtol) {K3_TOL[dtype]}, bf16 atol "
                         f"scaled by max |want|)")
    log(f"  K3 {dtype}: {3 * len(cases)} cases (D 32/64/128; causal and "
        f"not; kv_lens with 0; Sk > S; S 100/40) match the plain version, "
        f"max abs err {worst:.3e}")


def sdpa_backend(torch, q, k, v):
    """The name of the backend SDPA picks for causal attention on these
    inputs (torch._fused_sdp_choice)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def check_k3(torch, F, dtype, seed):
    """K3's kernels and K2 at the training shape (B 8, S 1024, H 12, D 64,
    causal, no kv_lens): each against its plain version, timed beside
    its bound; the yardsticks are SDPA's backward (autograd.grad through
    ``scaled_dot_product_attention(is_causal=True)``, the backward alone
    timed) and SDPA's forward.  Returns {"dkv", "dq", "fwd": result}."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    q, k, v, do = k3_inputs(torch, TB, TS, TS, DH, dtype, seed + 21)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True)
    err_o, ratio_o, ok = flash_compare(o, o_r, q, k, v, dtype, causal=True)
    lse_err = float((lse - lse_r).abs().max())
    if not ok or lse_err > LSE_TOL:
        fail(f"K2 at the training shape {dtype}: max abs err {err_o}, "
             f"largest err / bound {ratio_o}, lse {lse_err} (lse "
             f"{LSE_TOL})")
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, None, lse, delta, do)
    es = q.element_size()
    n = TB * TS * H * DH * es                    # one [B, S, H, D] tensor
    stats = 2 * TB * H * TS * 4                  # lse and delta, f32
    pairs = TB * H * TS * (TS + 1) // 2          # live (q, k) pairs
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    backend = sdpa_backend(torch, qt, kt, vt)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd_run = time_run_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True))
    lib_fwd_run = time_run_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    res = {}
    # (kernel, plain, products, bytes: inputs read once, outputs written)
    for name, run, plain, prods, nbytes in (
            ("dkv", lambda: fa.flash_bwd_dkv(*args, causal=True),
             lambda: fa.flash_bwd_dkv_reference(*args, causal=True),
             4, 6 * n + stats),
            ("dq", lambda: fa.flash_bwd_dq(*args, causal=True),
             lambda: fa.flash_bwd_dq_reference(*args, causal=True),
             3, 5 * n + stats)):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        errs = [k3_compare(g, w, dtype) for g, w in
                zip(got if name == "dkv" else (got,),
                    want if name == "dkv" else (want,))]
        err = max(e for e, _ in errs)
        if not all(ok for _, ok in errs):
            fail(f"K3 {name} {dtype} at the training shape: max abs err "
                 f"{err} ((atol, rtol) {K3_TOL[dtype]})")
        ms = time_ms(torch, run)
        run_ms = time_run_ms(torch, run)
        dev = device_ms(torch, run)
        plain_ms = time_ms(torch, plain, reps=5)
        flops = prods * 2 * DH * pairs
        b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
        res[name] = dict(err=err, ms=ms, run_ms=run_ms, dev_ms=dev,
                         plain_ms=plain_ms, library_ms=lib_bwd,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  K3 flash_attention_bwd_{name} {dtype} [{TB},{TS},{H},{DH}] "
            f"causal: "
            f"max_abs_err {err:.3e} (atol, rtol) {K3_TOL[dtype]}; kernel "
            f"{ms:.4f} ms ({run_ms:.4f} back to back, {ms_text(dev)} on the "
            f"device), plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms by "
            f"{b_by} ({nbytes} B, {flops} flop, {prods} products"
            f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    # the whole backward: five products; q, k, v, o, dO, lse in, dq, dk,
    # dv out
    whole = time_ms(torch, lambda: fa.flash_bwd(q, k, v, None, o, lse, do,
                                                causal=True))
    whole_run = time_run_ms(torch, lambda: fa.flash_bwd(
        q, k, v, None, o, lse, do, causal=True))
    b_ms, b_by = bound(8 * n + TB * H * TS * 4, 5 * 2 * DH * pairs, dtype,
                       tf32_method(dtype))
    log(f"  K3 flash_bwd {dtype} (delta + both kernels): {whole:.4f} ms "
        f"({whole_run:.4f} back to back); "
        f"bound of the function {b_ms:.4f} ms by {b_by}; SDPA backward "
        f"({backend}) {lib_bwd:.4f} ms ({lib_bwd_run:.4f} back to back)")
    ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True))
    run_ms = time_run_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True))
    dev = device_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: fa.flash_fwd_reference(
        q, k, v, causal=True), reps=5)
    b_ms, b_by = bound(4 * n + TB * H * TS * 4, 2 * 2 * DH * pairs, dtype,
                       tf32_method(dtype))
    res["fwd"] = dict(err=err_o, ratio=ratio_o, ms=ms, run_ms=run_ms,
                      dev_ms=dev, plain_ms=plain_ms,
                      library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by)
    log(f"  K2 flash_attention {dtype} at the training shape: max_abs_err "
        f"{err_o:.3e}, largest err / bound {ratio_o:.4f} (flash_compare), "
        f"lse {lse_err:.3e}; kernel {ms:.4f} ms "
        f"({run_ms:.4f} back to back, {ms_text(dev)} on the device), plain "
        f"{plain_ms:.4f} ms, SDPA forward ({backend}) {lib_fwd:.4f} ms "
        f"({lib_fwd_run:.4f} back to back); "
        f"bound {b_ms:.4f} ms by {b_by}"
        f"{' (3 TF32 passes)' if dtype == 'float32' else ''}")
    return res


def check_train_grads(torch, htt, cfg, seed, device="cuda"):
    """The loss and every gradient of ``GPTForCausalLM`` in f32 on one
    batch of the synthetic task, through the flash path (K2 forward, K3
    backward, with the model's q/k/v layout and K2's lse) and through the
    unfused path (no kernel), from the same weights: the loss within 1e-5
    relative, each gradient within 1e-4 of its tensor's max |g| (the
    paths sum softmax terms in another order).  k's bias gets an exact 0
    (it shifts a row of scores by a constant, which softmax ignores), so
    both paths' readings of it are held to 1e-5 of the largest |g|."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.train_gpt import synthetic
    x, y = next(synthetic(cfg, np.random.RandomState(seed)))
    feed = [torch.from_numpy(a).to(device) for a in (x, y)]
    L = cfg.num_hidden_layers
    res, values = {}, None
    for flash in (True, False):
        c = copy.copy(cfg)
        c.use_flash = flash
        model = htt.GPTForCausalLM(c, seed=seed).to(device)
        if values is None:
            values = {k: v.detach().clone()
                      for k, v in model.named_vars().items()}
        model.load_var_values(values)
        model.train()
        reset_launches()
        loss = model(*feed)
        names, params = zip(*model.named_vars().items())
        grads = torch.autograd.grad(loss, params)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = launch_counts()
        want = dict.fromkeys(counts, 0)
        if flash and device == "cuda":
            want.update(flash_attention=L, flash_attention_bwd_dkv=L,
                        flash_attention_bwd_dq=L)
        if counts != want:
            fail(f"gradient check, flash={flash}: launches {counts}, want "
                 f"{want}")
        res[flash] = (float(loss.detach()), dict(zip(names, grads)))
        del model, loss, params, grads
    (lf, gf), (lu, gu) = res[True], res[False]
    if not abs(lf - lu) <= 1e-5 * abs(lu):
        fail(f"gradient check: flash loss {lf} vs unfused {lu} (rel 1e-5)")
    g_max = max(float(g.abs().max()) for g in gu.values())
    worst, worst_name = 0.0, None
    for n, want in gu.items():
        got = gf[n]
        if n.endswith("_attn_k_bias"):
            top = max(float(got.abs().max()), float(want.abs().max()))
            if not top <= 1e-5 * g_max:
                fail(f"gradient check: {n} should be 0, reads {top} "
                     f"(largest |g| {g_max})")
            continue
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not err <= 1e-4 * scale:
            fail(f"gradient check: {n} flash vs unfused max abs err {err}, "
                 f"tol 1e-4 x {scale}")
        if err / scale > worst:
            worst, worst_name = err / scale, n
    log(f"  gradients f32, flash (K2 + K3) vs unfused, {len(gu)} tensors: "
        f"loss {lf:.6f} vs {lu:.6f}; worst error {worst:.3e} of its "
        f"tensor's max |g| ({worst_name}), tol 1e-4")
    return worst


def train(torch, htt, cfg, dtype, seed, steps=8, warm=2, prof_dir=None):
    """GPT-2-small training through ``Executor``: an eval forward of the
    first step's batch, ``steps`` AdamW + clip steps on the synthetic
    task, the eval forward again; launches counted over that whole run and held to
    the exact count.  Returns (executor, stats, launches)."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.optimizer import AdamWOptimizer
    from hetu_tpu_torch.train_gpt import profile_steps, synthetic
    t0 = time.perf_counter()
    model = htt.GPTForCausalLM(cfg, seed=seed)
    opt = AdamWOptimizer(learning_rate=3e-4, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    ex = htt.Executor(model, opt, seed=seed,
                      mixed_precision="bf16" if dtype == "bfloat16" else None)
    init_s = time.perf_counter() - t0
    data = synthetic(cfg, np.random.RandomState(seed))
    batches = [next(data) for _ in range(steps)]
    # the fixed batch is the first step's: eight steps at lr 3e-4 cannot
    # learn the 50257-token map (a token is seen ~1.3 times a batch), so
    # a fresh batch's loss stays at ln(V) within noise; the check is that
    # the model learns what it was shown
    held = {"input_ids": batches[0][0], "labels": batches[0][1]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    before = float(ex.evaluate(held)[0])
    losses, step_s = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        loss = ex.run({"input_ids": x, "labels": y})[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    after = float(ex.evaluate(held)[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L * (steps + 2),
                flash_attention_bwd_dkv=L * steps,
                flash_attention_bwd_dq=L * steps)
    if counts != want:
        fail(f"training {dtype}: launches {counts}, want {want} ({L} "
             f"layers, {steps} steps, 2 eval forwards)")
    if not all(np.isfinite(losses + [before, after])):
        fail(f"training {dtype}: a loss is not finite: {losses}, eval "
             f"{before} -> {after}")
    if not after < before:
        fail(f"training {dtype}: the first batch's eval loss did not fall: "
             f"{before} -> {after}")
    med = float(np.median(step_s[warm:]))
    stats = dict(step_ms=med * 1e3, tokens_per_s=TB * TS / med,
                 peak_bytes=peak, losses=losses, eval_before=before,
                 eval_after=after, init_s=init_s)
    log(f"  train {dtype}: losses {[round(v, 4) for v in losses]}; eval "
        f"loss of the first step's batch {before:.4f} -> {after:.4f}; step "
        f"{stats['step_ms']:.1f} ms (median of steps {warm + 1}-{steps}; "
        f"first {step_s[0] * 1e3:.1f} ms), {stats['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {peak} B; model built in {init_s:.2f} s; "
        f"launches {counts}")
    if prof_dir is not None:
        for line in profile_steps(ex, iter(batches), 3,
                                  Path(prof_dir) / f"train_{dtype}"):
            log(f"  {dtype} {line}")
    return ex, stats, counts


def phase8(torch, F, htt, seed, card, prof_dir=None):
    """Training: 8a K3 (and K2 at the training shape), 8b GPT-2-small f32
    and bf16, 8c trained weights through the serving forward.  Returns
    ({kernel key: {dtype: result}}, {dtype: (stats, launches)})."""
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    kres = {}
    for dt in ("float32", "bfloat16"):
        check_k3_cases(torch, dt, seed)
        for key, r in check_k3(torch, F, dt, seed).items():
            kres.setdefault(key, {})[dt] = r
    cfg = htt.GPTConfig(batch_size=TB, seq_len=TS, dropout_rate=0.0)
    if not cfg.use_flash:
        fail("GPT-2-small at seq 1024 with dropout 0 should take the flash "
             "path")
    check_train_grads(torch, htt, cfg, seed)
    runs = {}
    ex, st, counts = train(torch, htt, cfg, "float32", seed,
                           prof_dir=prof_dir)
    runs["float32"] = (st, counts)
    # 8c: the trained f32 weights through the serving forward
    seq = np.random.RandomState(seed + 2).randint(0, cfg.vocab_size, TS)
    want = ex.evaluate({"input_ids": seq[None].astype(np.int32)})[0]
    got = teacher_forced_logits(htt.params_from_numpy(ex.model.var_values()),
                                cfg, seq, dtype=torch.float32)
    err = float((got - want).abs().max())
    if got.shape != want.shape or not err <= 1e-4:
        fail(f"serving logits of the trained weights differ from the "
             f"training model's eval logits: max abs err {err} (tol 1e-4), "
             f"shapes {tuple(got.shape)} / {tuple(want.shape)}")
    log(f"  trained f32 weights -> teacher_forced_logits on one {TS}-token "
        f"sequence == the training model's eval logits (max abs err "
        f"{err:.3e}, tol 1e-4)")
    del ex, want, got
    ex, st, counts = train(torch, htt, cfg, "bfloat16", seed,
                           prof_dir=prof_dir)
    runs["bfloat16"] = (st, counts)
    del ex
    for dt, (st, _) in runs.items():
        log(f"  training on {card}: GPT-2-small {dt} B {TB} S {TS}: step "
            f"{st['step_ms']:.1f} ms, {st['tokens_per_s']:.1f} tokens/s, "
            f"peak {st['peak_bytes'] / 2 ** 30:.2f} GiB")
    return kres, runs


# ---------------------------------------------------------------- #
# phase 9: context parallelism
# ---------------------------------------------------------------- #

# K2-carry vs its plain version: the output is f32 for both input dtypes
# and both sides accumulate in f32 over the same inputs (atol, rtol
# 1e-5); in bf16 the kernel also rounds P against its running max
# (flash_compare adds fa.bf16_rounding_bound of the rounded terms), and
# the f32 output adds no rounding (rtol stays 1e-5)
CARRY_TOL = (1e-5, 1e-5)
# the ring at full width: GPT-2-small's attention (12 heads of 64) over
# twice the 4096 tokens of examples/nlp/train_long_context.py, cp 4
RB, RS, CP = 1, 8192, 4
# ring forward vs whole-sequence K2: f32 the JAX tests' bound; bf16 the
# same atol plus fa.bf16_rounding_bound (the two round P against
# different running maxima: the ring's carry seeds each rotation with
# the last one's lse, whole-sequence K2 with nothing), and one ulp of
# rtol (both round an f32 result to bf16 once)
RING_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-5, 2.0 ** -7)}


def carry_inputs(torch, B, S, Sk, Hn, D, dtype, kind, seed):
    """q, k, v of ``dtype`` and a carry (o_c f32, lse_c f32): ``empty``
    (lse -1e30 everywhere), ``live``, or ``mixed`` (every third row
    empty)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, Hn, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, Hn, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    o_c = torch.randn((B, S, Hn, D), generator=g, device="cuda")
    lse_c = 2.0 * torch.randn((B, Hn, S), generator=g, device="cuda") + 3.0
    if kind == "empty":
        o_c.zero_()
        lse_c.fill_(-1e30)
    elif kind == "mixed":
        lse_c[..., ::3] = -1e30
    return q, k, v, o_c, lse_c


def carry_compare(torch, fa, args, causal):
    """(max abs error of o, the largest error of o over its bound, max
    abs error of the live lse, True when o is within CARRY_TOL (bf16:
    plus fa.bf16_rounding_bound), the lse within LSE_TOL and the dead
    rows agree)."""
    o, lse = fa.flash_fwd_carry(*args, causal=causal)
    o_r, lse_r = fa.flash_fwd_carry_reference(*args, causal=causal)
    q, k, v, _, lse_c = args
    atol = CARRY_TOL[0]
    if q.dtype == torch.bfloat16:
        atol = atol + fa.bf16_rounding_bound(q, k, v, causal=causal,
                                             lse_c=lse_c)
    err, ratio, o_ok = close(o, o_r, atol, CARRY_TOL[1])
    live = lse_r < 1e29
    lse_err = float((lse - lse_r)[live].abs().max()) if live.any() else 0.0
    ok = bool(o.dtype == torch.float32 and o_ok and lse_err <= LSE_TOL
              and (lse[~live] >= 1e29).all())
    return err, ratio, lse_err, ok


def check_carry(torch, dtype, seed):
    """9a: K2-carry against its plain version in small cases (head dims
    32/64/128; causal and not; an empty, live and mixed carry; S 100 and
    40, not multiples of the 32-row tile), then at the ring's block shape
    [1, 2048, 12, 64] with a live carry (a full rotation), timed beside
    its bound and its plain version."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    worst = worst_ratio = 0.0
    n = 0
    for D in (32, 64, 128):
        for causal, S, Sk in ((True, 100, 100), (False, 40, 72)):
            for kind in ("empty", "live", "mixed"):
                args = carry_inputs(torch, 3, S, Sk, 4, D, dtype, kind,
                                    seed + D + S)
                err, ratio, lse_err, ok = carry_compare(torch, fa, args,
                                                        causal)
                torch.cuda.synchronize()
                worst = max(worst, err)
                worst_ratio = max(worst_ratio, ratio)
                n += 1
                if not ok:
                    fail(f"K2-carry {dtype} D {D} causal {causal} S {S} Sk "
                         f"{Sk} carry {kind}: max abs err {err}, largest "
                         f"err / bound {ratio}, lse {lse_err} ((atol, "
                         f"rtol) {CARRY_TOL}, bf16 plus the rounding "
                         f"bound; lse {LSE_TOL})")
    log(f"  K2-carry {dtype}: {n} cases (D 32/64/128; causal and not; "
        f"carry empty, live, mixed; S 100/40) match the plain version, "
        f"max abs err {worst:.3e}, largest err / bound {worst_ratio:.4f} "
        f"((atol, rtol) {CARRY_TOL}, bf16 plus the rounding bound)")
    blk = RS // CP
    args = carry_inputs(torch, RB, blk, blk, H, DH, dtype, "live",
                        seed + 40)
    err, ratio, lse_err, ok = carry_compare(torch, fa, args, False)
    if not ok:
        fail(f"K2-carry {dtype} at the ring's block shape: max abs err "
             f"{err}, largest err / bound {ratio}, lse {lse_err}")
    ms = time_ms(torch, lambda: fa.flash_fwd_carry(*args))
    run_ms = time_run_ms(torch, lambda: fa.flash_fwd_carry(*args))
    dev = device_ms(torch, lambda: fa.flash_fwd_carry(*args))
    plain_ms = time_ms(torch, lambda: fa.flash_fwd_carry_reference(*args),
                       reps=5)
    # q, k, v read once, o_c and lse_c read once, o (f32) and lse
    # written once; every (q, k) pair of the full block is live
    es = args[0].element_size()
    n_el = RB * blk * H * DH
    nbytes = 3 * n_el * es + 2 * n_el * 4 + 2 * RB * H * blk * 4
    flops = 4 * RB * H * blk * blk * DH
    b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
    log(f"  K2-carry flash_attention_carry {dtype} [{RB},{blk},{H},{DH}] "
        f"full rotation, live carry: max_abs_err {err:.3e}, largest err "
        f"/ bound {ratio:.4f}, lse "
        f"{lse_err:.3e}; kernel {ms:.4f} ms ({run_ms:.4f} back to back, "
        f"{ms_text(dev)} on the device), plain {plain_ms:.4f} ms, no "
        f"single PyTorch call computes a carried forward; bound "
        f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop"
        f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    return dict(err=max(worst, err), ratio=ratio, ms=ms, run_ms=run_ms,
                dev_ms=dev, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_ring(torch, F, htt, dtype, causal, seed):
    """9b: the cp-4 ring (``impl=None``, so the flash path on the card) on
    a virtual mesh of the card at B 1, S 8192, 12 heads of 64, against
    K2 (forward) and K2 + K3 (gradients of sum(o * g)) over the whole
    sequence, with exact launch counts; times of both and of SDPA, peak
    memory.  Returns the forward's launch counts and the numbers."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.parallel import make_mesh, ring_attention
    mesh = make_mesh({"cp": CP})
    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    dt = getattr(torch, dtype)
    q, k, v, go = (torch.randn((RB, RS, H, DH), generator=g,
                               device="cuda").to(dt) for _ in range(4))
    live = CP + CP * (CP - 1) // 2 if causal else CP * CP

    def ring(*a):
        return ring_attention(*a, mesh=mesh, causal=causal)

    def whole(*a):
        return fa.flash_attention(*a, causal=causal)

    tag = f"ring {dtype} {'causal' if causal else 'full'}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launches()
    o = ring(*xs)
    torch.cuda.synchronize()
    fwd_counts = launch_counts()
    reset_launches()
    grads = torch.autograd.grad(o, xs, go)
    torch.cuda.synchronize()
    bwd_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want_f = dict.fromkeys(fwd_counts, 0)
    want_f["flash_attention_carry"] = live
    want_b = dict.fromkeys(bwd_counts, 0)
    want_b.update(flash_attention_bwd_dkv=live, flash_attention_bwd_dq=live)
    if fwd_counts != want_f or bwd_counts != want_b:
        fail(f"{tag}: forward launches {fwd_counts} (want {want_f}), "
             f"backward {bwd_counts} (want {want_b})")
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    o_w = whole(*ys)
    want = torch.autograd.grad(o_w, ys, go)
    f_atol, f_rtol = RING_TOL[dtype]
    if dtype == "bfloat16":
        f_atol = f_atol + fa.bf16_rounding_bound(q, k, v, causal=causal)
    err, ratio, ok = close(o, o_w, f_atol, f_rtol)
    if not ok:
        fail(f"{tag}: forward max abs err {err}, largest err / bound "
             f"{ratio}, vs whole-sequence K2 ((atol, rtol) "
             f"{RING_TOL[dtype]}, bf16 plus the rounding bound)")
    g_errs = []
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        m = float(b.float().abs().max())
        atol = (1e-4 if dtype == "float32" else CP * 2.0 ** -7) * m
        e, _, ok = close(a, b, atol, 0.0)
        g_errs.append(e / m)
        if not ok:
            fail(f"{tag}: {name} max abs err {e} vs K2 + K3 over the "
                 f"whole sequence (atol {atol}: "
                 f"{'1e-4' if dtype == 'float32' else f'{CP} bf16 ulps'} "
                 f"of the max {m})")

    def ring_fb():
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(ring(*zs), zs, go)

    def whole_fb():
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(whole(*zs), zs, go)

    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, go))

    def sdpa_fb():
        zs = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        torch.autograd.grad(F.scaled_dot_product_attention(
            *zs, is_causal=causal), zs, gt)

    with torch.no_grad():
        t_ring = time_ms(torch, lambda: ring(q, k, v), reps=5, warm=1)
        t_whole = time_ms(torch, lambda: whole(q, k, v), reps=5, warm=1)
        t_sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=5, warm=1)
    tb_ring = time_ms(torch, ring_fb, reps=3, warm=1)
    tb_whole = time_ms(torch, whole_fb, reps=3, warm=1)
    tb_sdpa = time_ms(torch, sdpa_fb, reps=3, warm=1)
    log(f"  {tag} cp {CP} [{RB},{RS},{H},{DH}]: forward max abs err "
        f"{err:.3e} vs whole-sequence K2, largest err / bound "
        f"{ratio:.4f} ((atol, rtol) {RING_TOL[dtype]}, bf16 plus the "
        f"rounding bound); gradients' max err / max |g| "
        f"{max(g_errs):.3e}; launches forward {live} K2-carry, backward "
        f"{live} of each K3 kernel; forward {t_ring:.4f} ms (whole K2 "
        f"{t_whole:.4f}, SDPA {t_sdpa:.4f}); forward + backward "
        f"{tb_ring:.4f} ms (whole K2 + K3 {tb_whole:.4f}, SDPA "
        f"{tb_sdpa:.4f}); peak {peak / 2 ** 20:.1f} MiB")
    return fwd_counts, dict(err=err, ring_ms=t_ring, whole_ms=t_whole,
                            sdpa_ms=t_sdpa, ring_fb_ms=tb_ring,
                            whole_fb_ms=tb_whole, sdpa_fb_ms=tb_sdpa,
                            peak_bytes=peak)


def check_ulysses(torch, dtype, seed):
    """9c: Ulysses (cp 4) on a virtual mesh of the card with the port's
    flash_attention as attn_fn: within 1e-6 of K2 over the whole
    sequence (each head group runs the same per-head arithmetic), with
    cp K2 launches; its forward and forward + backward times."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.parallel import make_mesh, ulysses_attention
    mesh = make_mesh({"cp": CP})
    g = torch.Generator(device="cuda").manual_seed(seed + 60)
    q, k, v, go = (torch.randn((RB, RS, H, DH), generator=g,
                               device="cuda").to(getattr(torch, dtype))
                   for _ in range(4))

    def uly(*a):
        return ulysses_attention(*a, mesh=mesh, causal=True,
                                 attn_fn=lambda q, k, v, c:
                                 fa.flash_attention(q, k, v, causal=c))

    reset_launches()
    got = uly(q, k, v)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = fa.flash_attention(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    n = counts["flash_attention"]
    if not err <= 1e-6 or n != CP or sum(counts.values()) != CP:
        fail(f"ulysses {dtype}: max abs err {err} vs whole-sequence K2 "
             f"(tol 1e-6), launches {counts} (want {CP} flash_attention)")

    def uly_fb():
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(uly(*zs), zs, go)

    with torch.no_grad():
        t_fwd = time_ms(torch, lambda: uly(q, k, v), reps=5, warm=1)
    t_fb = time_ms(torch, uly_fb, reps=3, warm=1)
    log(f"  ulysses {dtype} cp {CP} [{RB},{RS},{H},{DH}] causal, K2 as "
        f"attn_fn: max abs err {err:.3e} vs whole-sequence K2 (tol 1e-6), "
        f"{n} K2 launches; forward {t_fwd:.4f} ms, forward + backward "
        f"{t_fb:.4f} ms")


def phase9(torch, F, htt, seed):
    """Context parallelism: 9a K2-carry, 9b the ring, 9c Ulysses.
    Returns ({dtype: K2-carry result}, {dtype: the causal ring's forward
    launches})."""
    kres, counts = {}, {}
    for dt in ("float32", "bfloat16"):
        kres[dt] = check_carry(torch, dt, seed)
    for dt in ("float32", "bfloat16"):
        for causal in (True, False):
            c, _ = check_ring(torch, F, htt, dt, causal, seed)
            if causal:
                counts[dt] = c
    for dt in ("float32", "bfloat16"):
        check_ulysses(torch, dt, seed)
    return kres, counts

# ---------------------------------------------------------------- #
# phase 10: MoE serving
# ---------------------------------------------------------------- #

# the flagship MoE GPT at GPT-2-small width (the JAX package's
# bench.py MoE cell): 4 experts, top-2, capacity factor 2.0, every
# second block routed (six MoE blocks), experts of ffn_size / top_k =
# 1536 wide, so that the active FFN parameters equal the dense model's
MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0, moe_every=2,
           expert_size=1536)


@contextlib.contextmanager
def moe_calls(torch, annotate=False):
    """Count the serving cores' ``moe_ffn`` calls while the block runs;
    with ``annotate`` each call also runs under
    ``torch.profiler.record_function("moe_ffn")``, so that a profile
    gives the device time of its kernels (gate, dispatch, the two bmm,
    combine)."""
    from hetu_tpu_torch.models import gpt_decode as gd
    inner = gd.moe_ffn
    seen = collections.Counter()

    def counted(*a, **kw):
        seen["calls"] += 1
        if not annotate:
            return inner(*a, **kw)
        with torch.profiler.record_function("moe_ffn"):
            return inner(*a, **kw)

    gd.moe_ffn = counted
    try:
        yield seen
    finally:
        gd.moe_ffn = inner


def moe_profile(torch, htt, params, cfg, spec, dtype, windows=((0, 6),
                                                                (40, 46))):
    """The paged mixed MoE engine on the request set, ``windows`` of its
    steps (the prompt-chunk waves first, then decode waves) under
    torch.profiler: device ms of the MoE FFN (the kernels launched
    inside ``moe_ffn``) and of attention (K1), the device's busy ms and
    the window's wall.  Returns [{window, wall_ms, busy_ms, moe_ms,
    attn_ms, matmul_ms, moe_calls}]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hetu_tpu_torch.serving import Request
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=getattr(torch, dtype),
                            **CONFIGS["paged-mixed"])
    for i, (pr, t, k) in enumerate(spec):
        eng.submit(Request(prompt=pr, max_new_tokens=64, temperature=t,
                           top_k=k, seed=i, request_id=f"r{i}"))
    out = []
    for a, b in windows:
        while eng.steps < a:
            eng.step()
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof, moe_calls(torch, annotate=True) as seen:
            t0 = time.perf_counter()
            while eng.steps < b:
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = prof.key_averages()
        kern = [e for e in rows if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0 and e.key != "moe_ffn"]
        if not kern:
            fail("the profiler recorded no device time")
        ms = {"busy": 0.0, "attn": 0.0, "matmul": 0.0}
        for e in kern:
            t_ms = e.self_device_time_total / 1e3
            ms["busy"] += t_ms
            kind = kind_of(e.key)
            if re.match(r"K\d", kind):
                ms["attn"] += t_ms
            elif kind == "matmul":
                ms["matmul"] += t_ms
        # the kernels launched under the annotation, and the span the
        # annotation covers on the device's timeline (gaps included)
        moe = [e for e in rows if e.key == "moe_ffn"]
        moe_ms = sum(e.device_time_total for e in moe
                     if e.device_type == DeviceType.CPU) / 1e3
        span_ms = sum(e.self_device_time_total for e in moe
                      if e.device_type == DeviceType.CUDA) / 1e3
        if moe_ms <= 0 and span_ms <= 0:
            fail("the profiler attributed no device time to moe_ffn")
        out.append(dict(window=(a, b), wall_ms=wall * 1e3,
                        busy_ms=ms["busy"], moe_ms=moe_ms,
                        moe_span_ms=span_ms, attn_ms=ms["attn"],
                        matmul_ms=ms["matmul"], moe_calls=seen["calls"]))
    eng.run()
    return out


def phase10(torch, htt, seed, spec, prompts, dense, card):
    """MoE serving at GPT-2-small width (``MOE``): offline
    ``generate_fast``, the four engine configurations, speculation, an
    int8 cache, a binding capacity and the dense oracle, each held to
    the checks the docstring lists.  ``dense``: phases 4-5's
    {(config, dtype): (results, launches, stats)} of the dense model on
    the same requests."""
    from hetu_tpu_torch.models import moe_decode as md
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    t10 = time.perf_counter()
    cfg = md.MoEDecodeConfig(**MOE)
    L, E, k = cfg.num_hidden_layers, cfg.num_experts, cfg.top_k
    n_moe = md.moe_spec_of(cfg).moe_layers(L)
    t0 = time.perf_counter()
    npp = md.init_moe_params(cfg, name="gpt", seed=seed)
    n_par = sum(v.size for v in npp.values())
    per_expert = sum(v[0].size for n, v in npp.items()
                     if "_moe_expert_stack_" in n) // n_moe
    params = htt.params_from_numpy(npp)
    del npp
    log(f"  MoE GPT-2-small ({E} experts, top-{k}, capacity factor "
        f"{cfg.capacity_factor}, {n_moe} MoE blocks, experts "
        f"{cfg.expert_size} wide): {n_par} parameters, "
        f"{n_par - n_moe * (E - k) * per_expert} active per token; "
        f"weights from seed {seed} in {time.perf_counter() - t0:.2f} s")

    # offline, then the four configurations in f32
    off, _ = offline(torch, htt, params, cfg, prompts, "float32")
    runs = {}
    for config in CONFIGS:
        runs[config, "float32"] = serve(torch, htt, params, cfg, spec,
                                        "float32", config)
    res32 = runs["paged-mixed", "float32"][0]
    for i in range(len(prompts)):
        got = res32[f"r{i}"].tokens[128:128 + 32]
        if list(got) != list(off[i, 128:]):
            fail(f"MoE f32 engine greedy tokens of r{i} differ from "
                 f"generate_fast")
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    for config in CONFIGS:
        res = runs[config, "float32"][0]
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(res32[f"r{i}"].tokens)]
        if bad:
            fail(f"MoE {config} f32 greedy tokens differ from paged-mixed "
                 f"for requests {bad}")
    log(f"  MoE f32: paged-mixed greedy == generate_fast ({len(prompts)} "
        f"prompts); every layout's greedy tokens == paged-mixed's "
        f"({len(greedy)} requests)")

    # bf16 under the dense bf16 engine's margin gate
    runs["paged-mixed", "bfloat16"] = serve(torch, htt, params, cfg, spec,
                                            "bfloat16", "paged-mixed")
    res16 = runs["paged-mixed", "bfloat16"][0]
    oracle = {}
    gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                         res16[f"r{i}"].tokens, len(spec[i][0]), oracle,
                         low="bf16") for i in greedy]
    log(f"  MoE bf16 paged-mixed: greedy tokens == f32's for "
        f"{sum(g is None for g in gates)} of {len(greedy)} requests, the "
        f"rest first differ within the bf16 margin gate (position, exact "
        f"top-2 margin, delta): {[g for g in gates if g is not None]}")

    # speculation: the draft routes nothing
    with moe_calls(torch) as seen:
        sres, _, sst = serve(torch, htt, params, cfg, spec, "float32",
                             "paged-split", spec=4)
    plain = runs["paged-split", "float32"][0]
    bad = [i for i in range(len(spec))
           if list(sres[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
    if bad:
        fail(f"MoE spec 4 paged-split f32 tokens differ from the "
             f"non-speculative run for requests {bad}")
    target_calls = sst["prefill_dispatches"] + sst["steps"]
    if seen["calls"] != n_moe * target_calls:
        fail(f"MoE spec: {seen['calls']} moe_ffn calls, want {n_moe} x "
             f"{target_calls} target calls (the draft routes nothing)")
    log(f"  MoE spec 4 paged-split f32: all {len(spec)} requests' tokens "
        f"== non-speculative; moe_ffn calls {seen['calls']} = {n_moe} x "
        f"{target_calls} target calls, none from the draft "
        f"({sst['draft_prefills']} draft prefills, {sst['spec_waves']} "
        f"waves)")

    # int8 cache under phase 7's margin gate
    ires = serve(torch, htt, params, cfg, spec, "float32", "paged-mixed",
                 kv_quant="int8")[0]
    oracle = {}
    gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                         ires[f"r{i}"].tokens, len(spec[i][0]), oracle)
             for i in greedy]
    log(f"  MoE int8 paged-mixed f32: greedy tokens == f32's for "
        f"{sum(g is None for g in gates)} of {len(greedy)} requests, the "
        f"rest first differ within the int8 margin gate: "
        f"{[g for g in gates if g is not None]}")

    # a capacity that binds
    bcfg = md.MoEDecodeConfig(**dict(MOE, capacity_factor=0.25))
    _, _, bst = serve(torch, htt, params, bcfg, spec, "float32",
                      "paged-mixed")
    if not sum(bst["expert_drops"]):
        fail("MoE capacity factor 0.25: no token was dropped")
    log(f"  MoE capacity factor 0.25 paged-mixed f32: drops "
        f"{bst['expert_drops']} (rate {bst['expert_drop_rate']:.4f}), "
        f"load + drop == positions x {k} x {n_moe} on all "
        f"{bst['moe_steps']} step records")

    # the dense oracle: phase 3's weights, experts replicated, k = E
    dcfg = htt.GPTConfig()
    dnp = gpt2_small_params(dcfg, seed)
    ocfg = md.MoEDecodeConfig(num_experts=4, top_k=4, capacity_factor=2.0,
                              moe_every=2)
    mp = md.convert_dense_to_moe(dnp, dcfg, ocfg, name="gpt")
    seq = np.random.default_rng(seed + 10).integers(0, dcfg.vocab_size,
                                                    1024)
    want = teacher_forced_logits(dnp, dcfg, seq, dtype=torch.float32)
    got = teacher_forced_logits(mp, ocfg, seq, dtype=torch.float32)
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        fail(f"dense oracle: max |MoE - dense| logit {err:.3e} > 1e-4")
    log(f"  dense oracle (phase 3's weights, 4 replicated experts, top-4, "
        f"1024 tokens): max |MoE - dense| teacher-forced logit {err:.3e} "
        f"<= 1e-4 (logits up to {float(want.abs().max()):.3f})")
    del dnp, mp

    # device time of the MoE FFN against attention, and the host share
    for dt in ("float32", "bfloat16"):
        for w in moe_profile(torch, htt, params, cfg, spec, dt):
            a, b = w["window"]
            log(f"  MoE profile paged-mixed {dt} steps {a}-{b - 1} on "
                f"{card}: MoE FFN {w['moe_ms']:.3f} ms of kernels "
                f"({w['moe_span_ms']:.3f} ms annotated span, "
                f"{w['moe_calls']} calls) vs attention (K1) "
                f"{w['attn_ms']:.3f} ms; all "
                f"matmuls {w['matmul_ms']:.3f} ms; device busy "
                f"{w['busy_ms']:.3f} of {w['wall_ms']:.3f} ms wall, host "
                f"share {1 - w['busy_ms'] / w['wall_ms']:.1%}")
    for (config, dt), (_, _, st) in runs.items():
        d = dense[config, dt][2]
        log(f"  MoE serving on {card}: {config} {dt} "
            f"{st['tokens_per_s']:.1f} tok/s (dense {d['tokens_per_s']:.1f}),"
            f" TTFT p50 {st['ttft_p50_ms']:.1f} (dense "
            f"{d['ttft_p50_ms']:.1f}) p99 {st['ttft_p99_ms']:.1f} (dense "
            f"{d['ttft_p99_ms']:.1f}) ms; expert load {st['expert_load']}, "
            f"imbalance {st['expert_imbalance']:.4f}, drop rate "
            f"{st['expert_drop_rate']:.4f}")
    log(f"  phase 10 in {time.perf_counter() - t10:.1f} s")


# ---------------------------------------------------------------- #
# phase 11: the serving fleet
# ---------------------------------------------------------------- #

# replica 0 dies at its 12th step of the fleet's run (mid-run: its
# slots full, its queue not empty)
FLEET_CHAOS = "seed=11,kill=12,role=replica0"
# the host tier's fleet: a pool of 44 blocks (43 usable), which the
# longest request (600 + 64 positions, 42 blocks) fits, but not beside
# the 11 blocks the shared prefix's registration holds
TIER_POOL_BLOCKS = 44
# the host ring: large enough to hold every prefix the 11d run evicts
# (~2.6 GB of f32 payloads: each cut of each evicted prompt spills), so
# the shared prefix is still there when its second user arrives
TIER_HOST_BYTES = 4 << 30


def fleet_requests(Request, spec, ids=None):
    """Phase 4's requests (ids r0..r15, seeds 0..15), all or ``ids``."""
    return [Request(prompt=pr, max_new_tokens=64, temperature=t, top_k=k,
                    seed=i, request_id=f"r{i}")
            for i, (pr, t, k) in enumerate(spec)
            if ids is None or i in ids]


def fleet_engine(torch, htt, params, cfg, **kw):
    """One replica: phase 4's engine (paged 16, mixed waves: the auto
    settings on CUDA), f32, 8 slots, its own copy of ``params`` (host
    numpy: each replica copies them onto the card, so a rolling swap
    reaches one replica at a time).  ``eng.launches`` counts the
    launches of its own steps (``launch_counts`` deltas)."""
    from hetu_tpu_torch.kernels import launch_counts
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=torch.float32,
                            **CONFIGS["paged-mixed"], **kw)
    if (eng.paged, eng.ragged, eng.kv.block) != (True, True, 16):
        fail(f"fleet replica: paged={eng.paged} ragged={eng.ragged} "
             f"block {eng.kv.block}, want the auto paged mixed engine")
    eng.launches = collections.Counter()
    step = eng.step

    def counted_step():
        before = launch_counts()
        out = step()
        for k, v in launch_counts().items():
            eng.launches[k] += v - before[k]
        return out

    eng.step = counted_step
    return eng


def timed(torch, obj, name, log_to):
    """Wrap ``obj.name`` so each call appends (ms, result) to ``log_to``,
    the card synchronised before and after."""
    fn = getattr(obj, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log_to.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    setattr(obj, name, call)


def fleet_tokens_equal(res, ref, ids, what):
    bad = [i for i in ids
           if list(res[f"r{i}"].tokens) != list(ref[f"r{i}"].tokens)]
    if bad:
        fail(f"{what}: tokens of requests {bad} differ")


def exact_engine_launches(eng, L, what):
    want = {k: v for k, v in want_launches(eng, L).items() if v}
    got = {k: v for k, v in eng.launches.items() if v}
    if got != want:
        fail(f"{what}: launches {got}, want {want}")
    return got


def fleet_stats(res, sec, snap):
    gen = sum(r.n_generated for r in res.values())
    return dict(tokens_per_s=gen / sec, seconds=sec, generated=gen,
                ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
                ttft_p99_ms=snap["ttft_p99_s"] * 1e3)


def checksum(torch, params):
    return torch.stack([t.double().sum() for t in params.values()]).cpu()


def phase11(torch, htt, cfg, seed, spec, res32, st4, card):
    """The serving fleet: two replicas of phase 4's engine behind
    ``ServingRouter``; phase 4's requests; every gate below fails the
    run."""
    import os
    import tempfile

    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.ps import faults
    from hetu_tpu_torch.serving import (Request, ServingRouter,
                                        WeightSyncCoordinator)
    from hetu_tpu_torch.telemetry import trace
    L = cfg.num_hidden_layers
    t_phase = time.perf_counter()
    p1 = gpt2_small_params(cfg, seed)
    n = len(spec)
    everyone = range(n)
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    env0 = {k: os.environ.get(k) for k in (
        "HETU_CHAOS", "HETU_SERVE_LOG", "HETU_HANDOFF_QUANT",
        "HETU_KV_HOST_BYTES", "HETU_TELEMETRY")}

    def setenv(**kw):
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset_plans()
        telemetry.reset()

    try:
        setenv(HETU_TELEMETRY="1")
        # ---- the fleet, then 11a: a seeded chaos kill ---- #
        for label, chaos in (("fleet", None), ("11a chaos kill",
                                                FLEET_CHAOS)):
            slog = os.path.join(tmp, f"{label.split()[0]}.jsonl")
            setenv(HETU_CHAOS=chaos, HETU_SERVE_LOG=slog)
            router = ServingRouter(
                lambda i: fleet_engine(torch, htt, p1, cfg), replicas=2,
                restart_backoff=0.0)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = router.run(fleet_requests(Request, spec))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            # supervision goes on past the run: a killed replica's
            # respawn lands within a few router steps
            deadline = time.perf_counter() + 60
            while any(r.state != "up" for r in router.replicas) \
                    and time.perf_counter() < deadline:
                router.step()
            snap = router.snapshot()
            if len(res) != n or snap["finished"] != n or snap["lost"] \
                    or snap["duplicates"]:
                fail(f"{label}: {len(res)} results, finished "
                     f"{snap['finished']}, lost {snap['lost']}, duplicates "
                     f"{snap['duplicates']} of {n} requests")
            fleet_tokens_equal(res, res32, everyone,
                               f"{label} vs phase 4 (f32, greedy and "
                               f"sampled)")
            events, bad = trace.read_events([slog])
            finishes = collections.Counter(
                e["request"] for e in events
                if e["event"] == "serve_finish")
            hops = [e for e in events if e["event"] == "router_hop"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = trace.main([slog, "--check"])
            if bad or rc:
                fail(f"{label}: trace --check rc {rc} ({bad} bad "
                     f"records): {buf.getvalue()[-800:]}")
            st = fleet_stats(res, sec, snap)
            routed = [row["routed"] for row in snap["replicas"]]
            if chaos is None:
                counts = launch_counts()
                per = [exact_engine_launches(r.engine, L,
                                             f"fleet replica {r.index}")
                       for r in router.replicas]
                k1 = sum(p.get("ragged_paged_attention", 0) for p in per)
                if counts["ragged_paged_attention"] != k1 or min(routed) < 1:
                    fail(f"fleet: K1 launches {counts}, the replicas' "
                         f"{per}; routed {routed}")
                st_fleet = st
                log(f"  fleet of 2 on {card}: {n} requests routed {routed}, "
                    f"all tokens == phase 4's; K1 launched {k1} times "
                    f"(layers x steps of each replica); "
                    f"{st['generated']} tokens in {st['seconds']:.3f} s = "
                    f"{st['tokens_per_s']:.1f} tok/s, fleet TTFT p50 "
                    f"{st['ttft_p50_ms']:.1f} ms p99 "
                    f"{st['ttft_p99_ms']:.1f} ms (phase 4's one engine "
                    f"{st4['tokens_per_s']:.1f} tok/s, TTFT p50 "
                    f"{st4['ttft_p50_ms']:.1f} p99 {st4['ttft_p99_ms']:.1f} "
                    f"ms); trace --check clean")
            else:
                peer = [e for e in hops if e.get("from_replica") == 0
                        and e.get("to_replica") == 1]
                if not peer or snap["requeued"] < 1 \
                        or snap["replicas"][0]["restarts"] != 1 \
                        or any(v != 1 for v in finishes.values()) \
                        or len(finishes) != n:
                    fail(f"11a: hops {len(hops)} (to the peer "
                         f"{len(peer)}), requeued {snap['requeued']}, "
                         f"restarts {snap['replicas'][0]['restarts']}, "
                         f"serve_finish per request {dict(finishes)}")
                log(f"  11a: {FLEET_CHAOS} killed replica 0; "
                    f"{snap['requeued']} requests requeued, "
                    f"{len(peer)} router_hop events to replica 1, replica 0 "
                    f"restarted once; every request retired once, routed "
                    f"{routed}; all tokens == phase 4's; trace --check "
                    f"clean; {st['tokens_per_s']:.1f} tok/s, TTFT p50 "
                    f"{st['ttft_p50_ms']:.1f} ms p99 "
                    f"{st['ttft_p99_ms']:.1f} ms")
            del router
            torch.cuda.empty_cache()
        setenv(HETU_CHAOS=None, HETU_SERVE_LOG=None)

        # ---- 11b: prefill on A, decode on B, over both wires ---- #
        oracle, wires = {}, {}
        for wire in ("auto", "int8"):
            setenv(HETU_HANDOFF_QUANT=wire)
            exports, imports = [], []
            router = ServingRouter(
                lambda i: fleet_engine(torch, htt, p1, cfg), replicas=2,
                roles="prefill,decode")
            a, b = (r.engine for r in router.replicas)
            timed(torch, a.kv, "export_blocks", exports)
            timed(torch, b.kv, "import_blocks", imports)
            reset_launches()
            res = router.run(fleet_requests(Request, spec))
            torch.cuda.synchronize()
            snap = router.snapshot()
            # a handoff B's pool cannot take yet (no free slot to write
            # through) degrades to a cold prefill there, as in the JAX
            # package: counted, never lost
            moved = snap["handoffs"]
            if len(res) != n or snap["lost"] or moved < 1 or moved \
                    + snap["handoff_failed"] + snap["handoffs_skipped"] != n:
                fail(f"11b {wire}: {len(res)} results, lost "
                     f"{snap['lost']}, {moved} handoffs, "
                     f"{snap['handoff_failed']} failed, "
                     f"{snap['handoffs_skipped']} skipped of {n}")
            la = exact_engine_launches(a, L, "11b replica A")
            lb = exact_engine_launches(b, L, "11b replica B")
            if lb.get("ragged_paged_attention", 0) < L or \
                    b.kv.imports < moved or b.kv.prefix_hits < moved:
                fail(f"11b {wire}: replica B launched {lb}, imported "
                     f"{b.kv.imports} spans, {b.kv.prefix_hits} prefix "
                     f"hits on them")
            if wire == "auto":
                fleet_tokens_equal(res, res32, everyone,
                                   "11b exact wire vs phase 4")
                gates = []
            else:
                gates = [margin_gate(torch, p1, cfg, res32[f"r{i}"].tokens,
                                     res[f"r{i}"].tokens, len(spec[i][0]),
                                     oracle) for i in greedy]
            ex_ms = [ms for ms, _ in exports]
            im_ms = [ms for ms, slot in imports if slot is not None]
            nbytes = [p["nbytes"] for _, p in exports]
            raw = [p["raw_nbytes"] for _, p in exports]
            wires[wire] = dict(
                exports=len(exports), export_ms=float(np.median(ex_ms)),
                import_ms=float(np.median(im_ms)), bytes=int(sum(nbytes)),
                raw_bytes=int(sum(raw)), quant=exports[0][1]["quant"])
            w = wires[wire]
            log(f"  11b {wire} wire on {card}: {moved} of {n} requests' "
                f"KV moved A -> B, {snap['handoff_failed']} admitted cold "
                f"on B (no free slot to import through) "
                f"({w['quant'] or 'exact'} payloads), {w['bytes']} B "
                f"on the wire for {w['raw_bytes']} f32-equivalent B "
                f"({w['bytes'] / w['raw_bytes']:.4f}); export median "
                f"{w['export_ms']:.3f} ms (max {max(ex_ms):.3f}), import "
                f"median {w['import_ms']:.3f} ms (max {max(im_ms):.3f}) a "
                f"request; B launched {lb} over {b.kv.imports} imported "
                f"spans, A {la}; "
                + ("all tokens == phase 4's" if wire == "auto" else
                   f"f32 greedy tokens identical to phase 4's for "
                   f"{sum(g is None for g in gates)} of {len(greedy)}, "
                   f"the rest within the margin gate: "
                   f"{[g for g in gates if g is not None]}"))
            del router, a, b
            torch.cuda.empty_cache()
        setenv(HETU_HANDOFF_QUANT=None)

        # ---- 11c: a rolling swap to v2 ---- #
        p2 = gpt2_small_params(cfg, seed + 1)
        swaps = []

        def swap_engine(i):
            eng = fleet_engine(torch, htt, p1, cfg)
            timed(torch, eng, "swap_params", swaps)
            return eng

        router = ServingRouter(swap_engine, replicas=2)
        coord = WeightSyncCoordinator(router, p1, version=1)
        engines = [r.engine for r in router.replicas]
        ptrs = [{k: t.data_ptr() for k, t in e.params.items()}
                for e in engines]
        if not coord.begin(p2, 2):
            fail("11c: the coordinator refused the v2 push")
        live = router.run(fleet_requests(Request, spec))
        coord.drain()
        if coord.state != "done" or coord.committed_version != 2 \
                or coord.fleet_versions() != {0: 2, 1: 2} \
                or [r.engine for r in router.replicas] != engines:
            fail(f"11c: rollout {coord.state}, committed "
                 f"{coord.committed_version}, versions "
                 f"{coord.fleet_versions()}: {coord.last}")
        fresh = fleet_engine(torch, htt, p2, cfg)
        want2 = fresh.run(fleet_requests(Request, spec))
        del fresh
        v1 = [i for i in everyone if live[f"r{i}"].weight_version == 1]
        v2 = [i for i in everyone if live[f"r{i}"].weight_version == 2]
        if len(v1) + len(v2) != n:
            fail("11c: results stamped neither v1 nor v2")
        fleet_tokens_equal(live, res32, v1, "11c v1-stamped vs phase 4")
        fleet_tokens_equal(live, want2, v2, "11c v2-stamped vs a fresh v2 "
                           "engine")
        after = router.run([Request(prompt=r.prompt,
                                    max_new_tokens=64,
                                    temperature=r.temperature,
                                    top_k=r.top_k, seed=r.seed,
                                    request_id=r.request_id + "v2")
                            for r in fleet_requests(Request, spec)])
        if any(r.weight_version != 2 for r in after.values()):
            fail("11c: a request after the commit is not stamped v2")
        fleet_tokens_equal({k[:-2]: v for k, v in after.items()}, want2,
                           everyone, "11c after the commit vs a fresh v2 "
                           "engine")
        if [{k: t.data_ptr() for k, t in e.params.items()}
                for e in engines] != ptrs:
            fail("11c: a resident tensor moved during the swap")
        sums = [checksum(torch, e.params) for e in engines]
        bad = dict(p2)
        key = f"gpt_h{L - 1}_ffn_wo_weight"
        bad[key] = np.zeros((3, 3), np.float32)
        coord.begin(bad, 3)
        coord.drain()
        if coord.committed_version != 2 or coord.last["state"] == "done" \
                or any(not torch.equal(s, checksum(torch, e.params))
                       for s, e in zip(sums, engines)):
            fail(f"11c: a push with a wrong shape ({key}) was not refused "
                 f"cleanly: {coord.last}, committed "
                 f"{coord.committed_version}")
        swap_ms = [ms for ms, _ in swaps]
        param_bytes = sum(t.numel() * t.element_size()
                          for t in engines[0].params.values())
        log(f"  11c on {card}: v1 -> v2 rolled over both replicas under "
            f"live traffic ({len(v1)} requests retired on v1, {len(v2)} on "
            f"v2, each equal to its version's engine); after the commit "
            f"every replica at v2 and all {n} requests stamped v2 == a "
            f"fresh v2 engine's tokens; no resident tensor moved; "
            f"swap_params median {np.median(swap_ms):.1f} ms (max "
            f"{max(swap_ms):.1f}, {len(swap_ms)} swaps of {param_bytes} "
            f"B); a push with {key} of shape (3, 3) refused "
            f"({coord.last['state']}), params unchanged")
        del router, coord, engines
        torch.cuda.empty_cache()

        # ---- 11d: the host tier ---- #
        setenv(HETU_KV_HOST_BYTES=str(TIER_HOST_BYTES))
        router = ServingRouter(
            lambda i: fleet_engine(torch, htt, p1, cfg,
                                   pool_blocks=TIER_POOL_BLOCKS),
            replicas=2)
        if router.kv_tiers is None:
            fail("11d: HETU_KV_HOST_BYTES built no tier store")
        waves = ([4], list(range(8, n)), [5, 6, 7])
        res = {}
        for ids in waves:
            res.update(router.run(fleet_requests(Request, spec, ids)))
        spills = sum(r.engine.kv.spills for r in router.replicas)
        st = router.kv_tiers.stats()
        fetched = router.kv_tiers.fetches["host"]
        if spills < 1 or fetched < 1:
            fail(f"11d: {spills} spills, {fetched} host fetches: {st}")
        ids = [i for w in waves for i in w]
        fleet_tokens_equal(res, res32, ids, "11d vs phase 4")
        log(f"  11d on {card}: pools of {TIER_POOL_BLOCKS} blocks, "
            f"HETU_KV_HOST_BYTES {TIER_HOST_BYTES}: {spills} prefix spills "
            f"into the host ring, {fetched} fetched back at admission "
            f"({router.kv_tiers.fetch_bytes} B), "
            f"{sum(r.engine.kv.prefix_hits for r in router.replicas)} "
            f"prefix hits; the {len(ids)} requests' tokens == phase 4's")
        del router
        torch.cuda.empty_cache()
    finally:
        setenv(**env0)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return st_fleet, wires, swap_ms


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
                    help="profile the serving runs (after the checks) and "
                         "three training steps, and write device time by "
                         "kernel into DIR")
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
    paths = _build.build_all()
    log(f"  kernels built (or found built) in "
        f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_ROOT}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    tc_report(_build, paths)
    map_us = tma_map_us(_build)
    log(f"  bf16 K2's three TMA tensor maps, encoded on the host on each "
        f"call: {map_us:.3f} us a call")

    # ---- phase 2 ---- #
    log("phase 2: kernels vs plain versions on the card")
    checks = {"K1": lambda dt: check_k1(torch, F, dt, args.seed),
              "K2": lambda dt: check_k2(torch, F, dt, args.seed),
              "K4": lambda dt: check_decode(torch, F, dt, args.seed, False),
              "K5": lambda dt: check_decode(torch, F, dt, args.seed, True),
              "K6": lambda dt: check_decode(torch, F, dt, args.seed, False,
                                            verify=True),
              "K7": lambda dt: check_decode(torch, F, dt, args.seed, True,
                                            verify=True),
              "K8": lambda dt: check_k8(torch, F, dt, args.seed)}
    for wave in ("decode", "verify"):
        checks[f"K1 {wave}"] = lambda dt, w=wave: check_k1(
            torch, F, dt, args.seed, wave=w)
        checks[f"K8 {wave}"] = lambda dt, w=wave: check_k8(
            torch, F, dt, args.seed, wave=w)
    kres = {k: {dt: fn(dt) for dt in ("float32", "bfloat16")}
            for k, fn in checks.items()}
    check_k8_equals_k1(torch, args.seed)
    check_k8_equals_k1(torch, args.seed, int8=True)
    check_k6_int8_equals_k8_int8(torch, args.seed)
    check_f32_verify_equals_ragged(torch, args.seed)
    check_decode_equals_ragged(torch, args.seed)

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
    log("phase 4: ServingEngine, GPT-2-small, auto settings (paged mixed)")
    spec = request_set(prompts, args.seed, cfg.vocab_size)
    runs = {}      # (config, dtype) -> (results, launches, stats)
    runs["paged-mixed", "float32"] = serve(torch, htt, params, cfg, spec,
                                           "float32", "paged-mixed")
    res32 = runs["paged-mixed", "float32"][0]
    for i in range(4):
        got = res32[f"r{i}"].tokens[128:128 + 32]
        if list(got) != list(off_f32[i, 128:]):
            fail(f"f32 engine greedy tokens of r{i} differ from "
                 f"generate_fast: {list(got)} vs {list(off_f32[i, 128:])}")
    log("  f32 engine greedy tokens == generate_fast tokens (4 prompts)")
    runs["paged-mixed", "bfloat16"] = serve(torch, htt, params, cfg, spec,
                                            "bfloat16", "paged-mixed")
    res16 = runs["paged-mixed", "bfloat16"][0]
    agree = [int(np.argmax(np.append(
        res16[f"r{i}"].tokens != res32[f"r{i}"].tokens, True)))
        - len(spec[i][0]) for i in range(len(spec)) if spec[i][1] == 0]
    log(f"  bf16 vs f32 greedy: identical leading generated tokens per "
        f"request {agree} (of 64)")

    # ---- phase 5 ---- #
    log("phase 5: ServingEngine, GPT-2-small, the other layouts and "
        "schedulers")
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    for config in ("contiguous-split", "paged-split", "contiguous-mixed"):
        for dt in ("float32", "bfloat16"):
            runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                     config)
        res = runs[config, "float32"][0]
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(res32[f"r{i}"].tokens)]
        if bad:
            fail(f"{config} f32 greedy tokens differ from phase 4's for "
                 f"requests {bad}")
        log(f"  {config} f32 greedy tokens == phase 4's ({len(greedy)} "
            f"requests)")
    for (config, dt), (_, _, st) in runs.items():
        log(f"  serving on {card}: {config} {dt} "
            f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms")

    # ---- phase 6 ---- #
    log("phase 6: speculative decoding (spec 4, auto draft, adaptive k)")
    spec_runs = phase6(torch, htt, params, cfg, spec, runs, res32, prompts,
                       off_f32, card, args.seed)

    # ---- phase 7 ---- #
    log("phase 7: int8 KV cache: the int8 twins vs their plain versions "
        "(phase 2's K/V encoded on the card), then the engines")
    checks8 = {
        "K1-int8": lambda dt: check_k1(torch, F, dt, args.seed, int8=True),
        "K4-int8": lambda dt: check_decode(torch, F, dt, args.seed, False,
                                           int8=True),
        "K5-int8": lambda dt: check_decode(torch, F, dt, args.seed, True,
                                           int8=True),
        "K6-int8": lambda dt: check_decode(torch, F, dt, args.seed, False,
                                           verify=True, int8=True),
        "K7-int8": lambda dt: check_decode(torch, F, dt, args.seed, True,
                                           verify=True, int8=True),
        "K8-int8": lambda dt: check_k8(torch, F, dt, args.seed, int8=True)}
    for wave in ("decode", "verify"):
        checks8[f"K1-int8 {wave}"] = lambda dt, w=wave: check_k1(
            torch, F, dt, args.seed, int8=True, wave=w)
        checks8[f"K8-int8 {wave}"] = lambda dt, w=wave: check_k8(
            torch, F, dt, args.seed, int8=True, wave=w)
    kres.update({k: {dt: fn(dt) for dt in ("float32", "bfloat16")}
                 for k, fn in checks8.items()})
    runs8, spec_runs8 = phase7(torch, htt, params, cfg, spec, res32, card)

    # ---- phase 8 ---- #
    log("phase 8: training: K3 vs its plain version, GPT-2-small f32 and "
        "bf16, trained weights through the serving forward")
    del params
    kres8, train_runs = phase8(torch, F, htt, args.seed, card,
                               prof_dir=args.profile)

    # ---- phase 9 ---- #
    log("phase 9: context parallelism: K2-carry vs its plain version, the "
        "cp-4 ring and Ulysses at full width on a virtual mesh")
    kres9, ring_counts = phase9(torch, F, htt, args.seed)

    # ---- phase 10 ---- #
    log("phase 10: MoE serving: the MoE GPT at GPT-2-small width through "
        "generate_fast and the engines")
    phase10(torch, htt, args.seed, spec, prompts, runs, card)

    # ---- phase 11 ---- #
    log("phase 11: the serving fleet: two replicas of phase 4's engine "
        "behind the router (chaos kill, KV handoff over both wires, a "
        "rolling weight swap, the host KV tier)")
    phase11(torch, htt, cfg, args.seed, spec, res32,
            runs["paged-mixed", "float32"][2], card)

    # each kernel's launches from the run of the path it serves: K1 the
    # phase-4 engine, K2 phase 3's generate_fast, K4/K5/K8 the phase-5
    # engine of their layout and scheduler, K6/K7 the phase-6 speculative
    # engine of their layout, phase-split; each int8 twin the phase-7
    # engine of its float twin's path.  K1/K8 and their int8 twins count
    # by regime: the Q 256 / Q 1024 rows their wide waves (Q > 16), the
    # decode rows the narrow waves (Q <= 16) of the same engine, the
    # verify rows the narrow waves of the (phase-6 or phase-7)
    # speculative engine of their layout.  Sources: f32, bf16.
    src = "hetu_tpu_torch/kernels/csrc/"
    # K1/K8 and their int8 twins: f32 q's wide waves on the TF32 body,
    # its narrow waves on the split body; bf16 q's both in one source
    k1 = ("ragged_tf32.cuh", "ragged_paged_bf16.cu")
    k1n = ("split_kv_f32.cuh", "ragged_paged_bf16.cu")
    # K4-K7 and their int8 twins: f32 q on the f32 split body, bf16 q
    # all in one source
    split = ("split_kv_f32.cuh", "decode_attention_bf16.cu")
    r1 = "hetu_tpu/kernels/ragged_attention.py:184"
    r8 = "hetu_tpu/kernels/ragged_attention.py:133"
    rq = "hetu_tpu/kernels/ragged_attention.py:96"
    table = (
        ("K1", "ragged_paged_attention", k1, r1, "paged-mixed"),
        ("K1 decode", "ragged_paged_attention", k1n, r1, "paged-mixed"),
        ("K1 verify", "ragged_paged_attention", k1n, r1,
         "spec paged-mixed"),
        ("K2", "flash_attention", ("flash_fwd.cu", "flash_fwd_bf16.cu"),
         "hetu_tpu/kernels/flash_attention.py:173", None),
        ("K4", "paged_decode_attention", split,
         "hetu_tpu/kernels/decode_attention.py:159", "contiguous-split"),
        ("K5", "paged_block_decode_attention", split,
         "hetu_tpu/kernels/decode_attention.py:259", "paged-split"),
        ("K6", "paged_verify_attention", split,
         "hetu_tpu/kernels/decode_attention.py:478",
         "spec contiguous-split"),
        ("K7", "paged_block_verify_attention", split,
         "hetu_tpu/kernels/decode_attention.py:572", "spec paged-split"),
        ("K8", "ragged_attention", k1, r8, "contiguous-mixed"),
        ("K8 decode", "ragged_attention", k1n, r8, "contiguous-mixed"),
        ("K8 verify", "ragged_attention", k1n, r8,
         "spec contiguous-mixed"),
        ("K1-int8", "ragged_paged_attention_int8", k1, rq,
         "int8 paged-mixed"),
        ("K1-int8 decode", "ragged_paged_attention_int8", k1n, rq,
         "int8 paged-mixed"),
        ("K1-int8 verify", "ragged_paged_attention_int8", k1n, rq,
         "int8 spec paged-mixed"),
        ("K4-int8", "paged_decode_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:120",
         "int8 contiguous-split"),
        ("K5-int8", "paged_block_decode_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:247", "int8 paged-split"),
        ("K6-int8", "paged_verify_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:448",
         "int8 spec contiguous-split"),
        ("K7-int8", "paged_block_verify_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:562",
         "int8 spec paged-split"),
        ("K8-int8", "ragged_attention_int8", k1, rq,
         "int8 contiguous-mixed"),
        ("K8-int8 decode", "ragged_attention_int8", k1n, rq,
         "int8 contiguous-mixed"),
        ("K8-int8 verify", "ragged_attention_int8", k1n, rq,
         "int8 spec contiguous-mixed"))
    kernels = []
    for k, name, files, replaces, config in table:
        for dt, file in zip(("float32", "bfloat16"), files):
            if config is None:
                counts = c_off32 if dt == "float32" else c_off16
            elif config.startswith("int8 spec "):
                counts = spec_runs8[config[10:], dt][1]
            elif config.startswith("int8 "):
                counts = runs8[config[5:], dt][1]
            elif config.startswith("spec "):
                counts = spec_runs[config[5:], dt][1]
            else:
                counts = runs[config, dt][1]
            r = kres[k][dt]
            wave = k.split(" ")[1] if " " in k else None
            if k.split()[0] in ("K1", "K8", "K1-int8", "K8-int8"):
                counter = f"{name}:{'narrow' if wave else 'wide'}"
            else:
                counter = name
            kernels.append(dict(
                name=(f"{name}[{dt}, {wave} Q {NARROW_WAVES[wave][0]}]"
                      if wave else f"{name}[{dt}]"), route="cuda",
                source=src + file, replaces=replaces,
                launches=counts[counter],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 at the training shape and K3's two kernels: launches from the
    # phase-8 training run of their dtype
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:428")):
        for dt in ("float32", "bfloat16"):
            r = kres8[key][dt]
            kernels.append(dict(
                name=f"{name}[{dt}, training shape]" if key == "fwd"
                else f"{name}[{dt}]", route="cuda",
                source=src + file + ("_bf16.cu" if dt == "bfloat16"
                                     else ".cu"),
                replaces=replaces, launches=train_runs[dt][1][name],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2-carry: launches from phase 9's causal ring of its dtype
    for dt in ("float32", "bfloat16"):
        r = kres9[dt]
        kernels.append(dict(
            name=f"flash_attention_carry[{dt}]", route="cuda",
            source=src + ("flash_fwd_bf16.cu" if dt == "bfloat16"
                          else "flash_fwd.cu"),
            replaces="hetu_tpu/kernels/flash_attention.py:173",
            launches=ring_counts[dt]["flash_attention_carry"],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    if args.profile:
        log("profile: the serving runs under torch.profiler")
        profile_serve(torch, htt, htt.params_from_numpy(
            gpt2_small_params(cfg, args.seed)), cfg, spec, args.profile)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
