"""Decoder-only causal LM pretraining (GPT-2 topology) on the port, the
counterpart of the JAX package's ``examples/nlp/train_gpt.py``:

    python -m hetu_tpu_torch.train_gpt --seq-len 1024 --num-steps 30
    python -m hetu_tpu_torch.train_gpt --device cpu --num-layers 2 \\
        --vocab-size 128 --seq-len 64 --batch-size 2 --num-steps 2
    python -m hetu_tpu_torch.train_gpt --seq-len 1024 --num-steps 8 \\
        --mixed-precision bf16 --profile prof/   # device time by kernel
    python -m hetu_tpu_torch.train_gpt --data-path train.bin \\
        --demo-generate 16                       # a nanoGPT token file
    python -m hetu_tpu_torch.train_gpt --device cpu --num-layers 2 \\
        --seq-len 64 --batch-size 2 --num-steps 2 \\
        --data-path tests/fixtures/tiny_corpus.txt --demo-generate 4

AdamW (weight decay 0.01) with a global gradient-norm clip and the fused
chunked tied head, as the JAX example has them.  ``--data-path`` reads a
flat uint16 (vocab below 2^16, else uint32) token stream in nanoGPT's
format, or a raw ``.txt`` corpus through the wordpiece pipeline
(``--vocab-path``, else a vocab built from the corpus; the model's vocab
becomes max(its size, 128)); random windows of it are the batches.
Without it the task is the synthetic ``next = (3 * token + 7) % vocab``;
batches and weights are drawn from seed 0.  ``--demo-generate N``
continues a 3-token prompt greedily through full forwards
(:func:`models.gpt_module.greedy_generate_module`) and through ``generate_fast``'s KV
cache, and logs whether they agree (``match=``).  Flash
attention (K2 forward, K3 backward) runs from ``--seq-len`` 1024, as the
JAX package's auto rule has it, or with ``--use-flash``.  Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

logger = logging.getLogger("gpt")

# kernel kinds of a profile, by name, first match wins
KINDS = (("K2 flash forward", "flash_fwd"),
         ("K3 flash backward dK/dV", "flash_bwd_dkv"),
         ("K3 flash backward dQ", "flash_bwd_dq"),
         ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
         ("reductions", "reduce_kernel"),
         ("elementwise", "elementwise"))


def load_tokens(path, vocab_size):
    """Flat binary token stream (nanoGPT data format: np.uint16)."""
    dtype = np.uint16 if vocab_size < (1 << 16) else np.uint32
    return np.fromfile(path, dtype=dtype).astype(np.int32)


def load_text_corpus(path, vocab_path):
    """Raw text corpus -> flat token stream through the pretraining
    pipeline (``pretraining_data``); builds a wordpiece vocab from the
    corpus when none is given.  Returns (tokens, vocab_size).  The whole
    stream feeds :func:`batches`' random windows."""
    from .pretraining_data import corpus_token_stream, load_or_build_tokenizer
    tok = load_or_build_tokenizer(path, vocab_path)
    return corpus_token_stream(path, tok), len(tok.vocab)


def batches(tokens, cfg, rng):
    """Random windows (x, y) of ``tokens``, y shifted by one."""
    # valid starts: 0 .. len - seq_len - 1 inclusive (targets need one
    # extra token); randint's high bound is exclusive
    n = len(tokens) - cfg.seq_len
    if n < 1:
        raise SystemExit(
            f"--data-path holds {len(tokens)} tokens; need at least "
            f"seq_len+1 = {cfg.seq_len + 1} for one training window")
    while True:
        starts = rng.randint(0, n, cfg.batch_size)
        x = np.stack([tokens[s:s + cfg.seq_len] for s in starts])
        y = np.stack([tokens[s + 1:s + cfg.seq_len + 1] for s in starts])
        yield x.astype(np.int32), y.astype(np.int32)


def synthetic(cfg, rng):
    """Batches (x, y) of [batch, seq] int32: y = (3 * x + 7) % vocab."""
    while True:
        x = rng.randint(0, cfg.vocab_size,
                        (cfg.batch_size, cfg.seq_len)).astype(np.int32)
        yield x, ((3 * x + 7) % cfg.vocab_size).astype(np.int32)


def build(args):
    """(config, executor, batch stream) for the parsed arguments; the
    stream reads ``--data-path`` when it names a file."""
    from .executor import Executor
    from .models import GPTConfig
    from .models.gpt_module import GPTForCausalLMModule
    from .optimizer import AdamWOptimizer

    make = GPTConfig.medium if args.config == "medium" else GPTConfig.small
    kw = dict(batch_size=args.batch_size, seq_len=args.seq_len,
              max_position_embeddings=args.seq_len,
              vocab_size=args.vocab_size, dropout_rate=0.0,
              use_flash=args.use_flash)
    if args.num_layers:
        kw["num_hidden_layers"] = args.num_layers
    corpus = None
    if args.data_path and args.data_path.endswith(".txt"):
        corpus, vocab_size = load_text_corpus(args.data_path,
                                              args.vocab_path)
        kw["vocab_size"] = max(vocab_size, 128)
        logger.info("tokenized %s: %d tokens, vocab %d", args.data_path,
                    len(corpus), vocab_size)
    cfg = make(**kw)
    opt = AdamWOptimizer(learning_rate=args.learning_rate, weight_decay=0.01)
    if args.clip_grad_norm > 0:
        opt.clip_grad_norm = args.clip_grad_norm
    ex = Executor(GPTForCausalLMModule(cfg, seed=0), opt,
                  mixed_precision=args.mixed_precision, device=args.device)
    rng = np.random.RandomState(0)
    if corpus is not None:
        stream = batches(corpus, cfg, rng)
        logger.info("training on text corpus %s", args.data_path)
    elif args.data_path and os.path.exists(args.data_path):
        stream = batches(load_tokens(args.data_path, cfg.vocab_size),
                         cfg, rng)
        logger.info("training on %s", args.data_path)
    else:
        stream = synthetic(cfg, rng)
        logger.info("no --data-path: synthetic next-token task")
    return cfg, ex, stream


def demo_generate(ex, cfg, num_tokens):
    """Greedy continuations of the prompt [1, 2, 3] through full
    forwards and through ``generate_fast``: (greedy, fast) token lists,
    prompt included."""
    from .models.gpt_module import greedy_generate_module
    from .models.gpt_decode import generate_fast
    prompt = [int(t) % cfg.vocab_size for t in (1, 2, 3)]
    n = min(num_tokens, cfg.seq_len - len(prompt))
    seq = greedy_generate_module(ex, prompt, n, cfg.seq_len)
    fast = generate_fast(ex.var_values, cfg, prompt, num_tokens=n,
                         device=ex.device)
    return seq, fast[0].tolist()


def kind_of(name):
    for kind, keys in KINDS:
        if any(k in name for k in ((keys,) if isinstance(keys, str)
                                   else keys)):
            return kind
    return "other"


def profile_steps(ex, stream, steps, out_dir):
    """Run ``steps`` more training steps under torch.profiler, write the
    per-kernel table into ``out_dir`` and return report lines: the
    device's busy share of the wall (host tracing inflates the wall, so
    it is a lower bound) and the device time by kernel kind."""
    import collections
    from pathlib import Path

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            x, y = next(stream)
            ex.run({"input_ids": x, "labels": y})
        torch.cuda.synchronize(ex.device)
        wall = time.perf_counter() - t0
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernels.txt").write_text("".join(
        f"{e.key[:90]:90s} {e.count:7d} {e.self_device_time_total / 1e3:11.3f}"
        "\n" for e in rows))
    lines = [f"profile of {steps} steps: device busy {busy_ms:.3f} ms of "
             f"{wall * 1e3:.3f} ms wall ({busy_ms / (wall * 1e3):.1%})"]
    kinds, calls = collections.Counter(), collections.Counter()
    for e in rows:
        kinds[kind_of(e.key)] += e.self_device_time_total / 1e3
        calls[kind_of(e.key)] += e.count
    lines += [f"  {kind}: {ms / steps:.3f} ms a step ({ms / busy_ms:.1%}), "
              f"{calls[kind] // steps} launches a step"
              for kind, ms in kinds.most_common()]
    return lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="small", choices=["small", "medium"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--vocab-size", type=int, default=50257)
    ap.add_argument("--learning-rate", type=float, default=3e-4)
    ap.add_argument("--clip-grad-norm", type=float, default=1.0,
                    help="global gradient-norm bound (<=0 disables)")
    ap.add_argument("--num-steps", type=int, default=30)
    ap.add_argument("--data-path", default=None,
                    help="flat uint16/uint32 token file (nanoGPT format) "
                         "or a raw .txt corpus; synthetic task when absent")
    ap.add_argument("--vocab-path", default=None,
                    help="wordpiece vocab.txt for .txt corpora; built from "
                         "the corpus when absent")
    ap.add_argument("--use-flash", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="pin flash on/off; default: auto (flash from seq "
                         "1024, dropout permitting)")
    ap.add_argument("--mixed-precision", default=None, choices=["bf16"],
                    help="bf16 compute over f32 master weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--demo-generate", type=int, default=0,
                    help="after training, greedy-decode this many tokens "
                         "from a short prompt, full forwards and KV cache")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="after the steps, profile three more on the card "
                         "and write device time by kernel into DIR")
    return ap.parse_args(argv)


def main(argv=None):
    """Train ``--num-steps`` steps; returns the losses."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")

    import torch
    cfg, ex, stream = build(args)
    logger.info("GPT %d layers, hidden %d, vocab %d, seq %d, batch %d, "
                "flash %s, mixed precision %s, on %s", cfg.num_hidden_layers,
                cfg.hidden_size, cfg.vocab_size, cfg.seq_len, cfg.batch_size,
                cfg.use_flash, args.mixed_precision, ex.device)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.num_steps):
        x, y = next(stream)
        loss = float(ex.run({"input_ids": x, "labels": y})[0])
        losses.append(loss)
        if step % 10 == 0 or step == args.num_steps - 1:
            if ex.device.type == "cuda":
                torch.cuda.synchronize(ex.device)
            dt = time.perf_counter() - t0
            logger.info("step %d loss=%.4f (%.0f tokens/s)", step, loss,
                        (step + 1) * cfg.batch_size * cfg.seq_len / dt)
    if ex.device.type == "cuda":
        logger.info("peak memory %d B", torch.cuda.max_memory_allocated(
            ex.device))
    if args.demo_generate > 0:
        seq, fast = demo_generate(ex, cfg, args.demo_generate)
        logger.info("greedy continuation of %s: %s", seq[:3], seq[3:])
        logger.info("kv-cached continuation: %s (match=%s)", fast[3:],
                    fast == seq)
    if args.profile:
        for line in profile_steps(ex, stream, 3, args.profile):
            logger.info(line)
    return losses


if __name__ == "__main__":
    main()
