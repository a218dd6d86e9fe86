"""Long-context causal LM training on the graph surface: the port of the
JAX package's ``examples/nlp/train_long_context.py``, with
``build_causal_lm`` written against ``hetu_tpu_torch.graph`` line for
line.  Attention runs ``flash_attention_op`` (K2 forward, K3 backward on
the card), or the unfused chain with ``--no-flash``.

  python -m hetu_tpu_torch.train_long_context             # on the card
  python -m hetu_tpu_torch.train_long_context --device cpu --tiny \\
      --seq-len 64

Defaults are the JAX example's: seq 4096, batch 1, hidden 768, 12
heads, 4 layers, vocab 32000, 10 steps, Adam at 3e-4, the bf16 policy.
"""

import argparse
import logging
import time

import numpy as np
import torch

from . import graph as ht

logger = logging.getLogger("longctx")


def build_causal_lm(batch, seq, hidden, heads, layers_n, vocab,
                    use_flash=True, block_q=512, block_k=1024):
    ids = ht.placeholder_op("input_ids")
    emb = ht.layers.Embedding(vocab, hidden, name="lc_tok_emb")
    pos = ht.init.random_normal((seq, hidden), stddev=0.02, name="lc_pos")
    h = ht.embedding_lookup_op(emb.embedding_table, ids)
    h = h + ht.broadcast_shape_op(pos, (batch, seq, hidden), add_axes=[0])
    h = ht.array_reshape_op(h, [batch * seq, hidden])
    for i in range(layers_n):
        attn = ht.layers.MultiHeadAttention(
            hidden, heads, seq, batch, use_flash=use_flash, causal=True,
            block_q=block_q, block_k=block_k, name=f"lc{i}_attn")
        h = ht.layers.LayerNorm(hidden, name=f"lc{i}_ln1")(h + attn(h))
        wi = ht.layers.Linear(hidden, 4 * hidden, name=f"lc{i}_ffn_wi")
        wo = ht.layers.Linear(4 * hidden, hidden, name=f"lc{i}_ffn_wo")
        h = ht.layers.LayerNorm(hidden, name=f"lc{i}_ln2")(
            h + wo(ht.gelu_op(wi(h))))
    logits = ht.layers.Linear(hidden, vocab, name="lc_head")(h)
    # next-token prediction: labels = ids shifted left
    labels = ht.placeholder_op("labels")
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_sparse_op(
            logits, ht.array_reshape_op(labels, [batch * seq])), axes=0)
    return ids, labels, loss


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--num-steps", type=int, default=10)
    p.add_argument("--no-flash", action="store_true")
    p.add_argument("--tiny", action="store_true", help="CPU-smoke scale")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.tiny:
        args.hidden, args.heads, args.layers, args.vocab = 64, 2, 2, 200
        args.batch_size = max(args.batch_size, 2)
        args.num_steps = min(args.num_steps, 5)
    return args


def fixed_stream(batch, seq, vocab):
    """The example's fixed batch: (input ids, labels shifted left)."""
    rng = np.random.RandomState(0)
    stream = rng.randint(0, vocab, (batch, seq + 1)).astype(np.int32)
    return stream[:, :-1], stream[:, 1:]


def main(argv=None):
    """Train ``--num-steps`` steps after one warm-up step; returns
    {"step_ms", "tokens_per_s", "loss_first", "loss_last", "peak_bytes"}
    (peak on CUDA, else None)."""
    args = parse_args(argv)
    B, S = args.batch_size, args.seq_len
    ids, labels, loss = build_causal_lm(
        B, S, args.hidden, args.heads, args.layers, args.vocab,
        use_flash=not args.no_flash)
    train = ht.optim.AdamOptimizer(learning_rate=3e-4).minimize(loss)
    ex = ht.Executor({"train": [loss, train]}, mixed_precision="bf16",
                     device=args.device)
    cuda = ex.device.type == "cuda"
    x, y = fixed_stream(B, S, args.vocab)
    feed = {ids: x, labels: y}

    def sync():
        if cuda:
            torch.cuda.synchronize(ex.device)

    l0 = float(ex.run("train", feed_dict=feed)[0])     # warm-up step
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(ex.device)
    t0 = time.perf_counter()
    for _ in range(args.num_steps):
        out = ex.run("train", feed_dict=feed)
    sync()
    lN = float(out[0])
    dt = (time.perf_counter() - t0) / args.num_steps
    toks = B * S / dt
    logger.info("seq %d: step %.1f ms, %.0f tokens/sec, loss %.4f -> %.4f",
                S, dt * 1e3, toks, l0, lN)
    assert np.isfinite(lN)
    return {"step_ms": dt * 1e3, "tokens_per_s": toks, "loss_first": l0,
            "loss_last": lN,
            "peak_bytes": torch.cuda.max_memory_allocated(ex.device)
            if cuda else None}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    print(main())
