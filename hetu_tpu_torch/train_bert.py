"""BERT pretraining (MLM + NSP) on the graph surface: the port of the JAX
package's ``examples/nlp/train_bert.py``, with its flags, defaults and
synthetic batches.

  python -m hetu_tpu_torch.train_bert                 # BERT-base on the card
  python -m hetu_tpu_torch.train_bert --device cpu --num-layers 2 \\
      --seq-len 32 --num-steps 2

Defaults: BERT-base, B 8, S 128, AdamW at 1e-4 with weight decay 0.01,
30 steps, f32.  The batches carry an additive ``attention_mask``, so, as
in JAX, ``--use-flash`` does not reach the flash kernel (the masked
attention runs the unfused chain).  ``--data-path``/``--vocab-path``
(the pretraining corpus) wait for ROADMAP A8 item 3, a ``--comm-mode``
for A9b/A10.
"""

import argparse
import logging
import time

import numpy as np

from . import graph as ht
from .models import BertConfig, BertForPreTraining

logger = logging.getLogger("bert")


def synthetic_mlm_batch(rng, cfg, mask_prob=0.15):
    """Synthetic BERT pretraining batch: (ids, token_type, attention_mask,
    mlm_labels, nsp_labels).  [MASK] is 103 in the standard vocab; the
    clamp keeps tiny test vocabs in range."""
    ids = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.seq_len))
    token_type = np.zeros((cfg.batch_size, cfg.seq_len), np.int32)
    token_type[:, cfg.seq_len // 2:] = 1
    mask = np.ones((cfg.batch_size, cfg.seq_len), np.float32)
    mlm_labels = np.full((cfg.batch_size, cfg.seq_len), -1, np.int32)
    masked = rng.rand(cfg.batch_size, cfg.seq_len) < mask_prob
    mlm_labels[masked] = ids[masked]
    ids[masked] = min(103, cfg.vocab_size - 1)  # [MASK]
    nsp = rng.randint(0, 2, (cfg.batch_size,))
    return (ids.astype(np.int32), token_type, mask,
            mlm_labels, nsp.astype(np.int32))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="base", choices=["base", "large"])
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--num-layers", type=int, default=None)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--num-steps", type=int, default=30)
    parser.add_argument("--comm-mode", default=None)
    parser.add_argument("--use-flash", action="store_true")
    parser.add_argument("--data-path", default=None,
                        help="raw text corpus (not in the port yet: "
                             "ROADMAP A8 item 3); synthetic batches when "
                             "absent")
    parser.add_argument("--vocab-path", default=None,
                        help="wordpiece vocab.txt (ROADMAP A8 item 3)")
    parser.add_argument("--dupe-factor", type=int, default=5)
    parser.add_argument("--mixed-precision", default=None, choices=["bf16"],
                        help="the bf16 policy (f32 masters and optimizer "
                             "state)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Train ``--num-steps`` steps; returns the last loss."""
    args = parse_args(argv)
    if args.data_path or args.vocab_path:
        raise NotImplementedError(
            "--data-path/--vocab-path (the pretraining corpus and "
            "tokenizer) are not in hetu_tpu_torch yet (ROADMAP A8 item 3)")
    if args.comm_mode is not None:
        raise NotImplementedError(
            f"--comm-mode {args.comm_mode!r} is not in hetu_tpu_torch yet "
            f"(ROADMAP A9b for AllReduce, A10 for PS/Hybrid)")

    make = BertConfig.large if args.config == "large" else BertConfig.base
    kw = dict(batch_size=args.batch_size, seq_len=args.seq_len,
              use_flash_attention=args.use_flash)
    if args.num_layers:
        kw["num_hidden_layers"] = args.num_layers
    cfg = make(**kw)

    model = BertForPreTraining(cfg)
    ids = ht.placeholder_op("input_ids")
    tok = ht.placeholder_op("token_type_ids")
    mask = ht.placeholder_op("attention_mask")
    mlm = ht.placeholder_op("masked_lm_labels")
    nsp = ht.placeholder_op("next_sentence_label")
    loss, _, _ = model(ids, tok, mask, mlm, nsp)
    opt = ht.optim.AdamWOptimizer(learning_rate=args.learning_rate,
                                  weight_decay=0.01)
    train_op = opt.minimize(loss)
    executor = ht.Executor({"train": [loss, train_op]},
                           mixed_precision=args.mixed_precision,
                           device=args.device)

    rng = np.random.RandomState(0)
    t0 = time.time()
    last = None
    for step in range(args.num_steps):
        b_ids, b_tok, b_mask, b_mlm, b_nsp = synthetic_mlm_batch(rng, cfg)
        out = executor.run("train", feed_dict={
            ids: b_ids, tok: b_tok, mask: b_mask, mlm: b_mlm, nsp: b_nsp})
        last = float(out[0])
        if step % 10 == 0 or step == args.num_steps - 1:
            dt = time.time() - t0
            sps = (step + 1) * cfg.batch_size / dt
            logger.info("step %d loss=%.4f (%.1f samples/s)", step,
                        last, sps)
    return last


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
