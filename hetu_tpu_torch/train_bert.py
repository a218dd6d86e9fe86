"""BERT pretraining (MLM + NSP) on the graph surface: the port of the JAX
package's ``examples/nlp/train_bert.py``, with its flags and defaults.

  python -m hetu_tpu_torch.train_bert                 # BERT-base on the card
  python -m hetu_tpu_torch.train_bert --device cpu --num-layers 2 \\
      --seq-len 32 --num-steps 2
  python -m hetu_tpu_torch.train_bert --data-path corpus.txt \\
      --vocab-path vocab.txt --save ckpt/   # then finetune_bert_glue

Defaults: BERT-base, B 8, S 128, AdamW at 1e-4 with weight decay 0.01,
30 steps, f32.  ``--data-path`` (one sentence a line, a blank line
between documents) runs the pretraining pipeline
(``nlp_common.corpus_mlm_stream``; the vocab from ``--vocab-path`` or
built from the corpus, the model's vocab max(its size, 128)); without it
the batches are synthetic.  ``--save DIR`` writes the executor's
checkpoint after the steps.  The batches carry an additive
``attention_mask``, so, as in JAX, ``--use-flash`` does not reach the
flash kernel (the masked attention runs the unfused chain).
``--comm-mode AllReduce`` is passed to the executor, which runs it as the
plain path (as JAX's does); ``PS``/``Hybrid`` wait for the parameter
server (ROADMAP A10).
"""

import argparse
import logging
import time
from types import SimpleNamespace

import numpy as np

from . import graph as ht
from .models import BertConfig, BertForPreTraining
from .nlp_common import corpus_mlm_stream, synthetic_mlm_batch

logger = logging.getLogger("bert")


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
                        help="raw text corpus (one sentence per line, "
                             "blank line between documents); synthetic "
                             "batches when absent")
    parser.add_argument("--vocab-path", default=None,
                        help="wordpiece vocab.txt; built from the "
                             "corpus when absent")
    parser.add_argument("--dupe-factor", type=int, default=5)
    parser.add_argument("--mixed-precision", default=None, choices=["bf16"],
                        help="the bf16 policy (f32 masters and optimizer "
                             "state)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--save", default=None, metavar="DIR",
                        help="write the checkpoint into DIR after training")
    return parser.parse_args(argv)


def build(args):
    """The model, its executor and its batches for the parsed arguments:
    a namespace of ``cfg``, ``executor``, ``feeds`` (the five
    placeholders) and ``next_batch()``."""
    if args.comm_mode not in (None, "AllReduce"):
        raise NotImplementedError(
            f"--comm-mode {args.comm_mode!r} needs the parameter server, "
            f"which is not in hetu_tpu_torch yet (ROADMAP A10)")
    make = BertConfig.large if args.config == "large" else BertConfig.base
    kw = dict(batch_size=args.batch_size, seq_len=args.seq_len,
              use_flash_attention=args.use_flash)
    if args.num_layers:
        kw["num_hidden_layers"] = args.num_layers
    stream = None
    if args.data_path:
        stream, vocab_size = corpus_mlm_stream(
            args.data_path, args.vocab_path, args.batch_size,
            args.seq_len, dupe_factor=args.dupe_factor)
        kw["vocab_size"] = max(vocab_size, 128)
        logger.info("pretraining on %s (vocab %d)", args.data_path,
                    vocab_size)
    cfg = make(**kw)

    model = BertForPreTraining(cfg)
    feeds = [ht.placeholder_op(n) for n in (
        "input_ids", "token_type_ids", "attention_mask",
        "masked_lm_labels", "next_sentence_label")]
    loss, _, _ = model(*feeds)
    opt = ht.optim.AdamWOptimizer(learning_rate=args.learning_rate,
                                  weight_decay=0.01)
    train_op = opt.minimize(loss)
    executor = ht.Executor({"train": [loss, train_op]},
                           mixed_precision=args.mixed_precision,
                           comm_mode=args.comm_mode, device=args.device)
    rng = np.random.RandomState(0)

    def next_batch():
        return next(stream) if stream is not None \
            else synthetic_mlm_batch(rng, cfg)

    return SimpleNamespace(cfg=cfg, executor=executor, feeds=feeds,
                           next_batch=next_batch)


def main(argv=None):
    """Train ``--num-steps`` steps; returns the last loss."""
    args = parse_args(argv)
    run = build(args)
    cfg = run.cfg
    t0 = time.time()
    last = None
    for step in range(args.num_steps):
        out = run.executor.run("train", feed_dict=dict(
            zip(run.feeds, run.next_batch())))
        last = float(out[0])
        if step % 10 == 0 or step == args.num_steps - 1:
            dt = time.time() - t0
            sps = (step + 1) * cfg.batch_size / dt
            logger.info("step %d loss=%.4f (%.1f samples/s)", step,
                        last, sps)
    if args.save:
        run.executor.save(args.save)
        logger.info("checkpoint written to %s", args.save)
    return last


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
