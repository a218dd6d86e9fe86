"""BERT fine-tuning for SQuAD-style span extraction: the port of the JAX
package's ``examples/nlp/finetune_bert_squad.py``, with its flags and
defaults.

  python -m hetu_tpu_torch.finetune_bert_squad \\
      --data tests/fixtures/squad/train-tiny.json --num-steps 60
  python -m hetu_tpu_torch.finetune_bert_squad --device cpu \\
      --data tests/fixtures/squad/train-tiny.json --num-steps 20

``--data`` is an official-format SQuAD JSON (v1.1 or v2.0); the vocab
comes from ``--vocab-path`` or is built from the contexts and questions.
``BertForQuestionAnswering`` trains start/end span prediction over
doc-stride windows (``squad.py``), then every window runs through the
trained heads and ``squad_evaluate`` scores the extracted answers
(exact match and F1, the official normalization).  ``--comm-mode
AllReduce`` adds ``dist_strategy=DataParallel()``, as the JAX example
does: a data-parallel mesh over the world under torch.distributed, else
over this host's cards (one: unsharded).  Runs on the card unless
``--device cpu`` is given.
"""

import argparse
import logging
import time

import numpy as np

from . import graph as ht
from .models import BertConfig, BertForQuestionAnswering
from .nlp_common import hermetic_tokenizer
from .squad import (convert_examples_to_features, extract_predictions,
                    features_to_arrays, read_squad_examples, squad_evaluate)

logger = logging.getLogger("squad")


def build_tokenizer(examples, vocab_path):
    def lines():
        for ex in examples:
            yield " ".join(ex.doc_tokens)
            yield ex.question_text
    return hermetic_tokenizer(lines(), vocab_path)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", required=True,
                   help="official-format SQuAD JSON (v1.1 or v2.0)")
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--doc-stride", type=int, default=32)
    p.add_argument("--num-steps", type=int, default=60)
    p.add_argument("--learning-rate", type=float, default=2e-3)
    p.add_argument("--comm-mode", default=None, choices=[None, "AllReduce"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Fine-tune and score; returns squad_evaluate's metrics
    (``exact_match``, ``f1``, ...) with ``losses`` (each step's) and
    ``step_ms`` (the mean step time) added."""
    args = parse_args(argv)
    examples = read_squad_examples(args.data, is_training=True)
    tok = build_tokenizer(examples, args.vocab_path)
    features = convert_examples_to_features(
        examples, tok, max_seq_length=args.seq_len,
        doc_stride=args.doc_stride, max_query_length=16)
    arrays = features_to_arrays(features)
    n = len(features)
    logger.info("examples=%d features=%d vocab=%d",
                len(examples), n, len(tok.vocab))

    cfg = BertConfig(
        vocab_size=len(tok.vocab), hidden_size=args.hidden,
        num_hidden_layers=args.num_layers,
        num_attention_heads=args.heads,
        intermediate_size=4 * args.hidden,
        max_position_embeddings=max(args.seq_len, 64),
        batch_size=args.batch_size, seq_len=args.seq_len,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = BertForQuestionAnswering(cfg, name="bert_squad")

    ids = ht.placeholder_op("input_ids")
    mask = ht.placeholder_op("input_mask")
    segs = ht.placeholder_op("segment_ids")
    sp = ht.placeholder_op("start_positions")
    ep = ht.placeholder_op("end_positions")
    loss, start_logits, end_logits = model(
        ids, token_type_ids=segs, attention_mask=mask,
        start_positions=sp, end_positions=ep)
    opt = ht.optim.AdamOptimizer(learning_rate=args.learning_rate)
    train = opt.minimize(loss)
    kw = {}
    if args.comm_mode:
        kw.update(comm_mode=args.comm_mode,
                  dist_strategy=ht.dist.DataParallel())
    ex = ht.Executor({"train": [loss, train],
                      "eval": [start_logits, end_logits]},
                     device=args.device, **kw)

    def feed(take):
        return {ids: arrays["input_ids"][take],
                mask: arrays["input_mask"][take],
                segs: arrays["segment_ids"][take],
                sp: arrays["start_positions"][take],
                ep: arrays["end_positions"][take]}

    rng = np.random.RandomState(0)
    losses, train_s = [], 0.0
    for step in range(args.num_steps):
        take = rng.randint(0, n, args.batch_size)
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict=feed(take))
        losses.append(float(out[0]))     # reads the loss: waits for it
        train_s += time.perf_counter() - t0
        if step % 20 == 0 or step == args.num_steps - 1:
            logger.info("step %d loss %.4f", step, losses[-1])

    # eval: run every window through the trained head, extract spans
    all_start, all_end = [], []
    pad_to = (-n) % args.batch_size
    order = list(range(n)) + [0] * pad_to
    for i in range(0, len(order), args.batch_size):
        s_l, e_l = ex.run("eval", feed_dict=feed(order[i:i + args.batch_size]),
                          convert_to_numpy_ret_vals=True)
        all_start.append(s_l)
        all_end.append(e_l)
    start_logits = np.concatenate(all_start)[:n]
    end_logits = np.concatenate(all_end)[:n]
    preds = extract_predictions(examples, features, start_logits,
                                end_logits)
    metrics = squad_evaluate(examples, preds)
    logger.info("exact_match %.2f f1 %.2f", metrics["exact_match"],
                metrics["f1"])
    return dict(metrics, losses=losses,
                step_ms=1e3 * train_s / max(args.num_steps, 1))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
