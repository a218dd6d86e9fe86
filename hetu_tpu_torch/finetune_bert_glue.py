"""BERT fine-tuning for GLUE-style sentence classification: the port of
the JAX package's ``examples/nlp/finetune_bert_glue.py``, with its flags
and defaults.

  python -m hetu_tpu_torch.finetune_bert_glue --task SST-2 \\
      --data-dir tests/fixtures/glue --init-checkpoint ckpt/
  python -m hetu_tpu_torch.finetune_bert_glue --device cpu --num-steps 30

``--task`` reads the official TSVs of ``--data-dir`` through the task
processors (``glue.py``; the vocab from ``--vocab-path``, else the data
directory's ``vocab.txt``, else built from the text) and reports
``glue.compute_metrics`` on the dev set, each dev example counted once.
Without a task a synthetic, learnable task stands in (label = whether
more than half the tokens come from the first half of the vocab).
``--init-checkpoint`` loads every backbone tensor by name from a
pretraining checkpoint (``train_bert --save``, or the JAX package's
``Executor.save``); the classifier stays fresh.  ``--comm-mode
AllReduce`` on one card runs unsharded, as the JAX script does on one
device.  ``--data`` (a ``label<TAB>text`` TSV) is broken in the
reference and raises here (ROADMAP Queue C, C7).  Runs on the card
unless ``--device cpu`` is given.
"""

import argparse
import logging
import os
import time

import numpy as np

from . import checkpoint as _ckpt
from . import graph as ht
from .glue import PROCESSORS, compute_metrics, convert_examples_to_arrays
from .models import BertConfig, BertForSequenceClassification
from .nlp_common import hermetic_tokenizer

logger = logging.getLogger("glue")


def load_glue_task(task, data_dir, vocab_path, seq_len):
    """Official-format GLUE TSVs through the task processor suite.
    Returns (train arrays, dev arrays, num_labels, vocab_size); each
    arrays tuple is (input_ids, attention_mask, token_type_ids,
    labels)."""
    proc = PROCESSORS[task.lower()]()
    train_ex = proc.get_train_examples(data_dir)
    dev_ex = proc.get_dev_examples(data_dir)
    if not vocab_path:
        cand = os.path.join(data_dir, "vocab.txt")
        if os.path.exists(cand):
            vocab_path = cand

    def lines():
        for ex in train_ex + dev_ex:
            yield ex.text_a
            if ex.text_b:
                yield ex.text_b
    tok = hermetic_tokenizer(lines(), vocab_path)
    lab = proc.get_labels()
    return (convert_examples_to_arrays(train_ex, lab, seq_len, tok),
            convert_examples_to_arrays(dev_ex, lab, seq_len, tok),
            len(lab), len(tok.vocab))


def synthetic(rng, n, seq_len, vocab_size):
    """Learnable stand-in: label = [more than half the tokens come from
    the first half of the vocabulary]."""
    ids = rng.randint(0, vocab_size, (n, seq_len)).astype(np.int32)
    labels = ((ids < vocab_size // 2).mean(axis=1) > 0.5).astype(np.int32)
    return ids, labels


def load_backbone(ex, path):
    """Load every variable of the checkpoint in ``path`` that this
    executor holds, the classifier excepted; returns how many."""
    ckpt = _ckpt.read(path)
    pre = {k: v for k, v in ckpt["params"].items()
           if k in ex.variables and "classifier" not in k}
    ex.load_dict(pre)
    return len(pre)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="base", choices=["base", "large"])
    p.add_argument("--num-layers", type=int, default=2,
                   help="encoder depth override (small default: the "
                        "synthetic task needs no 12 layers)")
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--num-labels", type=int, default=2)
    p.add_argument("--learning-rate", type=float, default=5e-4)
    p.add_argument("--num-steps", type=int, default=40)
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--data", default=None,
                   help="label<TAB>text TSV (broken in the reference: "
                        "ROADMAP Queue C, C7)")
    p.add_argument("--task", default=None, choices=sorted(PROCESSORS),
                   help="GLUE task name; reads official TSVs from "
                        "--data-dir via the processor suite")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--init-checkpoint", default=None,
                   help="directory saved by a pretraining Executor; "
                        "backbone weights load by name, heads stay fresh")
    p.add_argument("--comm-mode", default=None, choices=[None, "AllReduce"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Fine-tune; returns {"accuracy", "metrics", "losses", "loaded",
    "backbone", "step_ms"}: the final dev accuracy and the task's
    metrics, each step's loss, the backbone tensors loaded and the
    backbone's variable count, and the mean step time."""
    args = parse_args(argv)
    if args.data:
        raise NotImplementedError(
            "--data (a label<TAB>text TSV) is broken in the reference: "
            "its load_tsv imports BertWordPieceTokenizer, which "
            "hetu_tpu.tokenizers does not export, and slices encode()'s "
            "dict as a list (ROADMAP Queue C, C7); use --task/--data-dir")
    glue_train = glue_dev = None
    if args.task:
        assert args.data_dir, "--task needs --data-dir"
        glue_train, glue_dev, args.num_labels, args.vocab = \
            load_glue_task(args.task, args.data_dir, args.vocab_path,
                           args.seq_len)
        logger.info("task %s: %d train / %d dev examples, vocab %d",
                    args.task, len(glue_train[0]), len(glue_dev[0]),
                    args.vocab)

    cfg = BertConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                     num_hidden_layers=args.num_layers,
                     num_attention_heads=args.heads,
                     intermediate_size=4 * args.hidden,
                     seq_len=args.seq_len, batch_size=args.batch_size,
                     hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1)
    ids = ht.placeholder_op("input_ids")
    tok_ids = ht.placeholder_op("token_type_ids")
    mask = ht.placeholder_op("attention_mask")
    labels = ht.placeholder_op("labels")
    model = BertForSequenceClassification(cfg, num_labels=args.num_labels)
    loss, logits = model(ids, tok_ids, mask, labels=labels)
    opt = ht.optim.AdamWOptimizer(learning_rate=args.learning_rate,
                                  weight_decay=0.01)
    train = opt.minimize(loss)
    ex = ht.Executor({"train": [loss, train], "eval": [loss, logits]},
                     comm_mode=args.comm_mode, device=args.device)
    backbone = sum("classifier" not in k for k in ex.variables)
    loaded = 0
    if args.init_checkpoint:
        loaded = load_backbone(ex, args.init_checkpoint)
        logger.info("loaded %d backbone tensors of %d from %s", loaded,
                    backbone, args.init_checkpoint)

    rng = np.random.RandomState(0)
    if glue_train is not None:
        tr_ids, tr_m, tr_t, tr_y = glue_train
        ev_ids, ev_m, ev_t, ev_y = glue_dev
        n_dev = len(ev_ids)
        # pad dev to a batch multiple by wrapping, and remember each
        # row's example index so metrics count every example once
        pad_to = max(args.batch_size,
                     -(-n_dev // args.batch_size) * args.batch_size)
        ev_index = np.arange(pad_to) % n_dev
        ev_ids, ev_m, ev_t, ev_y = (a[ev_index]
                                    for a in (ev_ids, ev_m, ev_t, ev_y))
        reps_t = max(1, -(-2 * args.batch_size // max(len(tr_ids), 1)))
        tr_ids, tr_m, tr_t, tr_y = (np.concatenate([a] * reps_t)
                                    for a in (tr_ids, tr_m, tr_t, tr_y))
    else:
        all_ids, all_labels = synthetic(rng, 4096, args.seq_len, args.vocab)
        split = int(0.9 * len(all_ids))
        tr_ids, tr_y = all_ids[:split], all_labels[:split]
        ev_ids, ev_y = all_ids[split:], all_labels[split:]
        tr_m = np.ones(tr_ids.shape, np.float32)
        ev_m = np.ones(ev_ids.shape, np.float32)
        tr_t = np.zeros(tr_ids.shape, np.int32)
        ev_t = np.zeros(ev_ids.shape, np.int32)

    metrics = {}

    def evaluate():
        preds, gold, idxs = [], [], []
        for i in range(0, len(ev_ids) - args.batch_size + 1,
                       args.batch_size):
            sl = slice(i, i + args.batch_size)
            _, lg = ex.run("eval", feed_dict={
                ids: ev_ids[sl], tok_ids: ev_t[sl], mask: ev_m[sl],
                labels: ev_y[sl]}, convert_to_numpy_ret_vals=True)
            preds.append(lg.argmax(-1))
            gold.append(ev_y[sl])
            if args.task:
                idxs.append(ev_index[sl])
        if not preds:
            return 0.0
        preds = np.concatenate(preds)
        gold = np.concatenate(gold)
        if args.task:
            # deduplicate the wrap-padding: one vote per dev example
            uniq = {}
            for j, pr, gl in zip(np.concatenate(idxs), preds, gold):
                uniq[int(j)] = (pr, gl)
            preds = np.array([v[0] for v in uniq.values()])
            gold = np.array([v[1] for v in uniq.values()])
            metrics.update(compute_metrics(args.task, preds, gold))
            logger.info("eval metrics %s (%d examples)", metrics,
                        len(preds))
            return metrics["accuracy"]
        return float((preds == gold).mean())

    logger.info("initial eval accuracy %.3f", evaluate())
    losses, train_s = [], 0.0
    for step in range(args.num_steps):
        j = rng.randint(0, len(tr_ids) - args.batch_size)
        sl = slice(j, j + args.batch_size)
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict={
            ids: tr_ids[sl], tok_ids: tr_t[sl], mask: tr_m[sl],
            labels: tr_y[sl]})
        losses.append(float(out[0]))     # reads the loss: waits for it
        train_s += time.perf_counter() - t0
        if (step + 1) % args.eval_every == 0:
            acc = evaluate()
            logger.info("step %d loss %.4f eval acc %.3f (%.1f s)",
                        step + 1, losses[-1], acc, train_s)
    final = evaluate()
    logger.info("final eval accuracy %.3f", final)
    return {"accuracy": final, "metrics": dict(metrics), "losses": losses,
            "loaded": loaded, "backbone": backbone,
            "step_ms": 1e3 * train_s / max(args.num_steps, 1)}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
