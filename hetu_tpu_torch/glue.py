"""GLUE task processors: the port's copy of the JAX package's
``hetu_tpu/glue.py`` (reference
examples/nlp/bert/glue_processor/glue.py:54-325).

Each processor reads the task's official TSV column layout and yields
(text_a, text_b, label) examples; ``convert_examples_to_arrays`` encodes
them straight into the dense [N, S] numpy arrays the BERT models feed
([CLS] a [SEP] b [SEP] with segment ids and padding mask) — the
reference materializes per-example InputFeatures objects first; arrays
are the fixed-shape form.

Per-task metrics follow the GLUE evaluation spec: accuracy everywhere,
Matthews correlation for CoLA, F1 (+accuracy) for MRPC/QQP.
"""

from __future__ import annotations

import csv
import os

import numpy as np


class InputExample:
    __slots__ = ("guid", "text_a", "text_b", "label")

    def __init__(self, guid, text_a, text_b=None, label=None):
        self.guid = guid
        self.text_a = text_a
        self.text_b = text_b
        self.label = label


class DataProcessor:
    """Base: TSV reading + the per-split example builders."""

    def get_train_examples(self, data_dir):
        return self._create_examples(
            self._read_tsv(os.path.join(data_dir, "train.tsv")), "train")

    def get_dev_examples(self, data_dir):
        return self._create_examples(
            self._read_tsv(os.path.join(data_dir, "dev.tsv")), "dev")

    def get_labels(self):
        raise NotImplementedError

    @staticmethod
    def _read_tsv(path):
        with open(path, "r", encoding="utf-8") as f:
            return list(csv.reader(f, delimiter="\t",
                                   quotechar=None))

    def _create_examples(self, lines, set_type):
        raise NotImplementedError


class ColaProcessor(DataProcessor):
    """CoLA: no header; source \\t label \\t star \\t sentence."""

    def get_labels(self):
        return ["0", "1"]

    def _create_examples(self, lines, set_type):
        return [InputExample(f"{set_type}-{i}", text_a=ln[3],
                             label=ln[1])
                for i, ln in enumerate(lines)]


class Sst2Processor(DataProcessor):
    """SST-2: header; sentence \\t label."""

    def get_labels(self):
        return ["0", "1"]

    def _create_examples(self, lines, set_type):
        return [InputExample(f"{set_type}-{i}", text_a=ln[0],
                             label=ln[1])
                for i, ln in enumerate(lines[1:])]


class MrpcProcessor(DataProcessor):
    """MRPC: header; Quality \\t id1 \\t id2 \\t s1 \\t s2."""

    def get_labels(self):
        return ["0", "1"]

    def _create_examples(self, lines, set_type):
        return [InputExample(f"{set_type}-{i}", text_a=ln[3],
                             text_b=ln[4], label=ln[0])
                for i, ln in enumerate(lines[1:])]


class MnliProcessor(DataProcessor):
    """MNLI: header; sentence1 at col 8, sentence2 at col 9, gold label
    last."""

    def get_labels(self):
        return ["contradiction", "entailment", "neutral"]

    def get_dev_examples(self, data_dir):
        return self._create_examples(
            self._read_tsv(os.path.join(data_dir, "dev_matched.tsv")),
            "dev_matched")

    def _create_examples(self, lines, set_type):
        return [InputExample(f"{set_type}-{i}", text_a=ln[8],
                             text_b=ln[9], label=ln[-1])
                for i, ln in enumerate(lines[1:])]


class QqpProcessor(DataProcessor):
    """QQP: header; id, qid1, qid2, question1(3), question2(4),
    is_duplicate(5)."""

    def get_labels(self):
        return ["0", "1"]

    def _create_examples(self, lines, set_type):
        out = []
        for i, ln in enumerate(lines[1:]):
            if len(ln) < 6:
                continue                   # malformed rows exist in QQP
            out.append(InputExample(f"{set_type}-{i}", text_a=ln[3],
                                    text_b=ln[4], label=ln[5]))
        return out


PROCESSORS = {
    "cola": ColaProcessor,
    "mnli": MnliProcessor,
    "mrpc": MrpcProcessor,
    "sst-2": Sst2Processor,
    "qqp": QqpProcessor,
}


def convert_examples_to_arrays(examples, label_list, max_seq_length,
                               tokenizer):
    """[CLS] a [SEP] (b [SEP]) -> dense arrays:
    (input_ids [N,S] i32, attention_mask [N,S] f32,
     token_type_ids [N,S] i32, labels [N] i32).

    Pair truncation trims the longer side token-by-token (reference
    _truncate_seq_pair); single sequences clip at S-2."""
    label_map = {lab: i for i, lab in enumerate(label_list)}
    n, s = len(examples), max_seq_length
    pad_id = tokenizer.vocab.get("[PAD]", 0)
    ids = np.full((n, s), pad_id, np.int32)
    mask = np.zeros((n, s), np.float32)
    seg = np.zeros((n, s), np.int32)
    labels = np.zeros((n,), np.int32)
    for j, ex in enumerate(examples):
        ta = tokenizer.tokenize(ex.text_a)
        tb = tokenizer.tokenize(ex.text_b) if ex.text_b else None
        if tb is not None:
            while len(ta) + len(tb) > s - 3:
                (ta if len(ta) > len(tb) else tb).pop()
        else:
            ta = ta[:s - 2]
        tokens = ["[CLS]"] + ta + ["[SEP]"]
        seg_ids = [0] * len(tokens)
        if tb is not None:
            tokens += tb + ["[SEP]"]
            seg_ids += [1] * (len(tb) + 1)
        tok_ids = tokenizer.convert_tokens_to_ids(tokens)
        ids[j, :len(tok_ids)] = tok_ids
        mask[j, :len(tok_ids)] = 1.0
        seg[j, :len(seg_ids)] = seg_ids
        labels[j] = label_map[ex.label]
    return ids, mask, seg, labels


# --------------------------------------------------------------------- #
# GLUE metrics (reference compute_metrics role; the GLUE spec's per-task
# choices)
# --------------------------------------------------------------------- #

def accuracy(preds, labels):
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    return float((preds == labels).mean())


def matthews_corr(preds, labels):
    """CoLA's metric.  Clean-room from the definition:
    (TP*TN - FP*FN) / sqrt((TP+FP)(TP+FN)(TN+FP)(TN+FN))."""
    preds = np.asarray(preds).astype(bool)
    labels = np.asarray(labels).astype(bool)
    tp = float(np.sum(preds & labels))
    tn = float(np.sum(~preds & ~labels))
    fp = float(np.sum(preds & ~labels))
    fn = float(np.sum(~preds & labels))
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def f1(preds, labels):
    preds = np.asarray(preds).astype(bool)
    labels = np.asarray(labels).astype(bool)
    tp = float(np.sum(preds & labels))
    fp = float(np.sum(preds & ~labels))
    fn = float(np.sum(~preds & labels))
    if tp == 0:
        return 0.0
    prec = tp / (tp + fp)
    rec = tp / (tp + fn)
    return float(2 * prec * rec / (prec + rec))


def compute_metrics(task, preds, labels):
    task = task.lower()
    out = {"accuracy": accuracy(preds, labels)}
    if task == "cola":
        out["matthews_corr"] = matthews_corr(preds, labels)
    if task in ("mrpc", "qqp"):
        out["f1"] = f1(preds, labels)
    return out
