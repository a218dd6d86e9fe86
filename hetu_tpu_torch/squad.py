"""SQuAD processor + span-extraction metrics: the port's copy of the JAX
package's ``hetu_tpu/squad.py``.

Reference surface: the BERT example suite stages SQuAD v1.1/v2.0
(examples/nlp/bert/data/SquadDownloader.py:1, data/bertPrep.py:1 —
download + shard only; the feature/eval shapes below follow the
published SQuAD recipe those files feed).  This module is the
counterpart of glue.py for span prediction:

* ``read_squad_examples`` parses the official JSON into whitespace
  doc tokens with char→word offsets;
* ``convert_examples_to_features`` encodes sliding windows
  ([CLS] question [SEP] context-span [SEP]) with doc-stride overlap,
  wordpiece-refined answer spans, and window-relative start/end
  positions (0 = CLS when the answer falls outside the window);
* ``features_to_arrays`` emits the dense [N, S] numpy arrays the
  ``BertForQuestionAnswering`` head feeds;
* ``extract_predictions`` maps (start_logits, end_logits) back to
  answer text through the n-best span search;
* ``squad_evaluate`` scores predictions with the official
  normalization (lowercase, strip articles/punctuation) → EM / F1.
"""

from __future__ import annotations

import collections
import json
import re
import string

import numpy as np


def _is_whitespace(c):
    return c in " \t\r\n" or ord(c) == 0x202F


class SquadExample:
    """One question over one paragraph, tokenized at whitespace level."""

    __slots__ = ("qas_id", "question_text", "doc_tokens",
                 "orig_answer_text", "start_position", "end_position",
                 "is_impossible", "answers")

    def __init__(self, qas_id, question_text, doc_tokens,
                 orig_answer_text=None, start_position=None,
                 end_position=None, is_impossible=False, answers=()):
        self.qas_id = qas_id
        self.question_text = question_text
        self.doc_tokens = doc_tokens
        self.orig_answer_text = orig_answer_text
        self.start_position = start_position
        self.end_position = end_position
        self.is_impossible = is_impossible
        self.answers = list(answers)       # all gold texts (dev eval)


def read_squad_examples(path_or_data, is_training=True):
    """Official SQuAD JSON → SquadExamples.  ``is_training`` selects
    whether gold spans are required and char-aligned; v2.0's
    ``is_impossible`` entries get the (0, 0) null span."""
    if isinstance(path_or_data, (str, bytes)):
        with open(path_or_data, "r", encoding="utf-8") as f:
            data = json.load(f)
    else:
        data = path_or_data
    examples = []
    for entry in data["data"]:
        for para in entry["paragraphs"]:
            text = para["context"]
            doc_tokens = []
            char_to_word = []
            prev_ws = True
            for c in text:
                if _is_whitespace(c):
                    prev_ws = True
                else:
                    if prev_ws:
                        doc_tokens.append(c)
                    else:
                        doc_tokens[-1] += c
                    prev_ws = False
                char_to_word.append(len(doc_tokens) - 1)
            for qa in para["qas"]:
                start = end = None
                orig_answer = None
                impossible = bool(qa.get("is_impossible", False))
                answers = [a["text"] for a in qa.get("answers", [])]
                if is_training:
                    if impossible or not qa["answers"]:
                        start = end = 0 if impossible else None
                        if not impossible:
                            continue     # unanswerable in a v1.1 file
                        orig_answer = ""
                    else:
                        a = qa["answers"][0]
                        orig_answer = a["text"]
                        a_start = a["answer_start"]
                        start = char_to_word[a_start]
                        end = char_to_word[a_start + len(orig_answer) - 1]
                        # drop misaligned annotations (official recipe
                        # logs and skips when the span text mismatches)
                        actual = " ".join(doc_tokens[start:end + 1])
                        cleaned = " ".join(orig_answer.strip().split())
                        if cleaned not in actual:
                            continue
                examples.append(SquadExample(
                    qa["id"], qa["question"], doc_tokens, orig_answer,
                    start, end, impossible, answers))
    return examples


class SquadFeatures:
    """One max_seq_length window over one example."""

    __slots__ = ("unique_id", "example_index", "doc_span_index",
                 "tokens", "token_to_orig_map", "token_is_max_context",
                 "input_ids", "input_mask", "segment_ids",
                 "start_position", "end_position")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


def _improve_answer_span(doc_tokens, start, end, tokenizer, orig_text):
    """Wordpiece-tighten the span: the char-aligned whitespace span may
    include trailing punctuation the gold answer lacks."""
    tok_answer = " ".join(tokenizer.tokenize(orig_text))
    for new_start in range(start, end + 1):
        for new_end in range(end, new_start - 1, -1):
            span = " ".join(doc_tokens[new_start:new_end + 1])
            if span == tok_answer:
                return new_start, new_end
    return start, end


def _check_is_max_context(doc_spans, cur_index, position):
    """A token appearing in several overlapping windows scores only in
    the one where it has the most surrounding context."""
    best_score, best_index = None, None
    for i, (span_start, span_len) in enumerate(doc_spans):
        end = span_start + span_len - 1
        if position < span_start or position > end:
            continue
        score = (min(position - span_start, end - position)
                 + 0.01 * span_len)
        if best_score is None or score > best_score:
            best_score, best_index = score, i
    return best_index == cur_index


def convert_examples_to_features(examples, tokenizer, max_seq_length=384,
                                 doc_stride=128, max_query_length=64,
                                 is_training=True):
    features = []
    unique_id = 1000000000
    for ex_index, ex in enumerate(examples):
        query_tokens = tokenizer.tokenize(ex.question_text)
        # the question may never eat the whole window: keep >= 1 token
        # of context budget or the stride loop below cannot advance
        query_tokens = query_tokens[:min(max_query_length,
                                         max_seq_length - 4)]
        # wordpiece the whole doc once, remembering origins
        tok_to_orig = []
        orig_to_tok = []
        all_doc_tokens = []
        for i, tok in enumerate(ex.doc_tokens):
            orig_to_tok.append(len(all_doc_tokens))
            for sub in tokenizer.tokenize(tok):
                tok_to_orig.append(i)
                all_doc_tokens.append(sub)
        tok_start = tok_end = None
        if is_training and not ex.is_impossible:
            tok_start = orig_to_tok[ex.start_position]
            tok_end = (orig_to_tok[ex.end_position + 1] - 1
                       if ex.end_position < len(ex.doc_tokens) - 1
                       else len(all_doc_tokens) - 1)
            tok_start, tok_end = _improve_answer_span(
                all_doc_tokens, tok_start, tok_end, tokenizer,
                ex.orig_answer_text)
        # sliding windows of the remaining budget
        max_ctx = max_seq_length - len(query_tokens) - 3
        doc_spans = []
        offset = 0
        while offset < len(all_doc_tokens):
            length = min(len(all_doc_tokens) - offset, max_ctx)
            doc_spans.append((offset, length))
            if offset + length >= len(all_doc_tokens):
                break
            offset += min(length, doc_stride)
        for span_index, (span_start, span_len) in enumerate(doc_spans):
            tokens = ["[CLS]"] + query_tokens + ["[SEP]"]
            segment_ids = [0] * len(tokens)
            token_to_orig_map = {}
            token_is_max_context = {}
            for i in range(span_len):
                pos = span_start + i
                token_to_orig_map[len(tokens)] = tok_to_orig[pos]
                token_is_max_context[len(tokens)] = _check_is_max_context(
                    doc_spans, span_index, pos)
                tokens.append(all_doc_tokens[pos])
                segment_ids.append(1)
            tokens.append("[SEP]")
            segment_ids.append(1)
            input_ids = tokenizer.convert_tokens_to_ids(tokens)
            input_mask = [1] * len(input_ids)
            pad = max_seq_length - len(input_ids)
            input_ids += [0] * pad
            input_mask += [0] * pad
            segment_ids += [0] * pad
            start_position = end_position = 0
            if is_training and not ex.is_impossible:
                span_end = span_start + span_len - 1
                if tok_start >= span_start and tok_end <= span_end:
                    doc_offset = len(query_tokens) + 2
                    start_position = tok_start - span_start + doc_offset
                    end_position = tok_end - span_start + doc_offset
                # else: answer outside this window → (0, 0) = CLS
            features.append(SquadFeatures(
                unique_id=unique_id, example_index=ex_index,
                doc_span_index=span_index, tokens=tokens,
                token_to_orig_map=token_to_orig_map,
                token_is_max_context=token_is_max_context,
                input_ids=input_ids, input_mask=input_mask,
                segment_ids=segment_ids, start_position=start_position,
                end_position=end_position))
            unique_id += 1
    return features


def features_to_arrays(features):
    """Dense arrays for BertForQuestionAnswering: ids/mask/segments
    [N, S] int32 + start/end positions [N] int32."""
    return {
        "input_ids": np.asarray([f.input_ids for f in features],
                                np.int32),
        "input_mask": np.asarray([f.input_mask for f in features],
                                 np.int32),
        "segment_ids": np.asarray([f.segment_ids for f in features],
                                  np.int32),
        "start_positions": np.asarray(
            [f.start_position for f in features], np.int32),
        "end_positions": np.asarray(
            [f.end_position for f in features], np.int32),
    }


def _best_indexes(logits, n_best_size):
    return list(np.argsort(np.asarray(logits))[::-1][:n_best_size])


def extract_predictions(examples, features, start_logits, end_logits,
                        n_best_size=20, max_answer_length=30):
    """(start_logits, end_logits) [N, S] → {qas_id: answer_text} via
    the n-best valid-span search over each example's windows."""
    by_example = collections.defaultdict(list)
    for i, f in enumerate(features):
        by_example[f.example_index].append((f, i))
    predictions = {}
    for ex_index, ex in enumerate(examples):
        best_score, best_text = None, ""
        for f, i in by_example.get(ex_index, ()):
            s_logits = np.asarray(start_logits[i])
            e_logits = np.asarray(end_logits[i])
            for s in _best_indexes(s_logits, n_best_size):
                for e in _best_indexes(e_logits, n_best_size):
                    if s not in f.token_to_orig_map:
                        continue
                    if e not in f.token_to_orig_map:
                        continue
                    if not f.token_is_max_context.get(s, False):
                        continue
                    if e < s or e - s + 1 > max_answer_length:
                        continue
                    score = float(s_logits[s] + e_logits[e])
                    if best_score is None or score > best_score:
                        orig_text = " ".join(
                            ex.doc_tokens[f.token_to_orig_map[s]:
                                          f.token_to_orig_map[e] + 1])
                        best_score, best_text = score, orig_text
        predictions[ex.qas_id] = best_text
    return predictions


# ------------------------- official metrics ------------------------- #

def normalize_answer(s):
    """Lower, strip punctuation/articles, collapse whitespace (the
    official evaluate-v1.1 normalization)."""
    s = s.lower()
    s = "".join(c for c in s if c not in string.punctuation)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match_score(prediction, ground_truth):
    return float(normalize_answer(prediction)
                 == normalize_answer(ground_truth))


def f1_score(prediction, ground_truth):
    pred_tokens = normalize_answer(prediction).split()
    gold_tokens = normalize_answer(ground_truth).split()
    if not pred_tokens or not gold_tokens:
        # v2 no-answer convention: empty matches only empty
        return float(pred_tokens == gold_tokens)
    common = (collections.Counter(pred_tokens)
              & collections.Counter(gold_tokens))
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gold_tokens)
    return 2 * precision * recall / (precision + recall)


def _metric_max_over_ground_truths(metric, prediction, ground_truths):
    return max(metric(prediction, gt) for gt in ground_truths)


def squad_evaluate(examples, predictions):
    """{exact_match, f1} percentages.  Gold answers come from the
    dev-style ``answers`` lists (falling back to the training span);
    v2.0 ``is_impossible`` questions score against the empty string —
    the official v2 metric counts them, crediting only an empty
    prediction."""
    em = f1 = count = 0
    for ex in examples:
        golds = ex.answers or (
            [ex.orig_answer_text] if ex.orig_answer_text else [])
        if ex.is_impossible:
            golds = [""]
        if not golds:
            continue
        pred = predictions.get(ex.qas_id, "")
        em += _metric_max_over_ground_truths(exact_match_score, pred,
                                             golds)
        f1 += _metric_max_over_ground_truths(f1_score, pred, golds)
        count += 1
    if count == 0:
        return {"exact_match": 0.0, "f1": 0.0}
    return {"exact_match": 100.0 * em / count,
            "f1": 100.0 * f1 / count}
