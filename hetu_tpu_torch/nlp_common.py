"""Shared helpers of the NLP entry points (``train_bert``,
``finetune_bert_glue``, ``finetune_bert_squad``): the port of the JAX
package's ``examples/nlp/common.py``."""

import itertools
import os
import tempfile

import numpy as np

from .pretraining_data import (PretrainingBatches,
                               create_bert_pretraining_data,
                               load_or_build_tokenizer)


def hermetic_tokenizer(text_lines, vocab_path=None):
    """A wordpiece tokenizer from --vocab-path, or built hermetically
    from the dataset's own text (temp corpus + derived vocab cleaned
    up).  Shared by the GLUE and SQuAD fine-tunes."""
    if vocab_path:
        return load_or_build_tokenizer(None, vocab_path)
    fd, corpus = tempfile.mkstemp(suffix=".txt")
    try:
        with os.fdopen(fd, "w") as f:
            for line in text_lines:
                f.write(line + "\n")
        return load_or_build_tokenizer(corpus)
    finally:
        for path in (corpus, corpus + ".vocab.txt"):
            try:
                os.remove(path)
            except OSError:
                pass


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


def corpus_mlm_stream(data_path, vocab_path, batch_size, seq_len,
                      dupe_factor=5, seed=0):
    """Raw-text corpus -> endless (ids, token_type, attention_mask,
    mlm_labels, nsp) batch stream through the pretraining pipeline
    (``pretraining_data``).  Returns (stream, vocab_size).  Builds a
    wordpiece vocab from the corpus when no vocab file is given."""
    tok = load_or_build_tokenizer(data_path, vocab_path)
    data = create_bert_pretraining_data(
        data_path, tok, max_seq_length=seq_len, dupe_factor=dupe_factor,
        seed=seed)
    batches = PretrainingBatches(data, batch_size, seed=seed)

    def stream():
        for b in itertools.chain.from_iterable(itertools.repeat(batches)):
            yield (b["input_ids"], b["token_type_ids"],
                   b["attention_mask"], b["masked_lm_labels"],
                   b["next_sentence_label"])

    return stream(), len(tok.vocab)
