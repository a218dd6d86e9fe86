"""Raw-corpus BERT/GPT pretraining data pipeline: the port's copy of the
JAX package's ``hetu_tpu/pretraining_data.py`` (reference
examples/nlp/bert/create_pretraining_data.py:146-476 + load_data.py);
numpy ``RandomState`` throughout, so its arrays equal JAX's at one seed.

Turns a raw text corpus — one sentence per line, blank lines between
documents — into fixed-shape pretraining arrays:

* ``create_bert_pretraining_data``: [CLS] A [SEP] B [SEP] instances with
  50% random-next NSP sampling, random front/back truncation, and
  80/10/10 masked-LM corruption (mask/keep/random), the reference's
  instance recipe.  Labels come out as a DENSE [N, S] grid with -1 at
  unmasked positions — the form the model's fused masked-mean loss
  consumes — instead of the reference's (positions, labels) pair lists,
  which exist to feed its gather-based loss.
* ``create_gpt_pretraining_data``: documents packed into a contiguous
  token stream and cut into [N, S] blocks with pre-shifted next-token
  labels (-1 on the final position), the decoder-family equivalent.
* ``build_wordpiece_vocab``: an offline vocab builder (whole words +
  suffix pieces + specials) so the pipeline is hermetic — the reference
  downloads a fixed vocab.txt from S3; with zero egress we build one
  from the corpus itself when none is checked in.

Everything is host-side numpy; batches feed placeholders or the
Dataloader ring unchanged.
"""

from __future__ import annotations

import collections

import numpy as np

IGNORE_INDEX = -1
SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def read_documents(path, tokenizer):
    """Corpus file -> list of documents, each a list of token lists
    (reference create_training_instances:150-173: one sentence per
    line, blank line = document boundary, empty docs dropped)."""
    docs = [[]]
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                if docs[-1]:
                    docs.append([])
                continue
            toks = tokenizer.tokenize(line)
            if toks:
                docs[-1].append(toks)
    return [d for d in docs if d]


def build_wordpiece_vocab(corpus_path, out_path=None, max_words=8000):
    """Offline vocab: specials, then a character base vocab (plain and
    '##'-continued, so EVERY word decomposes into pieces instead of
    collapsing to [UNK]), then corpus words by frequency.  Hermetic
    replacement for the reference's downloaded vocab.txt (its
    tokenization.py assumes one exists); round-trips through
    BertTokenizer.from_pretrained.

    Default ``out_path`` is ``<corpus>.vocab.txt`` — a clearly derived
    name that never clobbers a curated vocab.txt sitting next to the
    corpus."""
    from .tokenizers.bert_tokenizer import BasicTokenizer
    basic = BasicTokenizer(do_lower_case=True)
    counts = collections.Counter()
    chars = set()
    with open(corpus_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                toks = basic.tokenize(line)
                counts.update(toks)
                for t in toks:
                    chars.update(t)
    vocab = list(SPECIALS)
    vocab.extend(sorted(chars))
    vocab.extend("##" + c for c in sorted(chars))
    seen = set(vocab)
    for w, _n in counts.most_common(max_words):
        if w not in seen:
            vocab.append(w)
            seen.add(w)
    if out_path is None:
        out_path = corpus_path + ".vocab.txt"
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return out_path


def load_or_build_tokenizer(corpus_path, vocab_path=None):
    """The shared vocab-bootstrap: use ``vocab_path`` when given, else
    build (or reuse) the derived ``<corpus>.vocab.txt``."""
    from .tokenizers import BertTokenizer
    if not vocab_path:
        vocab_path = build_wordpiece_vocab(corpus_path)
    return BertTokenizer.from_pretrained(vocab_path)


def corpus_token_stream(corpus_path, tokenizer, eos_token="[SEP]"):
    """All documents as ONE flat np.int32 id stream with ``eos_token``
    between documents — the decoder-family packing input."""
    docs = read_documents(corpus_path, tokenizer)
    if not docs:
        raise ValueError(f"no documents in corpus {corpus_path}")
    eos = tokenizer.vocab.get(eos_token, 0)
    stream = []
    for doc in docs:
        for sent in doc:
            stream.extend(tokenizer.convert_tokens_to_ids(sent))
        stream.append(eos)
    return np.asarray(stream, np.int32)


def _mask_tokens(tokens, masked_lm_prob, max_predictions_per_seq,
                 vocab_words, rng):
    """80/10/10 masked-LM corruption over non-special positions
    (reference create_masked_lm_predictions:314-364).  Returns
    (corrupted tokens, {position: original token})."""
    cand = [i for i, t in enumerate(tokens) if t not in ("[CLS]", "[SEP]")]
    rng.shuffle(cand)
    n_pred = min(max_predictions_per_seq,
                 max(1, int(round(len(tokens) * masked_lm_prob))))
    out = list(tokens)
    labels = {}
    for i in cand[:n_pred]:
        r = rng.random()
        if r < 0.8:
            out[i] = "[MASK]"
        elif r < 0.9:
            pass                                   # keep original
        else:
            out[i] = vocab_words[rng.randint(0, len(vocab_words) - 1)]
        labels[i] = tokens[i]
    return out, labels


def _truncate_pair(tokens_a, tokens_b, max_num_tokens, rng):
    """Trim the longer side, randomly from front or back (reference
    truncate_seq_pair:367-383)."""
    while len(tokens_a) + len(tokens_b) > max_num_tokens:
        trunc = tokens_a if len(tokens_a) > len(tokens_b) else tokens_b
        if rng.random() < 0.5:
            del trunc[0]
        else:
            trunc.pop()


def _instances_from_document(docs, doc_index, max_seq_length,
                             short_seq_prob, masked_lm_prob,
                             max_predictions_per_seq, vocab_words, rng):
    """NSP instance construction for one document (reference
    create_instances_from_document:191-311): greedy sentence chunks to a
    target length, random A/B split, 50% random-next B drawn from
    another document (unused segments pushed back)."""
    document = docs[doc_index]
    max_num_tokens = max_seq_length - 3          # [CLS] a [SEP] b [SEP]
    target_len = max_num_tokens
    if rng.random() < short_seq_prob:
        target_len = rng.randint(2, max_num_tokens)

    instances = []
    chunk, chunk_len = [], 0
    i = 0
    while i < len(document):
        chunk.append(document[i])
        chunk_len += len(document[i])
        if i == len(document) - 1 or chunk_len >= target_len:
            if chunk:
                a_end = 1 if len(chunk) < 2 else rng.randint(
                    1, len(chunk) - 1)
                tokens_a = [t for seg in chunk[:a_end] for t in seg]
                tokens_b = []
                is_random_next = False
                if len(chunk) == 1 or (len(docs) > 1
                                       and rng.random() < 0.5):
                    # random-next: B from another document; put the
                    # unused tail of this chunk back
                    target_b = target_len - len(tokens_a)
                    rand_doc_idx = doc_index
                    for _ in range(10):
                        rand_doc_idx = rng.randint(0, len(docs) - 1)
                        if rand_doc_idx != doc_index:
                            break
                    if rand_doc_idx != doc_index:
                        is_random_next = True
                        rand_doc = docs[rand_doc_idx]
                        start = rng.randint(0, len(rand_doc) - 1)
                        for seg in rand_doc[start:]:
                            tokens_b.extend(seg)
                            if len(tokens_b) >= target_b:
                                break
                        i -= len(chunk) - a_end
                if not is_random_next:
                    tokens_b = [t for seg in chunk[a_end:] for t in seg]
                if tokens_a and tokens_b:
                    _truncate_pair(tokens_a, tokens_b, max_num_tokens, rng)
                    tokens = (["[CLS]"] + tokens_a + ["[SEP]"]
                              + tokens_b + ["[SEP]"])
                    seg_ids = ([0] * (len(tokens_a) + 2)
                               + [1] * (len(tokens_b) + 1))
                    tokens, labels = _mask_tokens(
                        tokens, masked_lm_prob, max_predictions_per_seq,
                        vocab_words, rng)
                    instances.append((tokens, seg_ids, labels,
                                      int(is_random_next)))
            chunk, chunk_len = [], 0
        i += 1
    return instances


def create_bert_pretraining_data(corpus_path, tokenizer, max_seq_length=128,
                                 dupe_factor=2, short_seq_prob=0.1,
                                 masked_lm_prob=0.15,
                                 max_predictions_per_seq=20, seed=12345):
    """Corpus file -> dict of fixed-shape arrays:

    input_ids / token_type_ids / attention_mask: [N, S] int32/float32
    masked_lm_labels: [N, S] int32, IGNORE_INDEX except masked positions
    next_sentence_label: [N] int32 (1 = random next)
    """
    rng = np.random.RandomState(seed)

    class _R:        # reference uses python random; keep one interface
        random = staticmethod(lambda: float(rng.rand()))
        randint = staticmethod(
            lambda a, b: int(rng.randint(a, b + 1)))    # inclusive hi
        shuffle = staticmethod(rng.shuffle)

    docs = read_documents(corpus_path, tokenizer)
    if not docs:
        raise ValueError(f"no documents in corpus {corpus_path}")
    vocab_words = list(tokenizer.vocab.keys())
    instances = []
    for _ in range(dupe_factor):
        order = list(range(len(docs)))
        rng.shuffle(order)
        for di in order:
            instances.extend(_instances_from_document(
                docs, di, max_seq_length, short_seq_prob, masked_lm_prob,
                max_predictions_per_seq, vocab_words, _R))
    rng.shuffle(instances)

    n, s = len(instances), max_seq_length
    pad_id = tokenizer.vocab.get("[PAD]", 0)
    ids = np.full((n, s), pad_id, np.int32)
    seg = np.zeros((n, s), np.int32)
    mask = np.zeros((n, s), np.float32)
    mlm = np.full((n, s), IGNORE_INDEX, np.int32)
    nsp = np.zeros((n,), np.int32)
    for j, (tokens, seg_ids, labels, is_rand) in enumerate(instances):
        tok_ids = tokenizer.convert_tokens_to_ids(tokens)
        L = len(tok_ids)
        ids[j, :L] = tok_ids
        seg[j, :L] = seg_ids
        mask[j, :L] = 1.0
        for pos, orig in labels.items():
            mlm[j, pos] = tokenizer.convert_tokens_to_ids([orig])[0]
        nsp[j] = is_rand
    return {"input_ids": ids, "token_type_ids": seg,
            "attention_mask": mask, "masked_lm_labels": mlm,
            "next_sentence_label": nsp}


def create_gpt_pretraining_data(corpus_path, tokenizer, seq_len=128,
                                eos_token="[SEP]"):
    """Decoder-family packing: all documents joined into one token
    stream (eos between docs), cut into [N, seq_len] blocks; labels are
    the stream shifted by one with IGNORE_INDEX at each block's last
    position (the next token lives in the following block)."""
    stream = corpus_token_stream(corpus_path, tokenizer,
                                 eos_token=eos_token)
    n = len(stream) // seq_len
    if n == 0:
        raise ValueError(
            f"corpus has {len(stream)} tokens < seq_len {seq_len}")
    arr = np.asarray(stream[:n * seq_len], np.int32).reshape(n, seq_len)
    labels = np.full((n, seq_len), IGNORE_INDEX, np.int32)
    labels[:, :-1] = arr[:, 1:]
    return {"input_ids": arr, "labels": labels}


class PretrainingBatches:
    """Shuffling epoch iterator over the instance arrays; yields dicts
    of [batch, ...] slices (drop-last).  Feed to placeholders or wrap in
    the Dataloader ring."""

    def __init__(self, data, batch_size, seed=0):
        self.data = data
        self.batch_size = batch_size
        self.n = next(iter(data.values())).shape[0]
        if self.n < batch_size:
            raise ValueError(
                f"{self.n} instances < batch_size {batch_size}; lower "
                f"the batch size or raise dupe_factor")
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        order = self.rng.permutation(self.n)
        for i in range(0, self.n - self.batch_size + 1, self.batch_size):
            sel = order[i:i + self.batch_size]
            yield {k: v[sel] for k, v in self.data.items()}
