"""BERT wordpiece tokenizer: the port's copy of the JAX package's
``hetu_tpu/tokenizers/bert_tokenizer.py`` (reference
tokenizers/bert_tokenizer.py), line for line.

Pure-python, offline: `from_pretrained` resolves only local vocab files
(the reference downloads from S3, bert_tokenizer.py:122-158; this build has
no egress, so pass a path).  Algorithmic behavior matches the reference:
basic tokenization (lowercase, accent stripping, punctuation splitting,
CJK spacing, control-char cleaning) followed by greedy longest-match-first
wordpiece with '##' continuation prefixes.
"""

from __future__ import annotations

import collections
import os
import unicodedata


def load_vocab(vocab_file):
    """vocab file: one token per line -> OrderedDict token -> id.

    Ids are assigned sequentially per line (reference
    bert_tokenizer.py:52-64) so they match the embedding rows a checkpoint
    was trained with; tokens are whitespace-stripped so CRLF files load
    correctly."""
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.strip()
            vocab[token] = idx
    # a trailing newline yields one empty token; drop it unless the file
    # really maps "" (it never does in practice)
    vocab.pop("", None)
    return vocab


def whitespace_tokenize(text):
    text = text.strip()
    return text.split() if text else []


def _is_whitespace(char):
    if char in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(char) == "Zs"


def _is_control(char):
    if char in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(char).startswith("C")


def _is_punctuation(char):
    cp = ord(char)
    # ASCII non-alphanumeric ranges count as punctuation (reference
    # bert_tokenizer.py:350-363)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(char).startswith("P")


class BasicTokenizer:
    """Whitespace/punctuation/accent/CJK normalization pass."""

    def __init__(self, do_lower_case=True,
                 never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]",
                              "[MASK]")):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text):
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        out = []
        for token in whitespace_tokenize(text):
            if token in self.never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = self._run_strip_accents(token.lower())
            out.extend(self._run_split_on_punc(token))
        return whitespace_tokenize(" ".join(out))

    def _run_strip_accents(self, text):
        text = unicodedata.normalize("NFD", text)
        return "".join(c for c in text
                       if unicodedata.category(c) != "Mn")

    def _run_split_on_punc(self, text):
        if text in self.never_split:
            return [text]
        out, word = [], []
        for char in text:
            if _is_punctuation(char):
                out.append(char)
                word = []
            else:
                if not word:
                    out.append("")
                word.append(char)
                out[-1] += char
        return [t for t in out if t]

    def _tokenize_chinese_chars(self, text):
        out = []
        for char in text:
            if self._is_chinese_char(ord(char)):
                out.append(f" {char} ")
            else:
                out.append(char)
        return "".join(out)

    @staticmethod
    def _is_chinese_char(cp):
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _clean_text(self, text):
        out = []
        for char in text:
            cp = ord(char)
            if cp == 0 or cp == 0xFFFD or _is_control(char):
                continue
            out.append(" " if _is_whitespace(char) else char)
        return "".join(out)


class WordpieceTokenizer:
    """Greedy longest-match-first subword split (reference :270-324)."""

    def __init__(self, vocab, unk_token="[UNK]",
                 max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text):
        out = []
        for token in whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            is_bad, start, sub_tokens = False, 0, []
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    is_bad = True
                    break
                sub_tokens.append(cur)
                start = end
            out.extend([self.unk_token] if is_bad else sub_tokens)
        return out


class BertTokenizer:
    """End-to-end BERT tokenizer (reference :76-158)."""

    def __init__(self, vocab_file, do_lower_case=True, max_len=None,
                 never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]",
                              "[MASK]")):
        if not os.path.isfile(vocab_file):
            raise ValueError(f"vocab file not found: {vocab_file}")
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(
            do_lower_case=do_lower_case, never_split=never_split)
        self.wordpiece_tokenizer = WordpieceTokenizer(vocab=self.vocab)
        self.max_len = max_len if max_len is not None else int(1e12)

    def tokenize(self, text):
        tokens = []
        for token in self.basic_tokenizer.tokenize(text):
            tokens.extend(self.wordpiece_tokenizer.tokenize(token))
        return tokens

    def convert_tokens_to_ids(self, tokens):
        ids = [self.vocab[t] if t in self.vocab
               else self.vocab.get("[UNK]", 0) for t in tokens]
        if len(ids) > self.max_len:
            raise ValueError(
                f"sequence length {len(ids)} > max_len {self.max_len}")
        return ids

    def convert_ids_to_tokens(self, ids):
        return [self.ids_to_tokens[i] for i in ids]

    def encode(self, text_a, text_b=None, max_length=None, pad=True):
        """[CLS] a [SEP] (b [SEP]) with token_type ids + mask — the input
        recipe of examples/nlp/bert."""
        ta = self.tokenize(text_a)
        tb = self.tokenize(text_b) if text_b else []
        max_length = max_length or self.max_len
        budget = max_length - (3 if tb else 2)
        while len(ta) + len(tb) > budget:
            (ta if len(ta) >= len(tb) else tb).pop()
        tokens = ["[CLS]"] + ta + ["[SEP]"]
        types = [0] * len(tokens)
        if tb:
            tokens += tb + ["[SEP]"]
            types += [1] * (len(tb) + 1)
        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        if pad:
            pad_id = self.vocab.get("[PAD]", 0)
            while len(ids) < max_length:
                ids.append(pad_id)
                types.append(0)
                mask.append(0)
        return {"input_ids": ids, "token_type_ids": types,
                "attention_mask": mask}

    @classmethod
    def from_pretrained(cls, vocab_path, **kwargs):
        """Local path only (no egress): a vocab.txt file or a directory
        containing one."""
        if os.path.isdir(vocab_path):
            vocab_path = os.path.join(vocab_path, "vocab.txt")
        return cls(vocab_path, **kwargs)
