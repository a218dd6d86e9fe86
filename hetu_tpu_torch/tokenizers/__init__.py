"""Tokenizers: the port's copy of the JAX package's
``hetu_tpu/tokenizers`` (pure Python, no JAX)."""

from .bert_tokenizer import (BasicTokenizer, BertTokenizer,
                             WordpieceTokenizer, load_vocab,
                             whitespace_tokenize)

__all__ = ["BertTokenizer", "BasicTokenizer", "WordpieceTokenizer",
           "load_vocab", "whitespace_tokenize"]
