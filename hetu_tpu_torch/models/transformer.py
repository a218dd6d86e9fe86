"""Encoder-decoder MT Transformer on the graph surface: the port of the
JAX package's ``models/transformer.py``.

Token + sinusoid position embeddings, N encoder blocks (self-attention +
FFN), N decoder blocks (causal self-attention + cross-attention + FFN),
an output projection and sparse softmax CE with the padding id ignored.
Cross-attention is built inline from the op surface; the causal mask is
an additive (1, 1, S, S) triangle broadcast over (B, nh, S, S).
"""

from __future__ import annotations

import math

import numpy as np

from ..graph import (
    embedding_lookup_op, array_reshape_op, broadcast_shape_op, transpose_op,
    batch_matmul_op, softmax_op, mul_byconst_op, broadcastto_op, matmul_op,
    relu_op, dropout_op, softmaxcrossentropy_sparse_op, reduce_mean_op,
)
from ..graph import init, layers
from ..graph.ops_attention import causal_mask_op
from ..graph.ops_misc import Variable


class TransformerConfig:
    def __init__(self, src_vocab_size=32000, tgt_vocab_size=32000,
                 hidden_size=512, num_layers=6, num_heads=8, ffn_size=2048,
                 dropout_rate=0.1, batch_size=8, src_len=64, tgt_len=64,
                 pad_id=0):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.dropout_rate = dropout_rate
        self.batch_size = batch_size
        self.src_len = src_len
        self.tgt_len = tgt_len
        self.pad_id = pad_id


def _sinusoid_table(max_len, hidden):
    pos = np.arange(max_len)[:, None].astype(np.float32)
    dim = np.arange(hidden)[None, :].astype(np.float32)
    angle = pos / np.power(10000.0, 2 * (dim // 2) / hidden)
    table = np.zeros((max_len, hidden), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class _MHA:
    """Inline multi-head attention supporting distinct q and kv sources."""

    def __init__(self, cfg, q_len, kv_len, name):
        h = cfg.hidden_size
        self.cfg = cfg
        self.q_len, self.kv_len = q_len, kv_len
        self.nh = cfg.num_heads
        self.hd = h // cfg.num_heads
        ini = init.GenXavierUniform()
        self.wq = ini(shape=(h, h), name=name + "_q_weight")
        self.wk = ini(shape=(h, h), name=name + "_k_weight")
        self.wv = ini(shape=(h, h), name=name + "_v_weight")
        self.wo = ini(shape=(h, h), name=name + "_proj_weight")

    def _heads(self, x, seq):
        b = self.cfg.batch_size
        x = array_reshape_op(x, [b, seq, self.nh, self.hd])
        return transpose_op(x, [0, 2, 1, 3])

    def __call__(self, q_in, kv_in, mask=None):
        cfg = self.cfg
        q = self._heads(matmul_op(q_in, self.wq), self.q_len)
        k = self._heads(matmul_op(kv_in, self.wk), self.kv_len)
        v = self._heads(matmul_op(kv_in, self.wv), self.kv_len)
        scores = mul_byconst_op(batch_matmul_op(q, k, trans_B=True),
                                1.0 / math.sqrt(self.hd))
        if mask is not None:
            scores = scores + broadcastto_op(mask, scores)
        probs = softmax_op(scores)
        if cfg.dropout_rate > 0:
            probs = dropout_op(probs, 1.0 - cfg.dropout_rate)
        out = batch_matmul_op(probs, v)
        out = transpose_op(out, [0, 2, 1, 3])
        out = array_reshape_op(out,
                               [cfg.batch_size * self.q_len,
                                cfg.hidden_size])
        return matmul_op(out, self.wo)


class _FFN:
    def __init__(self, cfg, name):
        self.cfg = cfg
        self.wi = layers.Linear(cfg.hidden_size, cfg.ffn_size,
                                name=name + "_wi")
        self.wo = layers.Linear(cfg.ffn_size, cfg.hidden_size,
                                name=name + "_wo")

    def __call__(self, x):
        out = self.wo(relu_op(self.wi(x)))
        if self.cfg.dropout_rate > 0:
            out = dropout_op(out, 1.0 - self.cfg.dropout_rate)
        return out


class Transformer:
    """Full encoder-decoder model; __call__ returns (loss, logits)."""

    def __init__(self, config: TransformerConfig, name="transformer"):
        cfg = config
        self.cfg = cfg
        h = cfg.hidden_size
        self.src_emb = init.random_normal((cfg.src_vocab_size, h),
                                          stddev=0.02,
                                          name=name + "_src_emb")
        self.tgt_emb = init.random_normal((cfg.tgt_vocab_size, h),
                                          stddev=0.02,
                                          name=name + "_tgt_emb")
        self.src_pos = Variable(
            name + "_src_pos", value=_sinusoid_table(cfg.src_len, h),
            trainable=False)
        self.tgt_pos = Variable(
            name + "_tgt_pos", value=_sinusoid_table(cfg.tgt_len, h),
            trainable=False)
        self.causal_mask = causal_mask_op(cfg.tgt_len, neg=-1e9)

        self.enc = []
        for i in range(cfg.num_layers):
            self.enc.append({
                "attn": _MHA(cfg, cfg.src_len, cfg.src_len,
                             f"{name}_enc{i}_attn"),
                "ln1": layers.LayerNorm(h, name=f"{name}_enc{i}_ln1"),
                "ffn": _FFN(cfg, f"{name}_enc{i}_ffn"),
                "ln2": layers.LayerNorm(h, name=f"{name}_enc{i}_ln2"),
            })
        self.dec = []
        for i in range(cfg.num_layers):
            self.dec.append({
                "self": _MHA(cfg, cfg.tgt_len, cfg.tgt_len,
                             f"{name}_dec{i}_self"),
                "ln1": layers.LayerNorm(h, name=f"{name}_dec{i}_ln1"),
                "cross": _MHA(cfg, cfg.tgt_len, cfg.src_len,
                              f"{name}_dec{i}_cross"),
                "ln2": layers.LayerNorm(h, name=f"{name}_dec{i}_ln2"),
                "ffn": _FFN(cfg, f"{name}_dec{i}_ffn"),
                "ln3": layers.LayerNorm(h, name=f"{name}_dec{i}_ln3"),
            })
        self.out_proj = layers.Linear(h, cfg.tgt_vocab_size,
                                      name=name + "_out_proj")

    def _embed(self, ids, table, pos_table, seq):
        cfg = self.cfg
        h = cfg.hidden_size
        emb = embedding_lookup_op(table, ids)
        emb = mul_byconst_op(emb, math.sqrt(h))
        emb = emb + broadcast_shape_op(pos_table,
                                       (cfg.batch_size, seq, h),
                                       add_axes=[0])
        emb = array_reshape_op(emb, [cfg.batch_size * seq, h])
        if cfg.dropout_rate > 0:
            emb = dropout_op(emb, 1.0 - cfg.dropout_rate)
        return emb

    def encode(self, src_ids):
        cfg = self.cfg
        x = self._embed(src_ids, self.src_emb, self.src_pos, cfg.src_len)
        for blk in self.enc:
            x = blk["ln1"](x + blk["attn"](x, x))
            x = blk["ln2"](x + blk["ffn"](x))
        return x

    def decode(self, tgt_ids, memory):
        cfg = self.cfg
        x = self._embed(tgt_ids, self.tgt_emb, self.tgt_pos, cfg.tgt_len)
        for blk in self.dec:
            x = blk["ln1"](x + blk["self"](x, x, mask=self.causal_mask))
            x = blk["ln2"](x + blk["cross"](x, memory))
            x = blk["ln3"](x + blk["ffn"](x))
        return x

    def __call__(self, src_ids, tgt_ids, labels=None):
        cfg = self.cfg
        memory = self.encode(src_ids)
        hidden = self.decode(tgt_ids, memory)
        logits = self.out_proj(hidden)
        if labels is None:
            return logits
        labels_flat = array_reshape_op(labels,
                                       [cfg.batch_size * cfg.tgt_len])
        loss = softmaxcrossentropy_sparse_op(logits, labels_flat,
                                             ignored_index=cfg.pad_id)
        return reduce_mean_op(loss, [0]), logits


def transformer_mt(src_ids, tgt_ids, labels, config=None):
    """Functional wrapper matching train_hetu_transformer.py usage."""
    model = Transformer(config or TransformerConfig())
    return model(src_ids, tgt_ids, labels)
