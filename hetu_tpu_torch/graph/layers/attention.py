"""Multi-head attention layer composed from the op surface, with both of
the JAX layer's paths: the flash path (``flash_attention_op``: K2 forward
and K3 backward on CUDA, causal and ``kv_lens`` masks inside the kernel),
taken when ``use_flash`` is set, no additive mask is given and dropout is
off; and the unfused chain (scaled scores, the causal triangle, an
additive mask, softmax, probability dropout, the weighted sum), which
runs no kernel."""

from __future__ import annotations

import math

from .. import init
from ..ops_attention import causal_mask_op, flash_attention_op
from ..ops_conv import dropout_op
from ..ops_math import mul_byconst_op, softmax_op
from ..ops_matmul import batch_matmul_op, linear_op
from ..ops_shape import (array_reshape_op, broadcastto_op, concatenate_op,
                         slice_op, transpose_op)
from .base import BaseLayer


class MultiHeadAttention(BaseLayer):
    """Multi-head attention with an optional fused flash path.
    ``block_q``/``block_k`` are passed to ``flash_attention_op``, which
    accepts and does not use them."""

    def __init__(self, hidden_size, num_heads, seq_len, batch_size,
                 dropout_rate=0.0, initializer=None, name="attn",
                 use_flash=False, causal=False, block_q=512, block_k=1024,
                 fused_qkv=True):
        assert hidden_size % num_heads == 0
        self.h = hidden_size
        self.nh = num_heads
        self.hd = hidden_size // num_heads
        self.seq = seq_len
        # batch_size is accepted for API parity; reshapes use -1
        self.keep_prob = 1.0 - dropout_rate
        self.name = name
        self.use_flash = use_flash
        self.causal = causal
        self.block_q = block_q
        self.block_k = block_k
        ini = initializer or init.GenXavierUniform()
        self.wq = ini(shape=(self.h, self.h), name=name + "_q_weight")
        self.wk = ini(shape=(self.h, self.h), name=name + "_k_weight")
        self.wv = ini(shape=(self.h, self.h), name=name + "_v_weight")
        self.wo = ini(shape=(self.h, self.h), name=name + "_proj_weight")
        self.bq = init.zeros((self.h,), name=name + "_q_bias")
        self.bk = init.zeros((self.h,), name=name + "_k_bias")
        self.bv = init.zeros((self.h,), name=name + "_v_bias")
        self.bo = init.zeros((self.h,), name=name + "_proj_bias")
        self.fused_qkv = fused_qkv

    def _qkv(self, x):
        """(q, k, v) projections of x, each [B*S, H].  fused_qkv: ONE
        product with the three weights concatenated, sliced back into
        q/k/v (the same parameter names)."""
        if not self.fused_qkv:
            return (linear_op(x, self.wq, self.bq),
                    linear_op(x, self.wk, self.bk),
                    linear_op(x, self.wv, self.bv))
        if not hasattr(self, "_qkv_concat"):
            self._qkv_concat = (
                concatenate_op([self.wq, self.wk, self.wv], axis=1),
                concatenate_op([self.bq, self.bk, self.bv], axis=0))
        w, b = self._qkv_concat
        qkv = linear_op(x, w, b)
        return (slice_op(qkv, [0, 0], [-1, self.h]),
                slice_op(qkv, [0, self.h], [-1, self.h]),
                slice_op(qkv, [0, 2 * self.h], [-1, self.h]))

    def _causal_mask(self):
        node = getattr(self, "_causal_mask_node", None)
        if node is None:
            node = self._causal_mask_node = causal_mask_op(self.seq)
        return node

    def _split_heads(self, x):
        # (B*S, H) -> (B, nh, S, hd)
        x = array_reshape_op(x, [-1, self.seq, self.nh, self.hd])
        return transpose_op(x, [0, 2, 1, 3])

    def __call__(self, x, attention_mask=None, kv_lens=None):
        """x: (B*S, H) flattened hidden states; mask: additive (B,1,1,S).
        ``kv_lens``: [B] int node of valid key/value lengths (exclusive
        with ``attention_mask``)."""
        assert attention_mask is None or kv_lens is None, (
            "pass either an additive attention_mask or kv_lens, not both")
        if self.use_flash and attention_mask is None \
                and self.keep_prob == 1.0:
            def bshd(node):
                return array_reshape_op(
                    node, [-1, self.seq, self.nh, self.hd])
            qp, kp, vp = self._qkv(x)
            o = flash_attention_op(bshd(qp), bshd(kp), bshd(vp),
                                   causal=self.causal, kv_lens=kv_lens,
                                   block_q=self.block_q,
                                   block_k=self.block_k)
            o = array_reshape_op(o, [-1, self.h])
            return linear_op(o, self.wo, self.bo)
        if kv_lens is not None:
            from .reshape import lens_to_additive_mask
            attention_mask = lens_to_additive_mask(kv_lens, self.seq)
        qp, kp, vp = self._qkv(x)
        q = self._split_heads(qp)
        k = self._split_heads(kp)
        v = self._split_heads(vp)
        scores = batch_matmul_op(q, k, trans_B=True)
        scores = mul_byconst_op(scores, 1.0 / math.sqrt(self.hd))
        if self.causal:
            scores = scores + broadcastto_op(self._causal_mask(), scores)
        if attention_mask is not None:
            scores = scores + broadcastto_op(attention_mask, scores)
        probs = softmax_op(scores)
        if self.keep_prob < 1.0:
            probs = dropout_op(probs, self.keep_prob)
        ctxv = batch_matmul_op(probs, v)  # (B, nh, S, hd)
        ctxv = transpose_op(ctxv, [0, 2, 1, 3])
        ctxv = array_reshape_op(ctxv, [-1, self.h])
        if kv_lens is not None:
            from .reshape import zero_empty_rows
            ctxv = zero_empty_rows(ctxv, kv_lens, self.seq)
        return linear_op(ctxv, self.wo, self.bo)
