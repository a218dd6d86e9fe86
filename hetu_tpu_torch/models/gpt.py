"""Decoder-only causal LM (GPT-2 topology) on the graph surface, the port
of the JAX package's ``models/gpt.py``: pre-LN blocks, learned
positions, a head tied to the token table.

The builders make graph nodes (``hetu_tpu_torch.graph``) under the JAX
variable names (``gpt_wte_table``, ``gpt_wpe``, ``gpt_h{i}_ln1_scale``,
``gpt_h{i}_attn_q_weight``, ..., ``gpt_ln_f_scale``,
``gpt_head_bias``), so ``Executor.load_dict`` takes JAX weights and
``ServingEngine(executor.var_values, cfg)`` serves graph-trained ones
(the ``gpt_decode.py`` contract).  Attention is
``graph.layers.MultiHeadAttention`` (fused QKV; ``flash_attention_op``,
K2 forward and K3 backward on the card, when ``use_flash``), the
training loss the masked mean of ``tied_lm_head_xent_op`` over labels
that are not -1, with the logits node kept lazy.  The ``nn.Module``
model of ``train_gpt`` is ``models/gpt_module.py``.
"""

from __future__ import annotations

import numpy as np

from ..graph import (
    embedding_lookup_op, array_reshape_op, linear_op, gelu_op, dropout_op,
    slice_op, tied_lm_head_xent_op,
)
from ..graph import init, layers
from .bert import _masked_mean
from .gpt_config import GPTConfig


class GPTBlock:
    """Pre-LN: x + attn(ln1(x)); x + ffn(ln2(x))."""

    def __init__(self, config: GPTConfig, name="gpt_block"):
        c = config
        self.ln1 = layers.LayerNorm(c.hidden_size, name=name + "_ln1")
        self.ln2 = layers.LayerNorm(c.hidden_size, name=name + "_ln2")
        self.attn = layers.MultiHeadAttention(
            c.hidden_size, c.num_attention_heads, c.seq_len,
            c.batch_size, dropout_rate=c.dropout_rate,
            use_flash=c.use_flash, causal=True, name=name + "_attn")
        self.wi = layers.Linear(c.hidden_size, c.ffn_size,
                                name=name + "_ffn_wi")
        self.wo = layers.Linear(c.ffn_size, c.hidden_size,
                                name=name + "_ffn_wo")
        self.keep_prob = 1.0 - c.dropout_rate

    def __call__(self, h, kv_lens=None):
        a = self.attn(self.ln1(h), kv_lens=kv_lens)
        if self.keep_prob < 1.0:
            a = dropout_op(a, self.keep_prob)
        h = h + a
        f = self.wo(gelu_op(self.wi(self.ln2(h))))
        if self.keep_prob < 1.0:
            f = dropout_op(f, self.keep_prob)
        return h + f


class GPTModel:
    def __init__(self, config: GPTConfig, name="gpt"):
        c = config
        self.config = c
        self.wte = layers.Embedding(c.vocab_size, c.hidden_size,
                                    name=name + "_wte")
        self.wpe = init.random_normal(
            (c.max_position_embeddings, c.hidden_size), stddev=0.02,
            name=name + "_wpe")
        self.blocks = [GPTBlock(c, name=f"{name}_h{i}")
                       for i in range(c.num_hidden_layers)]
        self.ln_f = layers.LayerNorm(c.hidden_size, name=name + "_ln_f")
        self.keep_prob = 1.0 - c.dropout_rate

    def __call__(self, input_ids, kv_lens=None):
        """input_ids: (B, S) int -> hidden (B*S, H).  Positions add by
        broadcasting and reshapes use -1, so one graph serves any
        batch."""
        c = self.config
        h = embedding_lookup_op(self.wte.embedding_table, input_ids)
        pos = self.wpe if c.max_position_embeddings == c.seq_len else \
            _slice_rows(self.wpe, c.seq_len)
        h = h + pos                      # [B,S,H] + [S,H] broadcasts
        h = array_reshape_op(h, [-1, c.hidden_size])
        if self.keep_prob < 1.0:
            h = dropout_op(h, self.keep_prob)
        for blk in self.blocks:
            h = blk(h, kv_lens=kv_lens)
        return self.ln_f(h)


def _slice_rows(node, n):
    return slice_op(node, [0, 0], [n, -1])


class GPTForCausalLM:
    """Next-token LM.  ``labels`` are the pre-shifted targets (callers
    shift by one position host-side, padding the tail with -1, which is
    ignored).  The head is tied to wte; the training loss runs through
    the chunked tied head, the logits stay lazy.  With labels the call
    returns ``(loss, logits)``, without them ``logits`` [B*S, V]."""

    def __init__(self, config: GPTConfig, name="gpt"):
        c = config
        self.config = c
        self.transformer = GPTModel(config, name=name)
        self.head_bias = init.zeros((c.vocab_size,),
                                    name=name + "_head_bias")

    def __call__(self, input_ids, labels=None, kv_lens=None):
        h = self.transformer(input_ids, kv_lens=kv_lens)
        table = self.transformer.wte.embedding_table
        logits = linear_op(h, table, self.head_bias, trans_B=True)
        if labels is None:
            return logits
        labels_flat = array_reshape_op(labels, [-1])
        loss_vec = tied_lm_head_xent_op(h, table, self.head_bias,
                                        labels_flat, ignored_index=-1)
        # the mean over positions that are not ignored: -1 tails must not
        # dilute the loss or the gradient's scale
        return _masked_mean(loss_vec, labels_flat), logits


def greedy_generate(executor, name, ids_node, logits_node_index, prompt,
                    num_tokens, seq_len, pad_id=0):
    """Greedy decoding with the fixed-shape graph: the same [1, seq_len]
    forward runs once per generated token and position t-1's logits pick
    token t; causal masking makes the padded tail past t irrelevant to
    that row.  No KV cache (``generate_fast`` and the serving engine have
    one).  ``executor`` runs subgraph ``name``, whose
    ``logits_node_index``-th output is the [B*S, V] logits of
    ``ids_node``.  Returns the prompt and its continuation as a list."""
    prompt = list(prompt)
    if not 0 < len(prompt) < seq_len:
        raise ValueError(
            f"prompt length {len(prompt)} must be in (0, {seq_len})")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if len(prompt) + num_tokens > seq_len:
        raise ValueError(
            f"prompt ({len(prompt)}) + num_tokens ({num_tokens}) exceeds "
            f"the graph's fixed seq_len ({seq_len}); generate in a "
            f"longer-seq graph or request fewer tokens")
    ids = np.full((1, seq_len), pad_id, np.int32)
    ids[0, :len(prompt)] = prompt
    end = len(prompt) + num_tokens
    for t in range(len(prompt), end):
        out = executor.run(name, feed_dict={ids_node: ids})
        logits = out[logits_node_index].reshape(seq_len, -1)
        ids[0, t] = int(logits[t - 1].argmax())
    return ids[0, :end].tolist()
