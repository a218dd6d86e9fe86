"""Decoder-only causal LM (GPT-2 topology) as an ``nn.Module``, the
model of the port's ``nn.Module`` trainer (``executor.py``,
``train_gpt.py``): the JAX package's ``models/gpt.py`` (``GPTBlock`` :78,
``GPTModel`` :106, ``GPTForCausalLM`` :145) in eager torch, under the
names ``GPTBlockModule``, ``GPTModelModule`` and ``GPTForCausalLMModule``
(``models/gpt.py`` holds the graph builders under JAX's names).  Pre-LN
blocks, learned positions, a head tied to the token table with its own
bias, the loss the masked mean of the chunked tied head's cross-entropy
over labels that are not -1.

Parameters carry the JAX package's variable names (``gpt_wte_table``,
``gpt_wpe``, ``gpt_h{i}_ln1_scale``, ``gpt_h{i}_attn_q_weight``, ...,
``gpt_ln_f_scale``, ``gpt_head_bias``), the contract the serving cores
(``gpt_decode.py``) read, so trained weights serve as they are:
``var_values()`` gives them as numpy arrays and ``load_var_values``
takes them back (from the JAX executor's ``var_values`` too).

Weights are drawn from a ``torch.Generator`` seeded by ``seed``, with
the JAX package's initializers (their distributions, not its bits).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import functional as Fn
from .. import initializers as init
from .. import layers
from .gpt_config import GPTConfig


class GPTBlockModule(nn.Module):
    """Pre-LN: x + attn(ln1(x)); x + ffn(ln2(x)), dropout after each."""

    def __init__(self, config: GPTConfig, name="gpt_block", generator=None):
        super().__init__()
        c = config
        self.ln1 = layers.LayerNorm(c.hidden_size, name=name + "_ln1")
        self.ln2 = layers.LayerNorm(c.hidden_size, name=name + "_ln2")
        self.attn = layers.MultiHeadAttention(
            c.hidden_size, c.num_attention_heads, c.seq_len,
            dropout_rate=c.dropout_rate, use_flash=c.use_flash, causal=True,
            name=name + "_attn", generator=generator)
        self.wi = layers.Linear(c.hidden_size, c.ffn_size,
                                name=name + "_ffn_wi", generator=generator)
        self.wo = layers.Linear(c.ffn_size, c.hidden_size,
                                name=name + "_ffn_wo", generator=generator)
        self.keep_prob = 1.0 - c.dropout_rate

    def forward(self, h, kv_lens=None, generator=None):
        a = self.attn(self.ln1(h), kv_lens=kv_lens, generator=generator)
        h = h + Fn.dropout(a, self.keep_prob, generator, self.training)
        f = self.wo(Fn.gelu(self.wi(self.ln2(h))))
        return h + Fn.dropout(f, self.keep_prob, generator, self.training)


class GPTModelModule(layers.BaseLayer):
    def __init__(self, config: GPTConfig, name="gpt", generator=None):
        super().__init__(name)
        c = config
        self.config = c
        self.wte = layers.Embedding(c.vocab_size, c.hidden_size,
                                    name=name + "_wte", generator=generator)
        self.add_var("wpe", name + "_wpe",
                     init.NormalInit(0.0, 0.02, (c.max_position_embeddings,
                                                 c.hidden_size)), generator)
        self.blocks = nn.ModuleList(
            GPTBlockModule(c, name=f"{name}_h{i}", generator=generator)
            for i in range(c.num_hidden_layers))
        self.ln_f = layers.LayerNorm(c.hidden_size, name=name + "_ln_f")
        self.keep_prob = 1.0 - c.dropout_rate

    def forward(self, input_ids, kv_lens=None, generator=None):
        """input_ids [B, seq_len] -> hidden [B * seq_len, H]."""
        c = self.config
        h = self.wte(input_ids) + self.wpe[:c.seq_len]
        h = h.reshape(-1, c.hidden_size)
        h = Fn.dropout(h, self.keep_prob, generator, self.training)
        for blk in self.blocks:
            h = blk(h, kv_lens=kv_lens, generator=generator)
        return self.ln_f(h)


class GPTForCausalLMModule(layers.BaseLayer):
    """Next-token LM.  ``labels`` are the pre-shifted targets [B, S], -1
    ignored.  With labels the forward returns the loss (f32, the masked
    mean of :func:`functional.tied_lm_head_xent`), whose [N, V] logits
    are never held whole; without them it returns the logits
    [B * S, V]."""

    def __init__(self, config: GPTConfig, name="gpt", seed=0):
        super().__init__(name)
        self.config = config
        g = torch.Generator().manual_seed(int(seed))
        self.transformer = GPTModelModule(config, name=name, generator=g)
        self.add_var("head_bias", name + "_head_bias",
                     init.ZerosInit((config.vocab_size,)))

    def forward(self, input_ids, labels=None, kv_lens=None, generator=None):
        h = self.transformer(input_ids, kv_lens=kv_lens, generator=generator)
        table = self.transformer.wte.embedding_table
        if labels is None:
            return Fn.linear(h, table, self.head_bias, trans_b=True)
        labels_flat = labels.reshape(-1)
        loss_vec = Fn.tied_lm_head_xent(h, table, self.head_bias,
                                        labels_flat, ignored_index=-1)
        return Fn.masked_mean(loss_vec, labels_flat)

    def var_values(self):
        """{JAX variable name: numpy array} of every parameter."""
        return {k: p.detach().float().cpu().numpy()
                for k, p in self.named_vars().items()}

    @torch.no_grad()
    def load_var_values(self, values):
        """Copy {JAX variable name: array or tensor} into the parameters;
        every name must be present, with its shape."""
        mine = self.named_vars()
        missing = sorted(set(mine) - set(values))
        if missing:
            raise KeyError(f"var_values lacks {missing}")
        for k, p in mine.items():
            v = values[k]
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, np.float32))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{k}: shape {tuple(t.shape)}, the model "
                                 f"has {tuple(p.shape)}")
            p.copy_(t.to(p.device, p.dtype))
        return self


def greedy_generate_module(executor, prompt, num_tokens, seq_len,
                           pad_id=0):
    """Greedy decoding through the fixed-shape forward (the JAX package's
    ``models/gpt.py:172`` over this port's ``Executor.evaluate``): the
    same [1, seq_len] forward runs once per generated token and position
    t-1's logits pick token t; causal masking makes the padded tail past
    t irrelevant to that row.  No KV cache (``generate_fast`` has one).
    Returns the prompt and its continuation as a list."""
    prompt = list(prompt)
    if not 0 < len(prompt) < seq_len:
        raise ValueError(
            f"prompt length {len(prompt)} must be in (0, {seq_len})")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if len(prompt) + num_tokens > seq_len:
        raise ValueError(
            f"prompt ({len(prompt)}) + num_tokens ({num_tokens}) exceeds "
            f"the model's fixed seq_len ({seq_len}); request fewer tokens")
    ids = np.full((1, seq_len), pad_id, np.int32)
    ids[0, :len(prompt)] = prompt
    end = len(prompt) + num_tokens
    for t in range(len(prompt), end):
        logits = executor.evaluate({"input_ids": ids})[0]
        ids[0, t] = int(logits.reshape(seq_len, -1)[t - 1].argmax())
    return ids[0, :end].tolist()
