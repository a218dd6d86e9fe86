"""BERT with Mixture-of-Experts FFN blocks on the graph surface: the port
of the JAX package's ``models/bert_moe.py``.  Every ``moe_every``-th
encoder block's FFN is an MoE layer (a ``TopKGate`` over
``StackedExperts`` [E, D, F]), and the blocks' auxiliary balance losses
are summed into the training loss with ``aux_loss_weight``.  The heads
are the dense model's ``BertPreTrainingHeads``.
"""

from __future__ import annotations

from ..graph import array_reshape_op, dropout_op, layers, mul_byconst_op
from .bert import (
    BertAttentionBlock, BertConfig, BertEmbeddings, BertLayer, BertPooler,
    BertPreTrainingHeads, additive_attention_mask,
)


class BertMoEConfig(BertConfig):
    """BertConfig + MoE knobs.

    num_experts      global expert count
    top_k            experts per token (TopKGate)
    capacity_factor  static per-expert capacity multiplier
    moe_every        every Nth encoder block gets the MoE FFN, counting
                     from block moe_every-1 (1 = all blocks, the
                     reference placement; 2 = GShard alternation)
    aux_loss_weight  weight of the summed balance losses in the total
    hierarchical_a2a the two-stage all-to-all over ("ici", "dcn") in
                     the per-rank view (the identity in the executor)
    """

    def __init__(self, num_experts=8, top_k=1, capacity_factor=1.0,
                 moe_every=2, aux_loss_weight=0.01,
                 hierarchical_a2a=False, **kw):
        super().__init__(**kw)
        if num_experts < 2:
            raise ValueError(f"num_experts must be >= 2, got {num_experts}")
        if not 1 <= moe_every <= self.num_hidden_layers:
            raise ValueError(
                f"moe_every={moe_every} outside [1, num_hidden_layers="
                f"{self.num_hidden_layers}]")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.moe_every = moe_every
        self.aux_loss_weight = aux_loss_weight
        self.hierarchical_a2a = hierarchical_a2a

    def is_moe_block(self, i):
        return i % self.moe_every == self.moe_every - 1


class BertMoELayer:
    """Encoder block with the FFN replaced by an MoE layer: the shared
    BertAttentionBlock, then MoE(gate, stacked experts) -> add&norm.
    Returns (hidden, l_aux)."""

    def __init__(self, config: BertMoEConfig, name="bert_moe_layer"):
        c = config
        self.config = c
        self.attn_block = BertAttentionBlock(config, name=name)
        tokens = c.batch_size * c.seq_len
        self.gate = layers.TopKGate(
            c.hidden_size, tokens, c.num_experts, k=c.top_k,
            capacity_factor=c.capacity_factor, name=name + "_gate")
        experts = layers.StackedExperts(
            c.num_experts, c.hidden_size, c.intermediate_size,
            # same activation normalization as the dense BertLayer:
            # gelu when asked for, relu otherwise
            activation="gelu" if c.hidden_act == "gelu" else "relu",
            name=name + "_moe")
        self.moe = layers.MoELayer(
            gate=self.gate, experts=experts, num_tokens=tokens,
            embed_dim=c.hidden_size, hierarchical=c.hierarchical_a2a,
            top=c.top_k, name="MoELayer")
        self.out_ln = layers.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                       name=name + "_out_ln")

    def __call__(self, hidden, attention_mask=None, kv_lens=None):
        c = self.config
        hidden = self.attn_block(hidden, attention_mask=attention_mask,
                                 kv_lens=kv_lens)
        moe_out, l_aux = self.moe(hidden)
        moe_out = array_reshape_op(
            moe_out, [c.batch_size * c.seq_len, c.hidden_size])
        if c.hidden_dropout_prob > 0:
            moe_out = dropout_op(moe_out, 1.0 - c.hidden_dropout_prob)
        return self.out_ln(hidden + moe_out), l_aux


class BertMoEModel:
    """Backbone; returns (sequence_output, pooled_output, l_aux_total).
    l_aux_total is the sum of the per-MoE-block balance losses
    (reference hetu_bert_moe.py:149-152 moe_loss accumulation)."""

    def __init__(self, config: BertMoEConfig, name="bert"):
        self.config = config
        self.embeddings = BertEmbeddings(config, name=name + "_embeddings")
        self.encoder_layers = []
        for i in range(config.num_hidden_layers):
            cls = BertMoELayer if config.is_moe_block(i) else BertLayer
            self.encoder_layers.append(cls(config, name=f"{name}_layer{i}"))
        self.pooler = BertPooler(config, name=name + "_pooler")

    def __call__(self, input_ids, token_type_ids=None, attention_mask=None,
                 kv_lens=None):
        if attention_mask is not None and kv_lens is not None:
            raise ValueError("pass either attention_mask or kv_lens, not "
                             "both")
        hidden = self.embeddings(input_ids, token_type_ids)
        add_mask = None
        if attention_mask is not None:
            add_mask = additive_attention_mask(self.config, attention_mask)
        l_aux_total = None
        for layer in self.encoder_layers:
            if isinstance(layer, BertMoELayer):
                hidden, l_aux = layer(hidden, attention_mask=add_mask,
                                      kv_lens=kv_lens)
                l_aux_total = l_aux if l_aux_total is None \
                    else l_aux_total + l_aux
            else:
                hidden = layer(hidden, attention_mask=add_mask,
                               kv_lens=kv_lens)
        return hidden, self.pooler(hidden), l_aux_total


class BertMoEForPreTraining:
    """MLM + NSP + weighted balance loss (reference
    train_hetu_bert_dp_moe.py adds moe_loss into the training loss).
    Head params and loss assembly are the SAME BertPreTrainingHeads the
    dense model uses — only the backbone differs."""

    def __init__(self, config: BertMoEConfig, name="bert"):
        self.config = config
        self.bert = BertMoEModel(config, name=name)
        self.heads = BertPreTrainingHeads(
            config, self.bert.embeddings.word_embeddings, name=name)

    def __call__(self, input_ids, token_type_ids=None, attention_mask=None,
                 masked_lm_labels=None, next_sentence_label=None,
                 kv_lens=None):
        c = self.config
        seq_out, pooled, l_aux = self.bert(input_ids, token_type_ids,
                                           attention_mask, kv_lens=kv_lens)
        h, logits = self.heads.mlm(seq_out)
        nsp_logits = self.heads.nsp(pooled)
        if masked_lm_labels is None:
            return logits, nsp_logits
        loss = self.heads.pretraining_loss(h, nsp_logits, masked_lm_labels,
                                           next_sentence_label)
        if l_aux is not None and c.aux_loss_weight:
            loss = loss + mul_byconst_op(l_aux, c.aux_loss_weight)
        return loss, logits, nsp_logits
