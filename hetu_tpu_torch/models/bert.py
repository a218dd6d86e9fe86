"""BERT on the graph surface: the port of the JAX package's
``models/bert.py``.  Embeddings -> N encoder blocks -> pooler, with the
task heads (pretraining = MLM + NSP, masked LM, sequence
classification, question answering).  Hidden states flow flattened as
(B*S, H) 2-D matmuls; batch and sequence are constructor arguments (the
graph's shapes are static).  Variables keep the JAX names, so
``Executor.load_dict`` carries JAX weights across.

With ``use_flash_attention`` and ``attention_probs_dropout_prob`` 0,
a model fed ``kv_lens`` runs attention on ``flash_attention_op`` (K2
forward and K3 backward on the card); an additive ``attention_mask``
runs the unfused chain, as in JAX.
"""

from __future__ import annotations

from ..graph import (
    embedding_lookup_op, array_reshape_op, broadcast_shape_op, dropout_op,
    matmul_op, broadcastto_op, relu_op, gelu_op, tanh_op, slice_op,
    softmaxcrossentropy_sparse_op, tied_lm_head_xent_op,
    reduce_mean_op, reduce_sum_op, squeeze_op,
    addbyconst_op, mul_byconst_op, opposite_op, div_op, bool_op,
    full_like_op,
)
from ..graph import init, layers


class BertConfig:
    """Hyper-parameters (reference hetu_bert.py BertConfig)."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, batch_size=8, seq_len=128,
                 use_flash_attention=False, layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.use_flash_attention = use_flash_attention
        # 1e-12, matching the reference BERT (hetu_bert.py:74,886) and
        # HF — the framework-wide LayerNorm default of 1e-5 is a
        # visible parity delta at small hidden sizes
        self.layer_norm_eps = layer_norm_eps

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_hidden_layers", 24)
        kw.setdefault("num_attention_heads", 16)
        kw.setdefault("intermediate_size", 4096)
        return cls(**kw)


class BertEmbeddings:
    """word + position + token_type embeddings -> LN -> dropout."""

    def __init__(self, config: BertConfig, name="bert_embeddings"):
        c = config
        std = c.initializer_range
        self.config = c
        self.word_embeddings = init.random_normal(
            (c.vocab_size, c.hidden_size), stddev=std,
            name=name + "_word_embeddings")
        self.position_embeddings = init.random_normal(
            (c.max_position_embeddings, c.hidden_size), stddev=std,
            name=name + "_position_embeddings")
        self.token_type_embeddings = init.random_normal(
            (c.type_vocab_size, c.hidden_size), stddev=std,
            name=name + "_token_type_embeddings")
        self.layer_norm = layers.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                           name=name + "_ln")

    def __call__(self, input_ids, token_type_ids=None):
        c = self.config
        b, s, h = c.batch_size, c.seq_len, c.hidden_size
        emb = embedding_lookup_op(self.word_embeddings, input_ids)
        pos = slice_op(self.position_embeddings, (0, 0), (s, h))
        emb = emb + broadcast_shape_op(pos, (b, s, h), add_axes=[0])
        if token_type_ids is not None:
            emb = emb + embedding_lookup_op(self.token_type_embeddings,
                                            token_type_ids)
        emb = array_reshape_op(emb, [b * s, h])
        emb = self.layer_norm(emb)
        if c.hidden_dropout_prob > 0:
            emb = dropout_op(emb, 1.0 - c.hidden_dropout_prob)
        return emb


class BertAttentionBlock:
    """Self-attention half of an encoder block: attention -> dropout ->
    add&norm.  Shared by the dense BertLayer and the MoE block
    (bert_moe.BertMoELayer), so attention wiring changes propagate to
    both."""

    def __init__(self, config: BertConfig, name="bert_layer"):
        c = config
        self.config = c
        self.attention = layers.MultiHeadAttention(
            c.hidden_size, c.num_attention_heads, c.seq_len, c.batch_size,
            dropout_rate=c.attention_probs_dropout_prob,
            use_flash=c.use_flash_attention, name=name + "_attn")
        self.attn_ln = layers.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                        name=name + "_attn_ln")

    def __call__(self, hidden, attention_mask=None, kv_lens=None):
        c = self.config
        attn = self.attention(hidden, attention_mask=attention_mask,
                              kv_lens=kv_lens)
        if c.hidden_dropout_prob > 0:
            attn = dropout_op(attn, 1.0 - c.hidden_dropout_prob)
        return self.attn_ln(hidden + attn)


class BertLayer:
    """One encoder block: self-attention -> add&norm -> FFN -> add&norm."""

    def __init__(self, config: BertConfig, name="bert_layer"):
        c = config
        act = gelu_op if c.hidden_act == "gelu" else relu_op
        self.config = c
        self.act = act
        self.attn_block = BertAttentionBlock(config, name=name)
        self.intermediate = layers.Linear(c.hidden_size, c.intermediate_size,
                                          name=name + "_intermediate")
        self.output = layers.Linear(c.intermediate_size, c.hidden_size,
                                    name=name + "_output")
        self.out_ln = layers.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                       name=name + "_out_ln")

    def __call__(self, hidden, attention_mask=None, kv_lens=None):
        c = self.config
        hidden = self.attn_block(hidden, attention_mask=attention_mask,
                                 kv_lens=kv_lens)
        ffn = self.output(self.act(self.intermediate(hidden)))
        if c.hidden_dropout_prob > 0:
            ffn = dropout_op(ffn, 1.0 - c.hidden_dropout_prob)
        return self.out_ln(hidden + ffn)


class BertPooler:
    """tanh projection of the [CLS] token."""

    def __init__(self, config: BertConfig, name="bert_pooler"):
        self.config = config
        self.dense = layers.Linear(config.hidden_size, config.hidden_size,
                                   name=name + "_dense")

    def __call__(self, sequence_output):
        c = self.config
        x = array_reshape_op(sequence_output,
                             [c.batch_size, c.seq_len, c.hidden_size])
        cls = slice_op(x, (0, 0, 0), (c.batch_size, 1, c.hidden_size))
        cls = array_reshape_op(cls, [c.batch_size, c.hidden_size])
        return tanh_op(self.dense(cls))


def additive_attention_mask(config, attention_mask):
    """(B, S) {0,1} mask -> additive (B,1,1,S): (1-m) * -10000."""
    c = config
    m = array_reshape_op(attention_mask, [c.batch_size, 1, 1, c.seq_len])
    return mul_byconst_op(addbyconst_op(opposite_op(m), 1.0), -10000.0)


class BertModel:
    """Backbone; returns (sequence_output (B*S,H), pooled_output (B,H))."""

    def __init__(self, config: BertConfig, name="bert"):
        self.config = config
        self.embeddings = BertEmbeddings(config, name=name + "_embeddings")
        self.encoder_layers = [BertLayer(config, name=f"{name}_layer{i}")
                               for i in range(config.num_hidden_layers)]
        self.pooler = BertPooler(config, name=name + "_pooler")

    def attention_mask_from_input(self, attention_mask):
        return additive_attention_mask(self.config, attention_mask)

    def __call__(self, input_ids, token_type_ids=None, attention_mask=None,
                 kv_lens=None):
        """``kv_lens`` [B] int node: valid-prefix lengths — keeps the
        flash kernel active under padding (an additive attention_mask
        forces the unfused path).  Mutually exclusive with
        attention_mask."""
        if attention_mask is not None and kv_lens is not None:
            raise ValueError("pass either attention_mask or kv_lens, not "
                             "both")
        hidden = self.embeddings(input_ids, token_type_ids)
        add_mask = None
        if attention_mask is not None:
            add_mask = self.attention_mask_from_input(attention_mask)
        for layer in self.encoder_layers:
            hidden = layer(hidden, attention_mask=add_mask,
                           kv_lens=kv_lens)
        return hidden, self.pooler(hidden)


def _masked_mean(per_token_loss, labels_flat, ignored_index=-1):
    """Mean over non-ignored positions only (reference averages MLM loss
    over masked tokens, hetu_bert.py), so the MLM/NSP weighting does not
    depend on the mask rate.

    Microbatching caveat (pipeline / gradient accumulation): the
    denominator is the VALID count of whatever slice this graph sees.
    Under ``pipeline=`` the loss becomes the mean of per-microbatch
    masked means, which equals the global masked mean only when ignored
    positions are evenly distributed across microbatches — the same
    per-chunk-weighting bias standard gradient-accumulation loops have.
    Keep -1 densities roughly uniform per microbatch (e.g. shuffled MLM
    masking does this naturally) when exact equivalence matters."""
    valid = bool_op(labels_flat, full_like_op(labels_flat, ignored_index),
                    cond=2)  # labels > ignored_index
    count = addbyconst_op(reduce_sum_op(valid, [0]), 1e-12)
    return div_op(reduce_sum_op(per_token_loss, [0]), count)


class BertPreTrainingHeads:
    """Tied MLM decoder + NSP head, shared by the dense and MoE
    pretraining models (the reference's cls heads, hetu_bert.py)."""

    def __init__(self, config: BertConfig, word_embeddings, name="bert"):
        c = config
        self.config = c
        self.word_embeddings = word_embeddings
        self.transform = layers.Linear(c.hidden_size, c.hidden_size,
                                       name=name + "_mlm_transform")
        self.transform_ln = layers.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps,
                                             name=name + "_mlm_ln")
        self.decoder_bias = init.zeros((c.vocab_size,),
                                       name=name + "_mlm_bias")
        self.nsp = layers.Linear(c.hidden_size, 2, name=name + "_nsp")

    def mlm(self, seq_out):
        """(h, logits) for the tied MLM decoder.  The logits node is
        LAZY — training losses go through the fused chunked head on
        ``h`` instead, so the [B*S, vocab] logits chain is only ever
        computed if a caller evaluates it."""
        h = self.transform_ln(gelu_op(self.transform(seq_out)))
        logits = matmul_op(h, self.word_embeddings, trans_B=True)
        logits = logits + broadcastto_op(self.decoder_bias, logits)
        return h, logits

    def pretraining_loss(self, h, nsp_logits, masked_lm_labels,
                         next_sentence_label):
        """masked-mean MLM loss (fused chunked tied head) + NSP loss."""
        c = self.config
        labels_flat = array_reshape_op(masked_lm_labels,
                                       [c.batch_size * c.seq_len])
        mlm_loss = tied_lm_head_xent_op(
            h, self.word_embeddings, self.decoder_bias,
            labels_flat, ignored_index=-1)
        nsp_loss = softmaxcrossentropy_sparse_op(nsp_logits,
                                                 next_sentence_label)
        return (_masked_mean(mlm_loss, labels_flat)
                + reduce_mean_op(nsp_loss, [0]))


class BertForPreTraining:
    """MLM + NSP heads (reference hetu_bert.py BertForPreTraining)."""

    def __init__(self, config: BertConfig, name="bert"):
        self.config = config
        self.bert = BertModel(config, name=name)
        self.heads = BertPreTrainingHeads(
            config, self.bert.embeddings.word_embeddings, name=name)

    def _mlm_head(self, seq_out):
        return self.heads.mlm(seq_out)

    # the head params, reachable through the model object
    @property
    def decoder_bias(self):
        return self.heads.decoder_bias

    @property
    def transform(self):
        return self.heads.transform

    @property
    def nsp(self):
        return self.heads.nsp

    def __call__(self, input_ids, token_type_ids=None, attention_mask=None,
                 masked_lm_labels=None, next_sentence_label=None,
                 kv_lens=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask, kv_lens=kv_lens)
        h, logits = self.heads.mlm(seq_out)
        nsp_logits = self.heads.nsp(pooled)
        if masked_lm_labels is None:
            return logits, nsp_logits
        loss = self.heads.pretraining_loss(h, nsp_logits, masked_lm_labels,
                                           next_sentence_label)
        return loss, logits, nsp_logits


class BertForMaskedLM:
    def __init__(self, config: BertConfig, name="bert"):
        self.pretraining = BertForPreTraining(config, name=name)
        self.config = config

    def __call__(self, input_ids, token_type_ids=None, attention_mask=None,
                 masked_lm_labels=None, kv_lens=None):
        c = self.config
        p = self.pretraining
        seq_out, _pooled = p.bert(input_ids, token_type_ids,
                                  attention_mask, kv_lens=kv_lens)
        h, logits = p._mlm_head(seq_out)
        if masked_lm_labels is None:
            return logits
        labels_flat = array_reshape_op(masked_lm_labels,
                                       [c.batch_size * c.seq_len])
        # fused chunked head for the loss; the logits node stays lazy
        # unless a caller evaluates it
        loss = tied_lm_head_xent_op(
            h, p.bert.embeddings.word_embeddings, p.decoder_bias,
            labels_flat, ignored_index=-1)
        return _masked_mean(loss, labels_flat), logits


class BertForSequenceClassification:
    """GLUE-style classifier head (reference hetu_bert.py)."""

    def __init__(self, config: BertConfig, num_labels=2, name="bert"):
        c = config
        self.config = c
        self.num_labels = num_labels
        self.bert = BertModel(config, name=name)
        self.classifier = layers.Linear(c.hidden_size, num_labels,
                                        name=name + "_classifier")

    def __call__(self, input_ids, token_type_ids=None, attention_mask=None,
                 labels=None, kv_lens=None):
        c = self.config
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              kv_lens=kv_lens)
        if c.hidden_dropout_prob > 0:
            pooled = dropout_op(pooled, 1.0 - c.hidden_dropout_prob)
        logits = self.classifier(pooled)
        if labels is None:
            return logits
        loss = softmaxcrossentropy_sparse_op(logits, labels)
        return reduce_mean_op(loss, [0]), logits


class BertForQuestionAnswering:
    """SQuAD span-prediction head: per-token start/end logits.

    The window features this head consumes come from the JAX package's
    ``squad`` module (ROADMAP A11 for the port).
    Loss is the mean of start and end sparse cross-entropies over the
    S token positions, positions clamped to [CLS]=0 by the feature
    feature code when the answer falls outside a window.
    """

    def __init__(self, config: BertConfig, name="bert"):
        c = config
        self.config = c
        self.bert = BertModel(config, name=name)
        self.qa_outputs = layers.Linear(c.hidden_size, 2,
                                        name=name + "_qa_outputs")

    def __call__(self, input_ids, token_type_ids=None,
                 attention_mask=None, start_positions=None,
                 end_positions=None, kv_lens=None):
        c = self.config
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           kv_lens=kv_lens)
        logits = self.qa_outputs(seq)                      # (B*S, 2)
        logits = array_reshape_op(logits,
                                  [c.batch_size, c.seq_len, 2])
        start_logits = squeeze_op(
            slice_op(logits, (0, 0, 0), (c.batch_size, c.seq_len, 1)), 2)
        end_logits = squeeze_op(
            slice_op(logits, (0, 0, 1), (c.batch_size, c.seq_len, 1)), 2)
        if start_positions is None:
            return start_logits, end_logits
        start_loss = reduce_mean_op(
            softmaxcrossentropy_sparse_op(start_logits, start_positions),
            [0])
        end_loss = reduce_mean_op(
            softmaxcrossentropy_sparse_op(end_logits, end_positions),
            [0])
        loss = mul_byconst_op(start_loss + end_loss, 0.5)
        return loss, start_logits, end_logits
