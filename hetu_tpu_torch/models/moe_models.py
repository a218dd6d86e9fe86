"""MoE model functions on the graph surface: the port of the JAX
package's ``models/moe_models.py``.  ``moe_mlp`` is an MoE layer (any
gate of the family) used directly as a token classifier;
``moe_transformer_block`` a transformer block whose FFN is the MoE
layer.
"""

from __future__ import annotations

from ..graph import layers as htl
from ..graph import (
    softmaxcrossentropy_op, reduce_mean_op, array_reshape_op,
    softmaxcrossentropy_sparse_op,
)


def _make_gate(gate_type, embed_dim, num_tokens, num_experts, top_k,
               device_id=0):
    if gate_type == "top":
        return htl.TopKGate(embed_dim, num_tokens, num_experts, k=top_k)
    if gate_type == "hash":
        return htl.HashGate(embed_dim, num_tokens, num_experts)
    if gate_type == "ktop1":
        return htl.KTop1Gate(embed_dim, num_tokens, num_experts)
    if gate_type == "sam":
        return htl.SAMGate(embed_dim, num_tokens, num_experts)
    if gate_type == "balance":
        return htl.BalanceGate(embed_dim, num_tokens, num_experts)
    raise ValueError(f"unknown gate type {gate_type!r}")


def moe_mlp(x, y_, batch_size, num_tokens, model_dim, hidden_size,
            num_local_experts=2, all2all_size=1, gate_type="top", top_k=2,
            device_id=0, hierarchical=False, sparse_labels=False,
            expert_parallel=False):
    """MoE classifier (reference test_moe_base/top/hash/ktop1/sam.py).

    x: (B, T, D) tokens; y_: (B*T, C) one-hot, or (B*T,) int class ids
    with ``sparse_labels=True`` (C=model_dim one-hot targets are ~1000x
    the host-to-device bytes of int ids).  ``expert_parallel=True`` uses
    the StackedExperts formulation (the one JAX shards over an 'ep' mesh;
    the global expert count is num_local_experts * all2all_size either
    way).
    Returns (loss, y).
    """
    total_tokens = batch_size * num_tokens
    num_experts = num_local_experts * all2all_size
    gate = _make_gate(gate_type, model_dim, total_tokens, num_experts,
                      top_k, device_id)
    layer_name = "BalanceAssignmentLayer" if gate_type == "balance" \
        else "MoELayer"
    if expert_parallel:
        if gate_type == "balance":
            raise ValueError("balance-assignment mode uses the "
                             "per-local-expert formulation; run it without "
                             "expert_parallel")
        experts = htl.StackedExperts(num_experts, model_dim, hidden_size,
                                     activation="relu", name="expert")
        model = htl.MoELayer(gate=gate, experts=experts,
                             num_tokens=total_tokens, embed_dim=model_dim,
                             name=layer_name, top=top_k,
                             hierarchical=hierarchical)
    else:
        experts = [
            htl.Expert(embed_dim=model_dim, ffn_dim=hidden_size,
                       dropout_rate=0.1, activation="relu",
                       name=f"expert_{device_id * num_local_experts + i}")
            for i in range(num_local_experts)
        ]
        model = htl.MoELayer(gate=gate, experts=experts,
                             num_tokens=total_tokens,
                             embed_dim=model_dim,
                             all2all_size=all2all_size,
                             name=layer_name, top=top_k,
                             hierarchical=hierarchical)
    out = model(x)
    ce = softmaxcrossentropy_sparse_op if sparse_labels \
        else softmaxcrossentropy_op
    if gate_type == "balance":
        y = out
        loss = reduce_mean_op(ce(y, y_), [0])
    else:
        y, l_aux = out
        loss = reduce_mean_op(ce(y, y_), [0])
        if l_aux is not None:  # HashGate has no balance loss
            loss = loss + l_aux
    return loss, y


def moe_transformer_block(hidden, batch_size, seq_len, model_dim, num_heads,
                          hidden_size, num_local_experts=2, all2all_size=1,
                          gate_type="top", top_k=2, name="moe_block"):
    """Transformer block with an MoE FFN: attn -> LN -> MoE -> LN.

    hidden: (B*S, D) flattened hidden states; returns (B*S, D).
    """
    attn = htl.MultiHeadAttention(model_dim, num_heads, seq_len, batch_size,
                                  name=name + "_attn")
    ln1 = htl.LayerNorm(model_dim, name=name + "_ln1")
    ln2 = htl.LayerNorm(model_dim, name=name + "_ln2")
    h = ln1(hidden + attn(hidden))

    total_tokens = batch_size * seq_len
    experts = [htl.Expert(embed_dim=model_dim, ffn_dim=hidden_size,
                          activation="gelu", name=f"{name}_expert_{i}")
               for i in range(num_local_experts)]
    gate = _make_gate(gate_type, model_dim, total_tokens,
                      num_local_experts * all2all_size, top_k)
    moe = htl.MoELayer(gate=gate, experts=experts, num_tokens=total_tokens,
                       embed_dim=model_dim, all2all_size=all2all_size,
                       top=top_k, name="MoELayer")
    moe_out, l_aux = moe(h)
    out = ln2(h + array_reshape_op(moe_out, [total_tokens, model_dim]))
    return out
