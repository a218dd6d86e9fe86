"""MoE layers: the gate family, ``Expert``, ``StackedExperts`` and
``MoELayer``: the port of the JAX package's ``layers/moe.py``.  Graph
structure as there: gate -> ``layout_transform_op`` capacity dispatch ->
all-to-all -> the experts' FFN -> all-to-all back ->
``reverse_layout_transform_op`` weighted combine (the all-to-all ops are
the identity without a mesh).  Variables keep the JAX names."""

from __future__ import annotations

import math

import numpy as np

from .. import init
from ..ops_math import gelu_op, mul_byconst_op, mul_op, relu_op, softmax_op
from ..ops_matmul import batch_matmul_op, matmul_op
from ..ops_misc import Variable
from ..ops_moe import (alltoall_op, balance_assignment_op, group_topk_idx_op,
                       halltoall_op, layout_transform_op,
                       reverse_layout_transform_op, sam_group_sum_op,
                       sam_max_op)
from ..ops_shape import (array_reshape_op, broadcastto_op, concatenate_op,
                         cumsum_with_bias_op, indexing_op, one_hot_op,
                         reduce_mean_op, reduce_sum_op, reducesumaxiszero_op,
                         scatter1d_op, split_op, topk_idx_op)
from .base import BaseLayer

_ACTIVATIONS = {"relu": relu_op, "gelu": gelu_op}


def balance_loss(gates, mask, num_experts):
    """Aux load-balance loss: E * sum_e mean(gates_e) * mean(mask_e)."""
    me = reduce_mean_op(gates, axes=0)
    ce = reduce_mean_op(mask, axes=0)
    return mul_byconst_op(reducesumaxiszero_op(me * ce), float(num_experts))


def topkgating(logits, k, capacity_factor, num_tokens, num_experts, embed_dim):
    """Top-k gating with static capacity.  Returns (l_aux, indices_s,
    location_s, gates_s, capacity): rank i's locations follow every
    token's ranks 0..i-1 at the same expert (rank-major slots)."""
    gates = softmax_op(logits)
    capacity = k * math.ceil((num_tokens / num_experts) * capacity_factor)
    topk_indices = topk_idx_op(gates, topk=k)
    indices_s = [split_op(topk_indices, axes=[1], indices=[i], splits=[k])
                 for i in range(k)]
    mask_topk = [array_reshape_op(
        one_hot_op(indices_s[i], num_classes=num_experts), [-1, num_experts])
        for i in range(k)]

    l_aux = balance_loss(gates, mask_topk[0], num_experts)

    locations1 = cumsum_with_bias_op(mask_topk[0], bias=-1, dim=0)
    location_s = [reduce_sum_op(locations1 * mask_topk[0], axes=1)]

    acc_base = None
    for i in range(1, k):
        inc = reduce_sum_op(mask_topk[i - 1], axes=0, keepdims=True)
        acc_base = inc if acc_base is None else acc_base + inc
        locations2 = cumsum_with_bias_op(mask_topk[i], bias=-1, dim=0)
        locations2 = locations2 + broadcastto_op(acc_base, locations2)
        location_s.append(reduce_sum_op(locations2 * mask_topk[i], axes=1))
        l_aux = l_aux + balance_loss(gates, mask_topk[i], num_experts)

    gates_s = [reduce_sum_op(mul_op(gates, m), axes=1) for m in mask_topk]
    return l_aux, indices_s, location_s, gates_s, capacity


class TopKGate(BaseLayer):
    """A linear gate, softmax and ``topkgating``."""

    def __init__(self, embed_dim, num_tokens, num_experts, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0,
                 initializer=None, name="TopK_Gate"):
        self.embed_dim = embed_dim
        self.num_experts = num_experts
        self.top_k = k
        self.num_tokens = num_tokens
        self.capacity_factor = capacity_factor
        self.initializer = initializer or init.GenXavierUniform()
        self.name = name
        # made once here so train and eval subgraphs share the gate
        self.weight = self.initializer(
            shape=(self.embed_dim, self.num_experts),
            name=self.name + "_linear_weight")
        self.bias = init.zeros(shape=(1, self.num_experts),
                               name=self.name + "_linear_bias")

    def __call__(self, x):
        logits = matmul_op(x, self.weight)
        logits = logits + broadcastto_op(self.bias, logits)
        return topkgating(logits, self.top_k, self.capacity_factor,
                          self.num_tokens, self.num_experts, self.embed_dim)


class HashGate(BaseLayer):
    """Deterministic hash routing: expert = token position mod
    num_experts; gates are 1; no balance loss."""

    def __init__(self, embed_dim, num_tokens, num_experts,
                 capacity_factor=1.0, name="Hash_Gate"):
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.name = name
        idx_val = (np.arange(num_tokens) % num_experts).astype(
            np.float32).reshape(-1, 1)
        self.indices = Variable(name + "_hash_idx", value=idx_val,
                                trainable=False)
        self.ones = Variable(name + "_ones",
                             value=np.ones((num_tokens,), np.float32),
                             trainable=False)

    def __call__(self, x):
        n, e = self.num_tokens, self.num_experts
        capacity = math.ceil((n / e) * self.capacity_factor)
        mask = array_reshape_op(one_hot_op(self.indices, num_classes=e),
                                [-1, e])
        locations = cumsum_with_bias_op(mask, bias=-1, dim=0)
        location_s = [reduce_sum_op(locations * mask, axes=1)]
        return None, [self.indices], location_s, [self.ones], capacity


class KTop1Gate(BaseLayer):
    """Grouped top-1 gating: the group of largest gate mass, then the
    top-1 expert inside it."""

    def __init__(self, embed_dim, num_tokens, num_experts, num_local_gpus=8,
                 capacity_factor=1.0, initializer=None, name="KTop1_Gate"):
        self.embed_dim = embed_dim
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.num_local_gpus = num_local_gpus
        self.capacity_factor = capacity_factor
        self.initializer = initializer or init.GenXavierUniform()
        self.name = name
        self.weight = self.initializer(shape=(embed_dim, num_experts),
                                       name=name + "_linear_weight")

    def _route(self, x):
        """(gates, top1_group, idx, group_size)."""
        e = self.num_experts
        gates = softmax_op(matmul_op(x, self.weight))
        group_mass = sam_group_sum_op(gates, self.num_local_gpus)
        top1_group = topk_idx_op(group_mass, topk=1)
        group_size = e // self.num_local_gpus
        idx = group_topk_idx_op(gates, top1_group, topk=1,
                                num_local_gpus=group_size)
        return gates, top1_group, idx, group_size

    def _top1(self, gates, idx, l_aux_extra=None):
        e = self.num_experts
        capacity = math.ceil((self.num_tokens / e) * self.capacity_factor)
        mask = array_reshape_op(one_hot_op(idx, num_classes=e), [-1, e])
        l_aux = balance_loss(gates, mask, e)
        if l_aux_extra is not None:
            l_aux = l_aux + l_aux_extra
        locations = cumsum_with_bias_op(mask, bias=-1, dim=0)
        location_s = [reduce_sum_op(locations * mask, axes=1)]
        gates_s = [reduce_sum_op(mul_op(gates, mask), axes=1)]
        return l_aux, [idx], location_s, gates_s, capacity

    def __call__(self, x):
        gates, _, idx, _ = self._route(x)
        return self._top1(gates, idx)


class SAMGate(KTop1Gate):
    """Grouped top-1 with the margin of out-of-group experts over the
    chosen one added to the balance loss."""

    def __call__(self, x):
        gates, top1_group, idx, group_size = self._route(x)
        margin = sam_max_op(gates, top1_group, idx, group_size)
        return self._top1(gates, idx, reduce_mean_op(
            reduce_sum_op(margin, axes=1), axes=0))


class BalanceGate(BaseLayer):
    """Balanced assignment gate: every expert gets exactly N / E tokens
    (``balance_assignment_op`` over the centroid scores)."""

    def __init__(self, embed_dim, num_tokens, num_experts, initializer=None,
                 name="Balance_Gate"):
        self.embed_dim = embed_dim
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.initializer = initializer or init.GenXavierUniform()
        self.name = name
        self.centroid = self.initializer(
            shape=(embed_dim, num_experts), name=name + "_centroid")

    def __call__(self, x):
        scores = matmul_op(x, self.centroid)
        indice = balance_assignment_op(scores)
        return indice, self.centroid


class Expert(BaseLayer):
    """Two-matmul FFN expert."""

    def __init__(self, embed_dim, ffn_dim, dropout_rate=0.0, initializer=None,
                 bias=False, activation=None, name="expert"):
        self.embed_dim = embed_dim
        self.ffn_dim = ffn_dim
        self.keep_prob = 1 - dropout_rate
        self.bias = bias
        if isinstance(activation, str):
            activation = _ACTIVATIONS[activation]
        self.activation = activation
        self.initializer = initializer or init.GenXavierUniform()
        self.name = name
        self.w1 = self.initializer(shape=(embed_dim, ffn_dim),
                                   name=name + "_weight_1")
        self.w2 = self.initializer(shape=(ffn_dim, embed_dim),
                                   name=name + "_weight_2")

    def __call__(self, x):
        x = array_reshape_op(x, [-1, self.embed_dim])
        x = matmul_op(x, self.w1)
        if self.activation is not None:
            x = self.activation(x)
        return matmul_op(x, self.w2)


class StackedExperts(BaseLayer):
    """All experts as stacked weights [E, D, F] and [E, F, D]: one
    batched matmul per layer over the expert dim instead of a loop over
    ``Expert`` s (the formulation JAX shards over an 'ep' mesh axis)."""

    def __init__(self, num_experts, embed_dim, ffn_dim, activation=None,
                 initializer=None, name="experts"):
        self.num_experts = int(num_experts)
        self.embed_dim = embed_dim
        self.ffn_dim = ffn_dim
        if isinstance(activation, str):
            activation = _ACTIVATIONS[activation]
        self.activation = activation
        ini = initializer or init.GenXavierUniform()
        self.w1 = ini(shape=(self.num_experts, embed_dim, ffn_dim),
                      name=name + "_expert_stack_w1")
        self.w2 = ini(shape=(self.num_experts, ffn_dim, embed_dim),
                      name=name + "_expert_stack_w2")

    def __call__(self, x):
        """x: [E, cap, D] -> [E, cap, D]."""
        h = batch_matmul_op(x, self.w1)
        if self.activation is not None:
            h = self.activation(h)
        return batch_matmul_op(h, self.w2)


class MoELayer(BaseLayer):
    """The MoE layer in three forms: a list of ``Expert`` s, a
    ``StackedExperts`` (``experts=StackedExperts(...)``), or, named
    "BalanceAssignmentLayer" with a ``BalanceGate``, the balanced
    assignment layer.  Returns (combined, l_aux), the balance layer its
    output alone."""

    def __init__(self, gate=None, experts=None, num_tokens=None,
                 embed_dim=None, all2all_size=None, name="MoELayer",
                 device_id=None, top=None, hierarchical=False):
        self.name = name
        self.gate = gate
        self.experts = experts
        self.stacked = experts if isinstance(experts, StackedExperts) \
            else None
        if self.stacked is not None and all2all_size not in (None, 1):
            raise ValueError(
                "StackedExperts already hold the global expert set; "
                "all2all_size applies to the per-local-expert list only")
        self.num_local_experts = (self.stacked.num_experts
                                  if self.stacked else len(experts))
        self.num_tokens = num_tokens
        self.embed_dim = embed_dim
        self.all2all_size = all2all_size or 1
        self.top = top
        self.hierarchical = hierarchical
        if name == "BalanceAssignmentLayer":
            self.arange_array = Variable(
                "arange_array",
                value=np.arange(num_tokens).astype(np.float32),
                trainable=False)

    def _a2a(self, x):
        if self.hierarchical:
            return halltoall_op(x)
        return alltoall_op(x)

    def _expert_list(self, routed):
        """The list experts over [a2a, local experts, cap, D] rows."""
        outputs = []
        for i in range(self.num_local_experts):
            token_i = split_op(routed, axes=[1], indices=[i],
                               splits=[self.num_local_experts])
            outputs.append(self.experts[i](token_i))
        return concatenate_op(outputs, axis=0)

    def __call__(self, x):
        if self.name == "BalanceAssignmentLayer":
            return self._balance_forward(x)
        if self.stacked is not None:
            return self._stacked_forward(x)
        reshaped = array_reshape_op(x, [-1, self.embed_dim])
        l_aux, indices_s, location_s, gates_s, capacity = self.gate(reshaped)
        total_experts = self.num_local_experts * self.all2all_size
        dispatched = layout_transform_op(
            reshaped, indices_s, location_s, capacity, total_experts)
        dispatched = self._a2a(dispatched)
        dispatched = array_reshape_op(
            dispatched,
            [self.all2all_size, self.num_local_experts, -1, self.embed_dim])
        expert_output = self._a2a(self._expert_list(dispatched))
        expert_output = array_reshape_op(expert_output, [-1, self.embed_dim])
        combined = reverse_layout_transform_op(
            expert_output, indices_s, location_s, gates_s, capacity,
            total_experts)
        return combined, l_aux

    def _stacked_forward(self, x):
        """dispatch -> a2a -> batched expert FFN -> a2a -> combine."""
        reshaped = array_reshape_op(x, [-1, self.embed_dim])
        l_aux, indices_s, location_s, gates_s, capacity = self.gate(reshaped)
        total_experts = self.stacked.num_experts
        dispatched = layout_transform_op(
            reshaped, indices_s, location_s, capacity, total_experts)
        d = array_reshape_op(
            dispatched, [total_experts, capacity, self.embed_dim])
        h = self._a2a(self.stacked(self._a2a(d)))       # [E, cap, D]
        expert_output = array_reshape_op(h, [-1, self.embed_dim])
        combined = reverse_layout_transform_op(
            expert_output, indices_s, location_s, gates_s, capacity,
            total_experts)
        return combined, l_aux

    def _balance_forward(self, x):
        reshaped = array_reshape_op(x, [-1, self.embed_dim])
        # indice: a permutation of token ids, per-expert contiguous blocks
        # of N / E tokens each
        indice, centroid = self.gate(reshaped)
        reverse_indice = scatter1d_op(self.arange_array, indice,
                                      self.arange_array)
        routed_input = self._a2a(indexing_op(reshaped, indice))
        reshaped_routed = array_reshape_op(
            routed_input,
            [self.all2all_size, self.num_local_experts, -1, self.embed_dim])
        expert_output = self._expert_list(reshaped_routed)
        # routed position j belongs to expert j // capacity
        e_total = self.num_experts_total()
        cap = self.num_tokens // e_total
        expert_of_pos = Variable(
            f"{self.name}_expert_of_pos",
            value=np.eye(e_total, dtype=np.float32)[
                np.repeat(np.arange(e_total), cap)],
            trainable=False)
        alpha = softmax_op(matmul_op(routed_input, centroid))
        alpha_sel = reduce_sum_op(mul_op(alpha, expert_of_pos), axes=1)
        w = broadcastto_op(array_reshape_op(alpha_sel, [-1, 1]), expert_output)
        final = w * expert_output + (1.0 - w) * routed_input
        final = indexing_op(final, reverse_indice)
        return self._a2a(final)

    def num_experts_total(self):
        return self.num_local_experts * self.all2all_size
