"""The graph IR user surface of the port: op nodes, graph autodiff, the
dense op factories, graph layers, ``optim.*.minimize`` and the
named-subgraph ``Executor``.

``import hetu_tpu_torch.graph as ht`` gives a script the names the JAX
package (``hetu_tpu``) gives it as ``ht`` for this surface: the
factories of its ``graph/__init__.py``, ``gradients``, ``layers``, ``init``, ``optim``, ``lr`` (the
schedulers), ``dist`` (the distribution strategies), the comm ops,
``Executor``, ``dataloader_op``/``Dataloader``,
``flash_attention_op`` and ``ring_attention_op``:

    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    w = ht.init.xavier_uniform((4, 2), name="w")
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(x, w), y), axes=0)
    train = ht.optim.SGDOptimizer(learning_rate=0.5).minimize(loss)
    ex = ht.Executor({"train": [loss, train]}, device="cpu")
    loss_val, _ = ex.run("train", feed_dict={x: X, y: Y})

Nodes compute on torch tensors; the executor runs on the card unless
``device="cpu"`` is passed.
"""

from .node import Op, SimpleOp, TraceContext, ShapeInferenceError
from .autodiff import gradients, find_topo_sort, sum_node_list
from .ops_misc import (
    PlaceholderOp, Variable, placeholder_op, VJPOp, SumOp, sum_op,
    OnesLikeOp, ZerosLikeOp, oneslike_op, zeroslike_op, full_op,
    full_like_op, arange_op, rand_op,
)
from .ops_math import (
    add_op, minus_op, mul_op, div_op, addbyconst_op, minus_byconst_op,
    mul_byconst_op, div_const_op, opposite_op, abs_op, abs_gradient_op,
    exp_op, log_op, log_grad_op, pow_op, pow_gradient_op, const_pow_op,
    const_pow_gradient_op, sqrt_op, rsqrt_op, sin_op, cos_op, floor_op,
    ceil_op, clamp_op, bool_op, where_op, where_const_op, masked_fill_op,
    sign_op, max_op, min_op, relu_op, relu_gradient_op, leaky_relu_op,
    leaky_relu_gradient_op, gelu_op, gelu_gradient_op, sigmoid_op, tanh_op,
    tanh_gradient_op, softmax_op, softmax_gradient_op, softmax_func,
    log_softmax_op,
)
from .ops_matmul import (
    matmul_op, linear_op, batch_matmul_op, baddbmm_op, addmm_op,
    addmm_gradient_op, matrix_dot_op, outer_op, csrmv_op, csrmm_op,
)
from .ops_conv import (
    conv2d_op, conv2d_add_bias_op, conv2d_broadcastto_op,
    conv2d_reducesum_op, max_pool2d_op, avg_pool2d_op,
    batch_normalization_op, layer_normalization_op,
    instance_normalization2d_op, dropout_op, dropout2d_op, BatchNormOp,
    DropoutOp,
)
from .ops_shape import (
    broadcast_reduce_op, broadcastto_op, broadcast_shape_op, reduce_sum_op,
    reduce_mean_op, reducesumaxiszero_op, reduce_min_op, reduce_norm1_op,
    reduce_norm2_op, norm_op, array_reshape_op, transpose_op, squeeze_op,
    slice_op,
    slice_assign_op, slice_assign_matrix_op, slice_by_matrix_op, split_op,
    concat_op, concatenate_op, pad_op, flatten_op, tile_op, repeat_op,
    roll_op, interpolate_op, gather_op, scatter_op, scatter1d_op,
    indexing_op, one_hot_op, argmax_op, argsort_op, argmax_partial_op,
    cumsum_with_bias_op, cumsum_op, topk_idx_op, topk_val_op, min_dist_op,
)
from .ops_loss import (
    softmaxcrossentropy_op, softmaxcrossentropy_sparse_op, crossentropy_op,
    crossentropy_sparse_op, binarycrossentropy_op,
    binarycrossentropywithlogits_op, nll_loss_op, mseloss_op,
    tied_lm_head_xent_op,
)
from .ops_embed import (
    EmbeddingLookupOp, embedding_lookup_op, IndexedSlicesOp,
    unique_indices_op,
)
from .ops_gnn import DistGCN15dOp, distgcn_15d_op, gcn_layer_shard_specs
from .ops_attention import flash_attention_op, ring_attention_op
from .ops_moe import (
    layout_transform_op, layout_transform_gradient_op,
    reverse_layout_transform_op, reverse_layout_transform_gradient_data_op,
    reverse_layout_transform_gradient_gate_op,
    reverse_layout_transform_no_gate_op, alltoall_op, halltoall_op,
    balance_assignment_op, group_topk_idx_op, sam_group_sum_op, sam_max_op,
    dispatch,
)
from .ops_comm import (
    allreduceCommunicate_op, allreduceCommunicatep2p_op,
    groupallreduceCommunicate_op, allgatherCommunicate_op,
    reducescatterCommunicate_op, broadcastCommunicate_op,
    reduceCommunicate_op, pipeline_send_op, pipeline_receive_op,
    parameterServerCommunicate_op, parameterServerSparsePull_op,
    datah2d_op, datad2h_op, quantized_allreduce_op,
)
from . import init, layers, optim
from .. import lr_scheduler as lr
from ..dataloader import (Dataloader, DataloaderOp, GNNDataLoaderOp,
                          dataloader_op)
from .executor import Executor, HetuConfig, SubExecutor
from ..parallel import distributed_strategies as dist

__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("node", "autodiff", "executor", "ops_misc",
                         "ops_math", "ops_matmul", "ops_conv", "ops_shape",
                         "ops_loss", "ops_embed", "ops_gnn",
                         "ops_attention", "ops_moe", "ops_comm",
                         "tensor_parallel")]
