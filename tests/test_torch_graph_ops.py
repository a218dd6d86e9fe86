"""The port's graph op factories (``hetu_tpu_torch.graph``) against the
JAX package's (``hetu_tpu``), on the CPU.

One parametrised case per exported factory: the same graph is built in
both packages on numpy inputs drawn from a seed; the forward and the
``gradients`` of ``reduce_sum(out * R)`` (R a seeded random array of the
output's shape) with respect to every differentiable float input are
compared.  Floats: ``|port - jax| <= 1e-5 + 1e-5 |jax|``; integer-valued
outputs (argmax, one-hot, top-k indices, ...) exactly.  The JAX graph is
evaluated node by node inside one ``jax.jit`` (its flash attention in
interpret mode, as its own tests run it); the port's through its
``Executor`` on the CPU.  The random ops (``rand_op``, ``dropout_op``, ``dropout2d_op``)
draw from ``torch.Generator`` s and are held to their contracts instead
of to JAX's bits; BatchNorm runs through both executors.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

import hetu_tpu as jm
import hetu_tpu.graph as jgraph
from hetu_tpu.graph.node import TraceContext as JTraceContext
import hetu_tpu_torch.graph as tm

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    # the graph verifier (HETU_VALIDATE) is not in the port yet (A11)
    monkeypatch.setenv("HETU_VALIDATE", "0")


# ----------------------------------------------------------------------- #
# inputs
# ----------------------------------------------------------------------- #

def _draw(rng, spec):
    kind, shape = spec[0], spec[1]
    if kind == "f":
        return rng.randn(*shape).astype(np.float32)
    if kind == "p":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if kind == "u":
        return rng.uniform(0.05, 0.95, shape).astype(np.float32)
    if kind == "m":
        return (rng.rand(*shape) > 0.5).astype(np.float32)
    if kind == "i":
        return rng.randint(0, spec[2], shape).astype(np.int32)
    if kind == "fi":
        return rng.randint(0, spec[2], shape).astype(np.float32)
    if kind == "perm":
        # a permutation of the last axis per row (scatter indices without
        # duplicates)
        return np.argsort(rng.rand(*shape), axis=-1).astype(np.float32)
    if kind == "onehot":
        return np.eye(shape[-1], dtype=np.float32)[
            rng.randint(0, shape[-1], shape[:-1])]
    if kind == "prob":
        x = rng.randn(*shape)
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "logp":
        x = rng.randn(*shape)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
    if kind == "lbl":
        y = rng.randint(0, spec[2], shape).astype(np.int32)
        y.reshape(-1)[::3] = -1          # ignored rows
        return y
    if kind == "lens":
        return np.array(spec[2], np.int32)
    raise ValueError(kind)


_FLOAT_KINDS = ("f", "p", "u", "prob", "logp")

# (id, build(m, *input nodes) -> output node, input specs, differentiable
# input indices (None: every float input; () forward only))
CASES = [
    # ---- ops_misc ----
    ("sum_op", lambda m, a, b, c: m.sum_op([a, b, c]),
     [("f", (3, 4))] * 3, None),
    ("oneslike_op", lambda m, a: m.oneslike_op(a), [("f", (3, 4))], ()),
    ("zeroslike_op", lambda m, a: m.zeroslike_op(a), [("f", (3, 4))], ()),
    ("full_op", lambda m: m.full_op((2, 3), 1.5), [], ()),
    ("full_like_op", lambda m, a: m.full_like_op(a, -2.0), [("f", (3, 4))],
     ()),
    ("arange_op", lambda m: m.arange_op(1, 9, 2), [], ()),
    # ---- ops_math ----
    ("add_op", lambda m, a, b: m.add_op(a, b), [("f", (3, 4)), ("f", (4,))],
     None),
    ("minus_op", lambda m, a, b: m.minus_op(a, b),
     [("f", (3, 4)), ("f", (1, 4))], None),
    ("mul_op", lambda m, a, b: m.mul_op(a, b), [("f", (3, 4)), ("f", (3, 1))],
     None),
    ("div_op", lambda m, a, b: m.div_op(a, b), [("f", (3, 4)), ("p", (3, 4))],
     None),
    ("addbyconst_op", lambda m, a: m.addbyconst_op(a, 2.5), [("f", (3, 4))],
     None),
    ("minus_byconst_op", lambda m, a: m.minus_byconst_op(1.5, a),
     [("f", (3, 4))], None),
    ("mul_byconst_op", lambda m, a: m.mul_byconst_op(a, -0.75),
     [("f", (3, 4))], None),
    ("div_const_op", lambda m, a: m.div_const_op(2.0, a), [("p", (3, 4))],
     None),
    ("opposite_op", lambda m, a: m.opposite_op(a), [("f", (3, 4))], None),
    ("abs_op", lambda m, a: m.abs_op(a), [("f", (3, 4))], None),
    ("abs_gradient_op", lambda m, g, a: m.abs_gradient_op(g, a),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("exp_op", lambda m, a: m.exp_op(a), [("f", (3, 4))], None),
    ("log_op", lambda m, a: m.log_op(a, eps=0.1), [("p", (3, 4))], None),
    ("log_grad_op", lambda m, g, a: m.log_grad_op(g, a),
     [("f", (3, 4)), ("p", (3, 4))], None),
    ("pow_op", lambda m, a: m.pow_op(a, 3.0), [("p", (3, 4))], None),
    ("pow_gradient_op", lambda m, g, a: m.pow_gradient_op(g, a, 2.5),
     [("f", (3, 4)), ("p", (3, 4))], None),
    ("const_pow_op", lambda m, a: m.const_pow_op(2.0, a), [("f", (3, 4))],
     None),
    ("const_pow_gradient_op",
     lambda m, g, a: m.const_pow_gradient_op(g, a, 3.0),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("sqrt_op", lambda m, a: m.sqrt_op(a), [("p", (3, 4))], None),
    ("rsqrt_op", lambda m, a: m.rsqrt_op(a), [("p", (3, 4))], None),
    ("sin_op", lambda m, a: m.sin_op(a), [("f", (3, 4))], None),
    ("cos_op", lambda m, a: m.cos_op(a), [("f", (3, 4))], None),
    ("floor_op", lambda m, a: m.floor_op(a), [("f", (3, 4))], ()),
    ("ceil_op", lambda m, a: m.ceil_op(a), [("f", (3, 4))], ()),
    ("clamp_op", lambda m, a: m.clamp_op(a, -0.5, 0.7), [("f", (3, 4))],
     None),
    ("bool_op", lambda m, a, b: m.bool_op(a, b, cond=3),
     [("f", (3, 4)), ("f", (3, 4))], ()),
    ("where_op", lambda m, c, a, b: m.where_op(c, a, b),
     [("m", (3, 4)), ("f", (3, 4)), ("f", (3, 4))], (1, 2)),
    ("where_const_op", lambda m, c, a: m.where_const_op(c, a, 0.25),
     [("m", (3, 4)), ("f", (3, 4))], (1,)),
    ("masked_fill_op", lambda m, a, k: m.masked_fill_op(a, k, -3.0),
     [("f", (3, 4)), ("m", (3, 4))], (0,)),
    ("sign_op", lambda m, a: m.sign_op(a), [("f", (3, 4))], ()),
    ("max_op", lambda m, a, b: m.max_op(a, b),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("min_op", lambda m, a, b: m.min_op(a, b),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("relu_op", lambda m, a: m.relu_op(a), [("f", (3, 4))], None),
    ("relu_gradient_op", lambda m, a, g: m.relu_gradient_op(a, g),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("leaky_relu_op", lambda m, a: m.leaky_relu_op(a, 0.1), [("f", (3, 4))],
     None),
    ("leaky_relu_gradient_op",
     lambda m, a, g: m.leaky_relu_gradient_op(a, g, 0.1),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("gelu_op", lambda m, a: m.gelu_op(a), [("f", (3, 4))], None),
    ("gelu_gradient_op", lambda m, a, g: m.gelu_gradient_op(a, g),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("sigmoid_op", lambda m, a: m.sigmoid_op(a), [("f", (3, 4))], None),
    ("tanh_op", lambda m, a: m.tanh_op(a), [("f", (3, 4))], None),
    ("tanh_gradient_op", lambda m, y, g: m.tanh_gradient_op(y, g),
     [("u", (3, 4)), ("f", (3, 4))], None),
    ("softmax_op", lambda m, a: m.softmax_op(a), [("f", (3, 5))], None),
    ("softmax_gradient_op", lambda m, y, g: m.softmax_gradient_op(y, g),
     [("prob", (3, 5)), ("f", (3, 5))], None),
    ("softmax_func",
     lambda m, a: m.SimpleOp(lambda v: m.softmax_func(v, axis=0), a),
     [("f", (3, 5))], None),
    ("log_softmax_op", lambda m, a: m.log_softmax_op(a), [("f", (3, 5))],
     None),
    # ---- ops_matmul ----
    ("matmul_op", lambda m, a, b: m.matmul_op(a, b),
     [("f", (3, 4)), ("f", (4, 5))], None),
    ("matmul_op_trans", lambda m, a, b: m.matmul_op(a, b, trans_A=True,
                                                    trans_B=True),
     [("f", (4, 3)), ("f", (5, 4))], None),
    ("linear_op", lambda m, a, w, b: m.linear_op(a, w, b),
     [("f", (3, 4)), ("f", (4, 5)), ("f", (5,))], None),
    ("batch_matmul_op", lambda m, a, b: m.batch_matmul_op(a, b, trans_B=True),
     [("f", (2, 3, 4)), ("f", (2, 5, 4))], None),
    ("baddbmm_op", lambda m, i, a, b: m.baddbmm_op(i, a, b, alpha=0.5,
                                                   beta=2.0),
     [("f", (2, 3, 5)), ("f", (2, 3, 4)), ("f", (2, 4, 5))], None),
    ("addmm_op", lambda m, i, a, b: m.addmm_op(i, a, b, alpha=1.5, beta=0.5),
     [("f", (5,)), ("f", (3, 4)), ("f", (4, 5))], None),
    ("addmm_gradient_op", lambda m, g: m.addmm_gradient_op(g, axis=0),
     [("f", (3, 4))], None),
    ("matrix_dot_op", lambda m, a, b: m.matrix_dot_op(a, b),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("outer_op", lambda m, a, b: m.outer_op(a, b), [("f", (3,)), ("f", (4,))],
     None),
    ("csrmv_op", lambda m, d, r, c, v: m.csrmv_op(d, r, c, (4, 5), v),
     [("f", (7,)), ("fi", (7,), 4), ("fi", (7,), 5), ("f", (5,))], (0, 3)),
    ("csrmm_op", lambda m, d, r, c, v: m.csrmm_op(d, r, c, (4, 5), v,
                                                  trans=True),
     [("f", (7,)), ("fi", (7,), 4), ("fi", (7,), 5), ("f", (4, 3))], (0, 3)),
    # ---- ops_conv ----
    ("conv2d_op", lambda m, x, w: m.conv2d_op(x, w, stride=2, padding=1),
     [("f", (2, 3, 7, 7)), ("f", (4, 3, 3, 3))], None),
    ("conv2d_add_bias_op",
     lambda m, x, w, b: m.conv2d_add_bias_op(x, w, b, stride=1, padding=1),
     [("f", (2, 3, 5, 5)), ("f", (4, 3, 3, 3)), ("f", (4,))], None),
    ("conv2d_broadcastto_op", lambda m, b, t: m.conv2d_broadcastto_op(b, t),
     [("f", (3,)), ("f", (2, 3, 4, 4))], (0,)),
    ("conv2d_reducesum_op", lambda m, x: m.conv2d_reducesum_op(x),
     [("f", (2, 3, 4, 4))], None),
    ("max_pool2d_op", lambda m, x: m.max_pool2d_op(x, 3, 3, padding=1,
                                                   stride=2),
     [("f", (2, 3, 6, 6))], None),
    ("avg_pool2d_op", lambda m, x: m.avg_pool2d_op(x, 2, 2, padding=1,
                                                   stride=2),
     [("f", (2, 3, 6, 6))], None),
    ("layer_normalization_op",
     lambda m, x, s, b: m.layer_normalization_op(x, s, b, eps=1e-5),
     [("f", (4, 6)), ("f", (6,)), ("f", (6,))], None),
    ("instance_normalization2d_op",
     lambda m, x: m.instance_normalization2d_op(x),
     [("f", (2, 3, 4, 4))], None),
    # ---- ops_shape ----
    ("broadcast_reduce_op", lambda m, g, t: m.broadcast_reduce_op(g, t),
     [("f", (2, 3, 4)), ("f", (1, 4))], (0,)),
    ("broadcastto_op", lambda m, a, t: m.broadcastto_op(a, t),
     [("f", (4,)), ("f", (3, 4))], (0,)),
    ("broadcast_shape_op",
     lambda m, a: m.broadcast_shape_op(a, (2, 3, 4), add_axes=[0]),
     [("f", (3, 4))], None),
    ("reduce_sum_op", lambda m, a: m.reduce_sum_op(a, axes=[0, 2],
                                                   keepdims=True),
     [("f", (2, 3, 4))], None),
    ("reduce_mean_op", lambda m, a: m.reduce_mean_op(a, axes=1),
     [("f", (2, 3, 4))], None),
    ("reducesumaxiszero_op", lambda m, a: m.reducesumaxiszero_op(a),
     [("f", (3, 4))], None),
    ("reduce_min_op", lambda m, a: m.reduce_min_op(a, axes=1),
     [("f", (3, 4))], None),
    ("reduce_norm1_op", lambda m, a: m.reduce_norm1_op(a, axes=0),
     [("f", (3, 4))], None),
    ("reduce_norm2_op", lambda m, a: m.reduce_norm2_op(a),
     [("f", (3, 4))], None),
    ("norm_op", lambda m, a: m.norm_op(a, axis=1), [("f", (3, 4))], None),
    ("array_reshape_op", lambda m, a: m.array_reshape_op(a, [4, -1]),
     [("f", (2, 3, 4))], None),
    ("transpose_op", lambda m, a: m.transpose_op(a, [2, 0, 1]),
     [("f", (2, 3, 4))], None),
    ("squeeze_op", lambda m, a: m.squeeze_op(a, 1), [("f", (3, 1, 4))], None),
    ("slice_op", lambda m, a: m.slice_op(a, [1, 0], [-1, 3]),
     [("f", (4, 5))], None),
    ("slice_assign_op", lambda m, a: m.slice_assign_op(a, 0.5, [1, 1],
                                                       [2, 2]),
     [("f", (4, 5))], None),
    ("slice_assign_matrix_op",
     lambda m, a, b: m.slice_assign_matrix_op(a, b, [0, 1], [2, 3], [1, 0]),
     [("f", (4, 5)), ("f", (3, 4))], None),
    ("slice_by_matrix_op", lambda m, a, i, j: m.slice_by_matrix_op(a, i, j),
     [("f", (4, 5)), ("fi", (3,), 4), ("fi", (3,), 5)], (0,)),
    ("split_op", lambda m, a: m.split_op(a, [0, 1], [1, 0], [2, 2]),
     [("f", (4, 6))], None),
    ("concat_op", lambda m, a, b: m.concat_op(a, b, axis=1),
     [("f", (3, 2)), ("f", (3, 4))], None),
    ("concatenate_op", lambda m, a, b, c: m.concatenate_op([a, b, c]),
     [("f", (1, 4)), ("f", (2, 4)), ("f", (3, 4))], None),
    ("pad_op_constant",
     lambda m, a: m.pad_op(a, [[1, 2], [0, 1]], constant_values=0.5),
     [("f", (3, 4))], None),
    ("pad_op_reflect", lambda m, a: m.pad_op(a, [[1, 2], [2, 1]], "REFLECT"),
     [("f", (4, 5))], None),
    ("pad_op_symmetric",
     lambda m, a: m.pad_op(a, [[2, 1], [1, 2]], "SYMMETRIC"),
     [("f", (4, 5))], None),
    ("flatten_op", lambda m, a: m.flatten_op(a), [("f", (2, 3, 4))], None),
    ("tile_op", lambda m, a: m.tile_op(a, (2, 3)), [("f", (2, 3))], None),
    ("repeat_op", lambda m, a: m.repeat_op(a, 2, axis=1), [("f", (2, 3))],
     None),
    ("repeat_op_flat", lambda m, a: m.repeat_op(a, 3), [("f", (2, 3))], None),
    ("roll_op", lambda m, a: m.roll_op(a, 2, axis=1), [("f", (3, 5))], None),
    ("interpolate_op",
     lambda m, a: m.interpolate_op(a, scale_factor=2, mode="bilinear"),
     [("f", (1, 2, 3, 4))], None),
    ("interpolate_op_nearest",
     lambda m, a: m.interpolate_op(a, size=(7, 5), mode="nearest"),
     [("f", (1, 2, 3, 4))], None),
    ("gather_op", lambda m, a, i: m.gather_op(a, 1, i),
     [("f", (3, 5)), ("fi", (3, 4), 5)], (0,)),
    ("scatter_op", lambda m, a, i, s: m.scatter_op(a, 1, i, s),
     [("f", (3, 5)), ("perm", (3, 5)), ("f", (3, 5))], (0, 2)),
    ("scatter1d_op", lambda m, a, i, s: m.scatter1d_op(a, i, s),
     [("f", (6,)), ("perm", (6,)), ("f", (6,))], (0, 2)),
    ("indexing_op", lambda m, a, i: m.indexing_op(a, i),
     [("f", (5, 3)), ("fi", (4,), 5)], (0,)),
    ("one_hot_op", lambda m, i: m.one_hot_op(i, 6), [("fi", (2, 3), 6)], ()),
    ("argmax_op", lambda m, a: m.argmax_op(a, dim=1), [("f", (3, 5))], ()),
    ("argsort_op", lambda m, a: m.argsort_op(a, dim=1, descending=True),
     [("f", (3, 5))], ()),
    ("argmax_partial_op", lambda m, a, k: m.argmax_partial_op(a, k),
     [("f", (3, 5)), ("m", (3, 5))], ()),
    ("cumsum_with_bias_op", lambda m, a: m.cumsum_with_bias_op(a, -1.0, 1),
     [("f", (3, 5))], None),
    ("cumsum_op", lambda m, a: m.cumsum_op(a, dim=0), [("f", (3, 5))], None),
    ("topk_idx_op", lambda m, a: m.topk_idx_op(a, topk=2), [("f", (3, 5))],
     ()),
    ("topk_val_op", lambda m, a: m.topk_val_op(a, topk=3), [("f", (3, 5))],
     None),
    ("min_dist_op", lambda m, t, q, i: m.min_dist_op(t, q, i),
     [("f", (6,)), ("f", (4,)), ("fi", (4,), 6)], ()),
    # ---- ops_loss ----
    ("softmaxcrossentropy_op", lambda m, a, y: m.softmaxcrossentropy_op(a, y),
     [("f", (4, 5)), ("onehot", (4, 5))], (0,)),
    ("softmaxcrossentropy_sparse_op",
     lambda m, a, y: m.softmaxcrossentropy_sparse_op(a, y),
     [("f", (6, 5)), ("lbl", (6,), 5)], (0,)),
    ("crossentropy_op", lambda m, p, y: m.crossentropy_op(p, y),
     [("prob", (4, 5)), ("onehot", (4, 5))], (0,)),
    ("crossentropy_sparse_op",
     lambda m, p, y: m.crossentropy_sparse_op(p, y),
     [("prob", (6, 5)), ("lbl", (6,), 5)], (0,)),
    ("binarycrossentropy_op", lambda m, p, y: m.binarycrossentropy_op(p, y),
     [("u", (3, 4)), ("m", (3, 4))], (0,)),
    ("binarycrossentropywithlogits_op",
     lambda m, z, y: m.binarycrossentropywithlogits_op(z, y),
     [("f", (3, 4)), ("u", (3, 4))], None),
    ("nll_loss_op", lambda m, lp, y: m.nll_loss_op(lp, y),
     [("logp", (4, 5)), ("i", (4,), 5)], (0,)),
    ("mseloss_op", lambda m, p, y: m.mseloss_op(p, y),
     [("f", (3, 4)), ("f", (3, 4))], None),
    ("tied_lm_head_xent_op",
     lambda m, h, w, b, y: m.tied_lm_head_xent_op(h, w, b, y, n_chunks=3),
     [("f", (10, 6)), ("f", (7, 6)), ("f", (7,)), ("lbl", (10,), 7)],
     (0, 1, 2)),
    # ---- ops_embed ----
    ("embedding_lookup_op", lambda m, t, i: m.embedding_lookup_op(t, i),
     [("f", (7, 4)), ("i", (2, 5), 7)], (0,)),
    ("unique_indices_op", lambda m, i: m.unique_indices_op(i),
     [("fi", (2, 5), 4)], ()),
    # ---- ops_attention ----
    ("flash_attention_op",
     lambda m, q, k, v: m.flash_attention_op(q, k, v, causal=True),
     [("f", (2, 8, 2, 4))] * 3, None),
    ("flash_attention_op_kv_lens",
     lambda m, q, k, v, n: m.flash_attention_op(q, k, v, kv_lens=n),
     [("f", (2, 8, 2, 4))] * 3 + [("lens", (2,), [5, 8])], (0, 1, 2)),
]


def _jax_eval(nodes, feeds):
    """The JAX graph evaluated node by node in one jitted function (the
    body of the JAX executor's trace)."""
    topo = jgraph.find_topo_sort(nodes)
    phs = [n for n in topo if isinstance(n, jgraph.PlaceholderOp)]

    def fn(*args):
        tc = JTraceContext(rng=jax.random.PRNGKey(0), training=True)
        vals = {id(p): a for p, a in zip(phs, args)}
        for n in topo:
            if id(n) not in vals:
                vals[id(n)] = n.compute([vals[id(i)] for i in n.inputs], tc)
        return [vals[id(n)] for n in nodes]

    outs = jax.jit(fn)(*[jnp.asarray(feeds[p]) for p in phs])
    return [np.asarray(o) for o in outs]


def _port_eval(nodes, feeds):
    ex = tm.Executor(list(nodes), device="cpu")
    return [o.detach().numpy() for o in ex.run(feed_dict=feeds)]


def _check(got, want, what, exact):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want.astype(got.dtype), atol=ATOL,
                                   rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_factory_matches_jax(case):
    name, build, specs, diff = case
    rng = np.random.RandomState(sum(map(ord, name)))
    arrays = [_draw(rng, s) for s in specs]
    if diff is None:
        diff = tuple(i for i, s in enumerate(specs) if s[0] in _FLOAT_KINDS)
    outs, r_val = {}, None
    for m, ev in ((tm, _port_eval), (jm, _jax_eval)):
        xs = [m.placeholder_op(f"in{i}") for i in range(len(specs))]
        out = build(m, *xs)
        feeds = dict(zip(xs, arrays))
        nodes = [out]
        if diff:
            if r_val is None:
                # R has the output's shape: the port's forward gives it
                (fwd,) = ev([out], feeds)
                r_val = np.asarray(
                    np.random.RandomState(7).randn(*fwd.shape), np.float32)
            r = m.placeholder_op("r")
            feeds[r] = r_val
            loss = m.reduce_sum_op(m.mul_op(out, r))
            nodes += m.gradients(loss, [xs[i] for i in diff])
        outs[m] = ev(nodes, feeds)
    exact = not np.issubdtype(outs[jm][0].dtype, np.floating) or \
        name in ("argmax_op", "argsort_op", "argmax_partial_op",
                 "topk_idx_op", "min_dist_op", "one_hot_op",
                 "unique_indices_op", "floor_op", "ceil_op", "sign_op",
                 "bool_op")
    _check(outs[tm][0], outs[jm][0], f"{name} forward", exact)
    for k, i in enumerate(diff):
        _check(outs[tm][1 + k], outs[jm][1 + k], f"{name} d/d in{i}", False)


# the names of ``import hetu_tpu as ht`` beyond JAX's graph/__init__.py
# that the port's graph package exports
EXTRA_NAMES = {"ShapeInferenceError", "flash_attention_op",
               "ring_attention_op", "init", "layers", "optim", "Executor",
               "HetuConfig", "SubExecutor", "dataloader_op", "lr",
               "Dataloader", "DataloaderOp", "GNNDataLoaderOp",
               "layout_transform_op", "layout_transform_gradient_op",
               "reverse_layout_transform_op",
               "reverse_layout_transform_gradient_data_op",
               "reverse_layout_transform_gradient_gate_op",
               "reverse_layout_transform_no_gate_op", "alltoall_op",
               "halltoall_op", "balance_assignment_op", "group_topk_idx_op",
               "sam_group_sum_op", "sam_max_op", "dispatch"}
# the MoE factories, held to JAX in tests/test_torch_moe_layer.py
MOE_FACTORIES = {n for n in EXTRA_NAMES
                 if n.endswith("_op") and "attention" not in n
                 and n != "dataloader_op"}

# the comm factories and the strategies (``ht.dist``), which the JAX
# package's top-level ``ht`` exports, held to JAX in
# tests/test_torch_ops_comm.py and tests/test_torch_strategies.py
COMM_NAMES = {"allreduceCommunicate_op", "allreduceCommunicatep2p_op",
              "groupallreduceCommunicate_op", "allgatherCommunicate_op",
              "reducescatterCommunicate_op", "broadcastCommunicate_op",
              "reduceCommunicate_op", "pipeline_send_op",
              "pipeline_receive_op", "parameterServerCommunicate_op",
              "parameterServerSparsePull_op", "datah2d_op", "datad2h_op",
              "quantized_allreduce_op"}
EXTRA_NAMES |= COMM_NAMES | {"dist"}


def test_export_list_is_jax():
    jax_names = {n for n in dir(jgraph) if not n.startswith("_")} - {
        "node", "autodiff", "ops_misc", "ops_math", "ops_matmul",
        "ops_conv", "ops_shape", "ops_loss", "ops_embed", "ops_gnn",
        "ops_attention", "ops_comm", "ops_moe", "annotations"}
    port = set(tm.__all__)
    assert port - EXTRA_NAMES == jax_names
    for n in port:
        assert hasattr(tm, n), n


def test_every_factory_has_a_case():
    """Every exported ``*_op`` factory (and ``softmax_func``) is one of
    the parity cases above or of the random ops' tests below."""
    covered = {c[0].split("_op")[0] + "_op" if "_op" in c[0] else c[0]
               for c in CASES}
    covered |= {"rand_op", "dropout_op", "dropout2d_op",
                "batch_normalization_op", "placeholder_op",
                "ring_attention_op"} | MOE_FACTORIES | COMM_NAMES
    # the 1.5-D GCN factory: tests/test_torch_gnn.py
    covered.add("distgcn_15d_op")
    factories = {n for n in tm.__all__ if n.endswith("_op")
                 or n == "softmax_func"} - {"dataloader_op"}
    assert factories - covered == set()


# ----------------------------------------------------------------------- #
# random ops: their contracts (torch.Generator streams, not JAX's bits)
# ----------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["rand_op", "dropout_op", "dropout2d_op"])
def test_random_op_contract(kind):
    if kind == "rand_op":
        node = tm.rand_op((4000,))
        ex = tm.Executor([node], device="cpu", seed=3)
        a, = ex.run()
        b, = ex.run()
        assert a.shape == (4000,) and float(a.min()) >= 0.0 \
            and float(a.max()) < 1.0
        assert abs(float(a.mean()) - 0.5) < 0.03
        assert not torch.equal(a, b), "fresh values each run"
        ex2 = tm.Executor([node], device="cpu", seed=3)
        assert torch.equal(ex2.run()[0], a), "seeded streams repeat"
        return
    x = tm.placeholder_op("x")
    w = tm.Variable("w", value=np.ones((1,), np.float32))
    h = tm.mul_op(x, w)
    keep = 0.7
    out = (tm.dropout_op if kind == "dropout_op" else tm.dropout2d_op)(
        h, keep)
    loss = tm.reduce_sum_op(out)
    train = tm.optim.SGDOptimizer(learning_rate=1.0).minimize(loss)
    gx, = tm.gradients(loss, [x])
    X = np.random.RandomState(0).uniform(0.5, 1.5, (40, 50, 2, 2)) \
        .astype(np.float32)
    ex = tm.Executor({"train": [out, gx, train], "eval": [out]},
                     device="cpu")
    o, g, _ = ex.run("train", feed_dict={x: X})
    kept = o != 0
    # kept entries are x / keep, and the backward used the same mask
    np.testing.assert_allclose(o[kept].numpy(), X[kept.numpy()] / keep,
                               rtol=1e-6)
    np.testing.assert_array_equal((g != 0).numpy(), kept.numpy())
    np.testing.assert_allclose(g[kept].numpy(), 1.0 / keep, rtol=1e-6)
    assert abs(float(kept.float().mean()) - keep) < 0.05
    if kind == "dropout2d_op":
        # one mask per (n, c) plane
        per_plane = kept.reshape(40, 50, 4)
        assert bool((per_plane.all(-1) | ~per_plane.any(-1)).all())
    # w's step: dL/dw = sum(mask / keep * x)
    want_w = 1.0 - float((o.double()).sum())
    np.testing.assert_allclose(ex.var_values["w"].numpy(), [want_w],
                               rtol=1e-5)
    # eval: dropout is the identity (of x * w after the step)
    ev, = ex.run("eval", feed_dict={x: X})
    np.testing.assert_allclose(ev.numpy(), X * np.float32(want_w),
                               rtol=1e-6)
    assert ex.step == 1


def test_batch_normalization_matches_jax():
    """BatchNorm through both executors from the same state: train-mode
    output, gradients and running statistics, then eval-mode output."""
    outs = {}
    X = np.random.RandomState(1).randn(4, 3, 5, 5).astype(np.float32)
    for m in (jm, tm):
        x = m.placeholder_op("x")
        scale = m.init.random_normal((3,), mean=1.0, stddev=0.1,
                                     name="bn_scale")
        bias = m.init.random_normal((3,), stddev=0.1, name="bn_bias")
        y = m.batch_normalization_op(x, scale, bias, momentum=0.9, eps=1e-5)
        loss = m.reduce_sum_op(m.mul_op(y, y))
        gx, gs, gb = m.gradients(loss, [x, scale, bias])
        kw = {} if m is jm else {"device": "cpu"}
        ex = m.Executor({"train": [y, gx, gs, gb], "eval": [y]}, **kw)
        if m is tm:
            ex.load_dict(outs[jm]["init"])
        init = ex.return_tensor_values()
        tr = [np.asarray(v) for v in ex.run("train", feed_dict={x: X})]
        ev = np.asarray(ex.run("eval", feed_dict={x: X})[0])
        outs[m] = {"init": init, "train": tr, "eval": ev,
                   "state": ex.return_tensor_values()}
    for a, b in zip(outs[tm]["train"], outs[jm]["train"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(outs[tm]["eval"], outs[jm]["eval"],
                               atol=ATOL, rtol=RTOL)
    for k in ("bn_scale_running_mean", "bn_scale_running_var"):
        np.testing.assert_allclose(outs[tm]["state"][k], outs[jm]["state"][k],
                                   atol=ATOL, rtol=RTOL)


def test_infer_shape_and_its_error():
    a = tm.placeholder_op("a")
    b = tm.placeholder_op("b")
    node = tm.matmul_op(a, b)
    assert node.infer_shape([(3, 4), (4, 5)]) == (3, 5)
    with pytest.raises(tm.ShapeInferenceError, match="float32\\(3, 4\\)"):
        node.infer_shape([(3, 4), (5, 5)])
