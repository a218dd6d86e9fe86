"""Neural collaborative filtering on the graph surface: the port of the
JAX package's ``models/ncf.py``.

NeuMF = GMF (elementwise product of user and item factors) + an MLP
tower over the concatenated factors, fused by a final linear layer.
"""

from __future__ import annotations

from ..graph import (
    embedding_lookup_op, slice_op, mul_op, concat_op, matmul_op, relu_op,
    sigmoid_op, binarycrossentropy_op, reduce_mean_op,
)
from ..graph import init, optim


def neural_mf(user_input, item_input, y_, num_users, num_items,
              embed_dim=8, mlp_layers=(64, 32, 16, 8), lr=0.01,
              embedding_ctx=None):
    layers = list(mlp_layers)
    user_emb = init.random_normal(
        (num_users, embed_dim + layers[0] // 2), stddev=0.01,
        name="user_embed", ctx=embedding_ctx)
    item_emb = init.random_normal(
        (num_items, embed_dim + layers[0] // 2), stddev=0.01,
        name="item_embed", ctx=embedding_ctx)

    user_latent = embedding_lookup_op(user_emb, user_input)
    item_latent = embedding_lookup_op(item_emb, item_input)

    mf_user = slice_op(user_latent, (0, 0), (-1, embed_dim))
    mlp_user = slice_op(user_latent, (0, embed_dim), (-1, -1))
    mf_item = slice_op(item_latent, (0, 0), (-1, embed_dim))
    mlp_item = slice_op(item_latent, (0, embed_dim), (-1, -1))

    mf_vector = mul_op(mf_user, mf_item)
    x = concat_op(mlp_user, mlp_item, axis=1)
    for i in range(1, len(layers)):
        W = init.random_normal((layers[i - 1], layers[i]), stddev=0.1,
                               name=f"W{i}")
        x = relu_op(matmul_op(x, W))

    W_out = init.random_normal((embed_dim + layers[-1], 1), stddev=0.1,
                               name=f"W{len(layers)}")
    y = sigmoid_op(matmul_op(concat_op(mf_vector, x, axis=1), W_out))
    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    train_op = optim.SGDOptimizer(learning_rate=lr).minimize(loss)
    return loss, y, train_op
