"""CTR models on the graph surface: the port of the JAX package's
``models/ctr.py``: Wide&Deep (Adult, Criteo), Deep&Cross, DeepFM and
Deep Crossing.

Each model function is ``model(dense_input, sparse_input, y_)`` returning
``(loss, prediction, y_, train_op)`` and builds its own SGD optimizer.
``feature_dimension`` and ``embedding_size`` are keyword arguments (the
reference's Criteo table has 33,762,577 rows).  ``embedding_ctx`` is
kept as the embeddings' placement hint; the parameter-server placement
it selects in JAX waits for ROADMAP A10.
"""

from __future__ import annotations

from ..graph import (
    matmul_op, broadcastto_op, relu_op, sigmoid_op, embedding_lookup_op,
    array_reshape_op, concat_op, mul_op, reduce_sum_op, reduce_mean_op,
    softmaxcrossentropy_op, binarycrossentropy_op, mul_byconst_op,
)
from ..graph import init, optim


def _sgd(lr):
    return optim.SGDOptimizer(learning_rate=lr)


def wdl_adult(X_deep, X_wide, y_, lr=5 / 128):
    """Wide&Deep on the Adult census dataset (reference wdl_adult.py).

    X_deep: list of 12 sparse int columns (8 embedded + 4 passed through);
    X_wide: (N, 809) dense wide features; y_: (N, 2) one-hot.
    """
    dim_wide = 809

    W = init.random_normal([dim_wide + 20, 2], stddev=0.1, name="W")
    W1 = init.random_normal([68, 50], stddev=0.1, name="W1")
    b1 = init.random_normal([50], stddev=0.1, name="b1")
    W2 = init.random_normal([50, 20], stddev=0.1, name="W2")
    b2 = init.random_normal([20], stddev=0.1, name="b2")

    X_deep_input = None
    for i in range(8):
        emb = init.random_normal([50, 8], stddev=0.1,
                                 name=f"Embedding_deep_{i}")
        now = embedding_lookup_op(emb, X_deep[i])
        now = array_reshape_op(now, (-1, 8))
        X_deep_input = now if X_deep_input is None \
            else concat_op(X_deep_input, now, 1)
    for i in range(4):
        now = array_reshape_op(X_deep[i + 8], (-1, 1))
        X_deep_input = concat_op(X_deep_input, now, 1)

    mat1 = matmul_op(X_deep_input, W1)
    relu1 = relu_op(mat1 + broadcastto_op(b1, mat1))
    mat2 = matmul_op(relu1, W2)
    dmodel = relu_op(mat2 + broadcastto_op(b2, mat2))

    wmodel = matmul_op(concat_op(X_wide, dmodel, 1), W)

    prediction = wmodel
    loss = reduce_mean_op(softmaxcrossentropy_op(prediction, y_), [0])
    train_op = _sgd(lr).minimize(loss)
    return loss, prediction, y_, train_op


def wdl_criteo(dense_input, sparse_input, y_, feature_dimension=33762577,
               embedding_size=128, lr=0.01, embedding_ctx=None):
    """Wide&Deep on Criteo (reference wdl_criteo.py)."""
    Embedding = init.random_normal([feature_dimension, embedding_size],
                                   stddev=0.01, name="snd_order_embedding",
                                   ctx=embedding_ctx)
    sparse = embedding_lookup_op(Embedding, sparse_input)
    sparse = array_reshape_op(sparse, (-1, 26 * embedding_size))

    W1 = init.random_normal([13, 256], stddev=0.01, name="W1")
    W2 = init.random_normal([256, 256], stddev=0.01, name="W2")
    W3 = init.random_normal([256, 256], stddev=0.01, name="W3")
    W4 = init.random_normal([256 + 26 * embedding_size, 1], stddev=0.01,
                            name="W4")

    y3 = matmul_op(relu_op(matmul_op(relu_op(matmul_op(dense_input, W1)),
                                     W2)), W3)
    y = sigmoid_op(matmul_op(concat_op(sparse, y3, axis=1), W4))

    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    train_op = _sgd(lr).minimize(loss)
    return loss, y, y_, train_op


def _cross_layer(x0, x1, embedding_len, name):
    """DCN cross layer: y = x0 * (x1 w) + b + x1 (reference dcn_criteo.py)."""
    weight = init.random_normal(shape=(embedding_len, 1), stddev=0.01,
                                name=name + "_weight")
    bias = init.random_normal(shape=(embedding_len,), stddev=0.01,
                              name=name + "_bias")
    x1w = matmul_op(x1, weight)
    y = mul_op(x0, broadcastto_op(x1w, x0))
    return y + x1 + broadcastto_op(bias, y)


def dcn_criteo(dense_input, sparse_input, y_, feature_dimension=33762577,
               embedding_size=128, lr=0.003, num_cross_layers=3,
               embedding_ctx=None):
    """Deep&Cross on Criteo (reference dcn_criteo.py)."""
    Embedding = init.random_normal([feature_dimension, embedding_size],
                                   stddev=0.01, name="snd_order_embedding",
                                   ctx=embedding_ctx)
    sparse = embedding_lookup_op(Embedding, sparse_input)
    sparse = array_reshape_op(sparse, (-1, 26 * embedding_size))
    x = concat_op(sparse, dense_input, axis=1)
    embedding_len = 26 * embedding_size + 13

    cross = x
    for i in range(num_cross_layers):
        cross = _cross_layer(x, cross, embedding_len, f"cross{i}")

    W1 = init.random_normal([embedding_len, 256], stddev=0.01, name="W1")
    W2 = init.random_normal([256, 256], stddev=0.01, name="W2")
    W3 = init.random_normal([256, 256], stddev=0.01, name="W3")
    W4 = init.random_normal([256 + embedding_len, 1], stddev=0.01,
                            name="W4")
    y3 = matmul_op(relu_op(matmul_op(relu_op(matmul_op(x, W1)), W2)), W3)
    y = sigmoid_op(matmul_op(concat_op(cross, y3, axis=1), W4))

    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    train_op = _sgd(lr).minimize(loss)
    return loss, y, y_, train_op


def deepfm_criteo(dense_input, sparse_input, y_, feature_dimension=33762577,
                  embedding_size=128, lr=0.01, embedding_ctx=None):
    """DeepFM on Criteo (reference deepfm_criteo.py dfm_criteo)."""
    # first-order FM terms
    Embedding1 = init.random_normal([feature_dimension, 1], stddev=0.01,
                                    name="fst_order_embedding",
                                    ctx=embedding_ctx)
    FM_W = init.random_normal([13, 1], stddev=0.01, name="dense_parameter")
    sparse_1dim = embedding_lookup_op(Embedding1, sparse_input)
    y1 = matmul_op(dense_input, FM_W) + reduce_sum_op(sparse_1dim, axes=1)

    # second-order FM terms: 0.5 * ((sum e)^2 - sum e^2)
    Embedding2 = init.random_normal([feature_dimension, embedding_size],
                                    stddev=0.01,
                                    name="snd_order_embedding",
                                    ctx=embedding_ctx)
    e = embedding_lookup_op(Embedding2, sparse_input)
    e_sum = reduce_sum_op(e, axes=1)
    sum_sq = mul_op(e_sum, e_sum)
    sq_sum = reduce_sum_op(mul_op(e, e), axes=1)
    y2 = reduce_sum_op(mul_byconst_op(sum_sq + mul_byconst_op(sq_sum, -1.0),
                                      0.5), axes=1, keepdims=True)

    # DNN over flattened embeddings
    flatten = array_reshape_op(e, (-1, 26 * embedding_size))
    W1 = init.random_normal([26 * embedding_size, 256], stddev=0.01,
                            name="W1")
    W2 = init.random_normal([256, 256], stddev=0.01, name="W2")
    W3 = init.random_normal([256, 1], stddev=0.01, name="W3")
    y3 = matmul_op(relu_op(matmul_op(relu_op(matmul_op(flatten, W1)), W2)),
                   W3)

    y = sigmoid_op(y1 + y2 + y3)
    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    train_op = _sgd(lr).minimize(loss)
    return loss, y, y_, train_op


def _residual_layer(x0, input_dim, hidden_dim, name):
    w1 = init.random_normal((input_dim, hidden_dim), stddev=0.1,
                            name=name + "_weight_1")
    b1 = init.random_normal((hidden_dim,), stddev=0.1, name=name + "_bias_1")
    w2 = init.random_normal((hidden_dim, input_dim), stddev=0.1,
                            name=name + "_weight_2")
    b2 = init.random_normal((input_dim,), stddev=0.1, name=name + "_bias_2")
    h = matmul_op(x0, w1)
    h = relu_op(h + broadcastto_op(b1, h))
    out = matmul_op(h, w2)
    out = out + broadcastto_op(b2, out)
    return relu_op(out + x0)


def dc_criteo(dense_input, sparse_input, y_, feature_dimension=33762577,
              embedding_size=8, lr=0.001, num_layers=5, embedding_ctx=None):
    """Deep Crossing on Criteo (reference dc_criteo.py)."""
    Embedding = init.random_normal([feature_dimension, embedding_size],
                                   stddev=0.01, name="snd_order_embedding",
                                   ctx=embedding_ctx)
    sparse = embedding_lookup_op(Embedding, sparse_input)
    sparse = array_reshape_op(sparse, (-1, 26 * embedding_size))
    x = concat_op(sparse, dense_input, axis=1)

    input_dim = 26 * embedding_size + 13
    for i in range(num_layers):
        x = _residual_layer(x, input_dim, input_dim, f"residual{i}")

    W = init.random_normal((input_dim, 1), stddev=0.1, name="dc_out_weight")
    y = sigmoid_op(matmul_op(x, W))
    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    train_op = _sgd(lr).minimize(loss)
    return loss, y, y_, train_op
