"""CNN-family models on the graph surface: the port of the JAX package's
``models/cnn.py``.

Every model function has the signature ``model(x, y_) -> (loss, y)``, where
``x`` is a placeholder of shape (N, C, H, W) (or (N, dims) for the dense
models) and ``y_`` one-hot labels (N, num_classes).  Convolutions are
NCHW; batch norm keeps running statistics (``ops_conv``).
"""

from __future__ import annotations

import numpy as np

from ..graph import (
    matmul_op, broadcastto_op, relu_op, tanh_op, sigmoid_op, conv2d_op,
    max_pool2d_op, avg_pool2d_op, batch_normalization_op, array_reshape_op,
    softmaxcrossentropy_op, reduce_mean_op, slice_op, concat_op, mul_op,
)
from ..graph import init
from ..graph.ops_misc import Variable


def fc(x, shape, name, with_relu=True, stddev=0.1):
    """Dense layer helper (reference MLP.py:5-12)."""
    weight = init.random_normal(shape=shape, stddev=stddev,
                                name=name + "_weight")
    bias = init.random_normal(shape=shape[-1:], stddev=stddev,
                              name=name + "_bias")
    x = matmul_op(x, weight)
    x = x + broadcastto_op(bias, x)
    if with_relu:
        x = relu_op(x)
    return x


def _conv2d(x, in_ch, out_ch, kernel_size=3, stride=1, padding=1, name=""):
    weight = init.he_normal(shape=(out_ch, in_ch, kernel_size, kernel_size),
                            name=name + "_weight")
    return conv2d_op(x, weight, stride=stride, padding=padding)


def _bn(x, hidden, name, with_relu=False):
    scale = init.ones(shape=(hidden,), name=name + "_scale")
    bias = init.zeros(shape=(hidden,), name=name + "_bias")
    x = batch_normalization_op(x, scale, bias, momentum=0.9, eps=1e-5)
    return relu_op(x) if with_relu else x


def _loss_and_pred(y, y_):
    loss = softmaxcrossentropy_op(y, y_)
    loss = reduce_mean_op(loss, [0])
    return loss, y


# ---------------------------------------------------------------- dense


def mlp(x, y_):
    """3-layer MLP for MNIST (reference MLP.py:15-36)."""
    x = fc(x, (784, 256), "mlp_fc1")
    x = fc(x, (256, 256), "mlp_fc2")
    y = fc(x, (256, 10), "mlp_fc3", with_relu=False)
    return _loss_and_pred(y, y_)


def logreg(x, y_):
    """Logistic regression (reference LogReg.py)."""
    weight = init.zeros((784, 10), name="logreg_weight")
    bias = init.zeros((10,), name="logreg_bias")
    y = matmul_op(x, weight)
    y = y + broadcastto_op(bias, y)
    return _loss_and_pred(y, y_)


# ---------------------------------------------------------------- convnets


def cnn_3_layers(x, y_):
    """3-conv-layer net for MNIST (reference CNN.py)."""
    x = array_reshape_op(x, [-1, 1, 28, 28])
    x = relu_op(_conv2d(x, 1, 32, kernel_size=5, padding=2, name="cnn_conv1"))
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = relu_op(_conv2d(x, 32, 64, kernel_size=5, padding=2,
                        name="cnn_conv2"))
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, [-1, 7 * 7 * 64])
    y = fc(x, (7 * 7 * 64, 10), "cnn_fc", with_relu=False)
    return _loss_and_pred(y, y_)


def lenet(x, y_):
    """LeNet-5 for MNIST (reference LeNet.py)."""
    x = array_reshape_op(x, [-1, 1, 28, 28])
    x = tanh_op(_conv2d(x, 1, 6, kernel_size=5, padding=2,
                        name="lenet_conv1"))
    x = avg_pool2d_op(x, 2, 2, stride=2)
    x = tanh_op(_conv2d(x, 6, 16, kernel_size=5, padding=0,
                        name="lenet_conv2"))
    x = avg_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, [-1, 16 * 5 * 5])
    x = fc(x, (16 * 5 * 5, 120), "lenet_fc1")
    x = fc(x, (120, 84), "lenet_fc2")
    y = fc(x, (84, 10), "lenet_fc3", with_relu=False)
    return _loss_and_pred(y, y_)


def alexnet(x, y_, num_class=10):
    """CIFAR-sized AlexNet (reference AlexNet.py)."""
    x = relu_op(_bn(_conv2d(x, 3, 64, kernel_size=3, stride=1, padding=1,
                            name="alex_conv1"), 64, "alex_bn1"))
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = relu_op(_bn(_conv2d(x, 64, 192, kernel_size=3, padding=1,
                            name="alex_conv2"), 192, "alex_bn2"))
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = relu_op(_conv2d(x, 192, 384, kernel_size=3, padding=1,
                        name="alex_conv3"))
    x = relu_op(_conv2d(x, 384, 256, kernel_size=3, padding=1,
                        name="alex_conv4"))
    x = relu_op(_conv2d(x, 256, 256, kernel_size=3, padding=1,
                        name="alex_conv5"))
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, [-1, 256 * 4 * 4])
    x = fc(x, (256 * 4 * 4, 1024), "alex_fc1")
    x = fc(x, (1024, 512), "alex_fc2")
    y = fc(x, (512, num_class), "alex_fc3", with_relu=False)
    return _loss_and_pred(y, y_)


def _vgg_block(x, in_ch, out_ch, n_convs, name):
    for i in range(n_convs):
        x = _bn(_conv2d(x, in_ch if i == 0 else out_ch, out_ch,
                        name=f"{name}_layer{i + 1}"), out_ch,
                f"{name}_bn{i + 1}", with_relu=True)
    return max_pool2d_op(x, 2, 2, padding=0, stride=2)


def vgg(x, y_, num_layers=16, num_class=10):
    """VGG-16/19 for CIFAR (reference VGG.py)."""
    if num_layers == 16:
        plan = [2, 2, 3, 3, 3]
    elif num_layers == 19:
        plan = [2, 2, 4, 4, 4]
    else:
        raise ValueError("vgg: num_layers must be 16 or 19")
    channels = [64, 128, 256, 512, 512]
    in_ch = 3
    for i, (n_convs, out_ch) in enumerate(zip(plan, channels)):
        x = _vgg_block(x, in_ch, out_ch, n_convs, f"vgg_block{i + 1}")
        in_ch = out_ch
    x = array_reshape_op(x, [-1, 512])
    x = fc(x, (512, 4096), "vgg_fc1")
    x = fc(x, (4096, 4096), "vgg_fc2")
    y = fc(x, (4096, num_class), "vgg_fc3", with_relu=False)
    return _loss_and_pred(y, y_)


def vgg16(x, y_, num_class=10):
    return vgg(x, y_, num_layers=16, num_class=num_class)


def vgg19(x, y_, num_class=10):
    return vgg(x, y_, num_layers=19, num_class=num_class)


def _basic_block(x, in_ch, out_ch, stride, name):
    """ResNet basic block (reference ResNet.py:52-70)."""
    shortcut = x
    x = _conv2d(x, in_ch, out_ch, kernel_size=3, stride=stride, padding=1,
                name=name + "_conv33a")
    x = _bn(x, out_ch, name + "_bn1", with_relu=True)
    x = _conv2d(x, out_ch, out_ch, kernel_size=3, stride=1, padding=1,
                name=name + "_conv33b")
    x = _bn(x, out_ch, name + "_bn2")
    if in_ch != out_ch or stride > 1:
        shortcut = _conv2d(shortcut, in_ch, out_ch, kernel_size=1,
                           stride=stride, padding=0, name=name + "_conv11")
        shortcut = _bn(shortcut, out_ch, name + "_bn3")
    return relu_op(x + shortcut), out_ch


def _bottleneck(x, in_ch, ch, stride, name):
    """ResNet bottleneck block (reference ResNet.py:28-50)."""
    out_ch = 4 * ch
    shortcut = x
    x = _conv2d(x, in_ch, ch, kernel_size=1, stride=stride, padding=0,
                name=name + "_conv11a")
    x = _bn(x, ch, name + "_bn1", with_relu=True)
    x = _conv2d(x, ch, ch, kernel_size=3, stride=1, padding=1,
                name=name + "_conv33")
    x = _bn(x, ch, name + "_bn2", with_relu=True)
    x = _conv2d(x, ch, out_ch, kernel_size=1, stride=1, padding=0,
                name=name + "_conv11b")
    x = _bn(x, out_ch, name + "_bn2b")
    if in_ch != out_ch or stride > 1:
        shortcut = _conv2d(shortcut, in_ch, out_ch, kernel_size=1,
                           stride=stride, padding=0, name=name + "_conv11c")
        shortcut = _bn(shortcut, out_ch, name + "_bn3")
    return relu_op(x + shortcut), out_ch


def resnet(x, y_, num_layers=18, num_class=10):
    """ResNet for CIFAR-10 (reference ResNet.py:80-133)."""
    plans = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
             101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    if num_layers not in plans:
        raise ValueError(f"resnet: unsupported depth {num_layers}")
    layers = plans[num_layers]
    block = _bottleneck if num_layers > 34 else _basic_block
    channels = [16, 32, 64, 128]

    cur = 16
    x = _conv2d(x, 3, cur, kernel_size=3, stride=1, padding=1,
                name="resnet_initial_conv")
    x = _bn(x, cur, "resnet_initial_bn", with_relu=True)
    for i, n_blocks in enumerate(layers):
        for k in range(n_blocks):
            stride = 2 if k == 0 and i > 0 else 1
            x, cur = block(x, cur, channels[i], stride,
                           f"resnet_block_{i}_{k}")
    x = reduce_mean_op(x, [2, 3])
    y = fc(x, (cur, num_class), "resnet_final_fc", with_relu=False)
    return _loss_and_pred(y, y_)


def resnet18(x, y_, num_class=10):
    return resnet(x, y_, num_layers=18, num_class=num_class)


def resnet34(x, y_, num_class=10):
    return resnet(x, y_, num_layers=34, num_class=num_class)


def resnet50(x, y_, num_class=10):
    return resnet(x, y_, num_layers=50, num_class=num_class)


def resnet101(x, y_, num_class=10):
    return resnet(x, y_, num_layers=101, num_class=num_class)


def resnet152(x, y_, num_class=10):
    return resnet(x, y_, num_layers=152, num_class=num_class)


# ---------------------------------------------------------------- recurrent
#
# 28 timesteps unrolled at graph-build time, as the reference's RNN.py
# and LSTM.py build them.


def rnn(x, y_, diminput=28, dimhidden=128, dimoutput=10, nsteps=28):
    """Unrolled vanilla RNN for MNIST rows (reference RNN.py)."""
    w_in = init.random_normal((diminput, dimhidden), stddev=0.1,
                              name="rnn_weight1")
    b_in = init.random_normal((dimhidden,), stddev=0.1, name="rnn_bias1")
    w_h = init.random_normal((dimhidden + dimhidden, dimhidden), stddev=0.1,
                             name="rnn_weight2")
    b_h = init.random_normal((dimhidden,), stddev=0.1, name="rnn_bias2")
    w_out = init.random_normal((dimhidden, dimoutput), stddev=0.1,
                               name="rnn_weight3")
    b_out = init.random_normal((dimoutput,), stddev=0.1, name="rnn_bias3")

    last_state = Variable("rnn_initial_state",
                          value=np.zeros((1,), dtype=np.float32),
                          trainable=False)
    for i in range(nsteps):
        cur_x = slice_op(x, (0, i * diminput), (-1, diminput))
        h = matmul_op(cur_x, w_in)
        h = h + broadcastto_op(b_in, h)
        if i == 0:
            last_state = broadcastto_op(last_state, h)
        s = concat_op(h, last_state, axis=1)
        s = matmul_op(s, w_h)
        s = s + broadcastto_op(b_h, s)
        last_state = relu_op(s)
    y = matmul_op(last_state, w_out)
    y = y + broadcastto_op(b_out, y)
    return _loss_and_pred(y, y_)


def lstm(x, y_, diminput=28, dimhidden=128, dimoutput=10, nsteps=28):
    """Unrolled LSTM for MNIST rows (reference LSTM.py)."""
    def gate_params(gname):
        w = init.random_normal((diminput, dimhidden), stddev=0.1,
                               name=f"lstm_{gname}_w")
        u = init.random_normal((dimhidden, dimhidden), stddev=0.1,
                               name=f"lstm_{gname}_u")
        b = init.random_normal((dimhidden,), stddev=0.1,
                               name=f"lstm_{gname}_b")
        return w, u, b

    fw, fu, fb = gate_params("forget_gate")
    iw, iu, ib = gate_params("input_gate")
    ow, ou, ob = gate_params("output_gate")
    cw, cu, cb = gate_params("cell")
    w_out = init.random_normal((dimhidden, dimoutput), stddev=0.1,
                               name="lstm_out_w")
    b_out = init.random_normal((dimoutput,), stddev=0.1, name="lstm_out_b")

    h = c = None
    for i in range(nsteps):
        cur_x = slice_op(x, (0, i * diminput), (-1, diminput))

        def gate(w, u, b, act):
            pre = matmul_op(cur_x, w)
            if h is not None:
                pre = pre + matmul_op(h, u)
            pre = pre + broadcastto_op(b, pre)
            return act(pre)

        f_g = gate(fw, fu, fb, sigmoid_op)
        i_g = gate(iw, iu, ib, sigmoid_op)
        o_g = gate(ow, ou, ob, sigmoid_op)
        c_tilde = gate(cw, cu, cb, tanh_op)
        c = mul_op(i_g, c_tilde) if c is None \
            else mul_op(f_g, c) + mul_op(i_g, c_tilde)
        h = mul_op(o_g, tanh_op(c))
    y = matmul_op(h, w_out)
    y = y + broadcastto_op(b_out, y)
    return _loss_and_pred(y, y_)
