"""GCN node classification on the graph surface, the port of the JAX
package's ``examples/gnn/train_gcn.py``.

Two stacked graph-convolution layers built from ``distgcn_15d_op``
(Z = (A @ H) @ W), trained with Adam on the nodes of a random half of
the graph (the loss masked to them) and scored on the other half.  With
``--mesh`` (e.g. ``dp2xtp2``) the executor runs over that mesh
(``parallel.make_mesh``); its whole-value view computes the dense layer,
and the per-rank view of the same op runs the 1.5-D partition (rows of
A over ``dp``, its columns and H's rows over ``tp``, one all-reduce over
``tp``).

Data: a two-community-style stochastic block model (``gnn_common``),
labels = community, learnable from structure alone.  Runs on the card
unless ``--device cpu`` is given; ``main`` returns the held-out
accuracy.

    python -m hetu_tpu_torch.train_gcn --device cpu --mesh dp2xtp2
    python -m hetu_tpu_torch.train_gcn --nodes 2708 --feat-dim 1433 \\
        --hidden 16 --classes 7
"""

import argparse
import logging

import numpy as np

from . import graph as ht
from .gnn_common import parse_mesh, sbm_graph

logger = logging.getLogger("gcn")


def build_gcn(feat_dim, hidden, classes, optimizer):
    """The two-layer GCN graph: ((adj, feat, labels, mask) placeholders,
    logits, the masked mean loss, the train op of ``optimizer``)."""
    a = ht.placeholder_op("adj")
    x = ht.placeholder_op("feat")
    y = ht.placeholder_op("labels")
    m = ht.placeholder_op("mask")
    w1 = ht.init.xavier_uniform((feat_dim, hidden), name="gcn_w1")
    w2 = ht.init.xavier_uniform((hidden, classes), name="gcn_w2")
    h = ht.relu_op(ht.distgcn_15d_op(a, x, w1))
    logits = ht.distgcn_15d_op(a, h, w2)
    per_node = ht.softmaxcrossentropy_sparse_op(logits, y)
    # semi-supervised: only train-mask nodes contribute to the loss;
    # held-out nodes are classified purely through graph propagation
    masked = ht.mul_op(per_node, m)
    loss = ht.div_op(ht.reduce_sum_op(masked, [0]),
                     ht.reduce_sum_op(m, [0]))
    return (a, x, y, m), logits, loss, optimizer.minimize(loss)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nodes", type=int, default=256)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--feat-dim", type=int, default=16)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--learning-rate", type=float, default=0.2)
    p.add_argument("--mesh", default=None,
                   help="e.g. dp4xtp2: the 1.5-D partition's axes")
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default)")
    return p.parse_args(argv)


def run(argv=None):
    """Train as the flags say; returns {"losses": per epoch,
    "accuracy": held-out, "executor", "data": the arrays fed (adj, feat,
    labels, mask)}."""
    args = parse_args(argv)
    mesh = parse_mesh(args.mesh, logger, device=args.device)
    adj, feat, labels = sbm_graph(args.nodes, args.classes, 0.2, 0.01,
                                  args.feat_dim)
    train_mask = np.zeros(args.nodes, bool)
    train_mask[np.random.RandomState(1).choice(
        args.nodes, args.nodes // 2, replace=False)] = True

    (a, x, y, m), logits, loss, train = build_gcn(
        args.feat_dim, args.hidden, args.classes,
        ht.optim.AdamOptimizer(learning_rate=args.learning_rate))
    ex = ht.Executor({"train": [loss, train], "eval": [logits]},
                     mesh=mesh, device=args.device)

    feed = {a: adj, x: feat, y: labels, m: train_mask.astype(np.float32)}

    def accuracy():
        lg = np.asarray(ex.run("eval", feed_dict=feed,
                               convert_to_numpy_ret_vals=True)[0])
        return (lg.argmax(-1) == labels)[~train_mask].mean()

    losses = []
    for epoch in range(args.epochs):
        out = ex.run("train", feed_dict=feed, convert_to_numpy_ret_vals=True)
        losses.append(float(np.asarray(out[0])))
        if (epoch + 1) % 20 == 0:
            logger.info("epoch %d loss %.4f held-out acc %.3f",
                        epoch + 1, losses[-1], accuracy())
    acc = accuracy()
    logger.info("final held-out accuracy %.3f", acc)
    data = dict(zip(("adj", "feat", "labels", "mask"),
                    (feed[n] for n in (a, x, y, m))))
    return dict(losses=losses, accuracy=acc, executor=ex, data=data)


def main(argv=None):
    return run(argv)["accuracy"]


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
