"""Shared helpers of the GNN entry points, the port of the JAX package's
``examples/gnn/gnn_common.py``: the stochastic block model graph and the
``--mesh`` parser."""

import numpy as np


def sbm_graph(n, n_classes, p_in, p_out, feat_dim=None, seed=0):
    """Stochastic block model: dense intra-community edges, labels =
    community.  Returns (row-normalized adj, features-or-None, labels);
    features (when ``feat_dim``) are noisy community one-hot-ish."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, n)
    same = labels[:, None] == labels[None, :]
    adj = (rng.rand(n, n) < np.where(same, p_in, p_out)).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 1.0)              # self loops
    adj /= adj.sum(1, keepdims=True)        # row-normalized
    feat = None
    if feat_dim:
        feat = rng.randn(n, feat_dim).astype(np.float32) * 0.5
        feat[np.arange(n), labels % feat_dim] += 1.0
    return adj.astype(np.float32), feat, labels.astype(np.int32)


def parse_mesh(spec, logger=None, device=None):
    """'dp4xtp2' -> ``parallel.make_mesh({"dp": 4, "tp": 2})`` (None when
    ``spec`` is falsy): a ``VirtualMesh`` on ``device`` (the card unless
    "cpu"), or a ``DeviceMesh`` under ``torch.distributed``."""
    if not spec:
        return None
    from .parallel.mesh import make_mesh
    axes = {}
    for part in spec.split("x"):
        name = part.rstrip("0123456789")
        axes[name] = int(part[len(name):])
    if logger is not None:
        logger.info("mesh %s", axes)
    return make_mesh(axes, device=device)
