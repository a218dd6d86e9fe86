"""The rest of the model zoo on the port's graph surface
(``hetu_tpu_torch.models``: ``cnn``, ``transformer``, ``ctr``, ``ncf``)
against the JAX package's, on the CPU, at small sizes, both from the
port executor's initial values (the JAX graph's variables are given
them as values).

One parametrised test per family; each case trains three steps with the
model's own optimizer (the CNNs and the Transformer with the one their
JAX test uses) and holds the losses within 1e-5 relative and every
variable within 1e-5 + 1e-5 relative, batch-norm running statistics
among them.  The deep CNN variants the JAX tests only build (ResNet-34
to 152, VGG-16/19) are held to JAX's variable names and shapes.  Last,
``hetu_tpu_torch.models`` exports every name of the JAX package's
``models/__init__.py``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

import hetu_tpu as jm
import hetu_tpu.graph as jgraph
from hetu_tpu import models as jmodels
import hetu_tpu_torch.graph as tm
from hetu_tpu_torch import models as tmodels

REPO = Path(__file__).resolve().parents[1]
PKG = {"jax": (jm, jmodels), "torch": (tm, tmodels)}


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    # the graph verifier (HETU_VALIDATE) is not in the port yet (A11)
    monkeypatch.setenv("HETU_VALIDATE", "0")


def _onehot(labels, n):
    return np.eye(n, dtype=np.float32)[labels]


def seed_jax_variables(nodes, values):
    """Give every variable of the JAX graph over ``nodes`` its value in
    ``values`` (by name): the JAX executor then draws nothing, where its
    initializers compile once per shape (16 s of ResNet-18's 22 s)."""
    topo = jgraph.find_topo_sort(nodes)
    for n in list(topo):
        topo += list(getattr(n, "state_vars", []))
    for n in topo:
        if isinstance(n, jgraph.PlaceholderOp) and n.is_variable:
            n.tensor_value = np.asarray(values[n.name])
            n.initializer = None


def _train_pair(build, arrays, steps=3):
    """``build(key) -> (placeholders by name, loss, train op)``; three
    steps in both packages from the port executor's initial values.
    Returns {key: (losses, variables)}."""
    out, init = {}, None
    for key in ("torch", "jax"):
        phs, loss, train = build(key)
        if key == "torch":
            ex = tm.Executor({"train": [loss, train]}, device="cpu")
            init = ex.return_tensor_values()
        else:
            seed_jax_variables([loss, train], init)
            ex = jm.Executor({"train": [loss, train]})
        feeds = {p: arrays[n] for n, p in phs.items()}
        losses = [float(np.asarray(ex.run("train", feed_dict=feeds)[0])
                        .reshape(-1)[0]) for _ in range(steps)]
        out[key] = (losses, ex.return_tensor_values())
    return out


def _assert_same(out):
    (tl, tv), (jl, jv) = out["torch"], out["jax"]
    assert all(np.isfinite(tl)), tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    return tv


# ----------------------------------------------------------------------- #
# the CNN family
# ----------------------------------------------------------------------- #

# (model function, its keyword arguments, input shape, SGD learning rate); the
# recurrent nets at 4 steps of 16 hidden units (28 x 128 by default)
CNN_CASES = {
    "mlp": ("mlp", {}, (4, 784), 0.1),
    "logreg": ("logreg", {}, (4, 784), 0.1),
    "rnn": ("rnn", dict(dimhidden=16, nsteps=4), (4, 4 * 28), 0.1),
    "lstm": ("lstm", dict(dimhidden=16, nsteps=4), (4, 4 * 28), 0.1),
    "cnn_3_layers": ("cnn_3_layers", {}, (2, 784), 0.01),
    "lenet": ("lenet", {}, (2, 784), 0.01),
    "resnet18": ("resnet18", {}, (2, 3, 32, 32), 0.01),
    "alexnet": ("alexnet", {}, (2, 3, 32, 32), 1e-4),
}


@pytest.mark.parametrize("case", sorted(CNN_CASES))
def test_cnn_three_sgd_steps_match_jax(case):
    fn, kw, shape, lr = CNN_CASES[case]
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(*shape).astype(np.float32) * 0.1,
              "y_": _onehot(rng.randint(0, 10, shape[0]), 10)}

    def build(key):
        m, models = PKG[key]
        x, y = m.placeholder_op("x"), m.placeholder_op("y_")
        loss, _ = getattr(models, fn)(x, y, **kw)
        return {"x": x, "y_": y}, loss, \
            m.optim.SGDOptimizer(learning_rate=lr).minimize(loss)

    tv = _assert_same(_train_pair(build, arrays))
    if case in ("resnet18", "alexnet"):
        stats = [k for k in tv if "running" in k or "moving" in k
                 or k.endswith("_mean") or k.endswith("_var")]
        assert stats, sorted(tv)


def _variables(key, fn):
    m, models = PKG[key]
    graph = jgraph if key == "jax" else tm
    x, y = m.placeholder_op("x"), m.placeholder_op("y_")
    loss, _ = getattr(models, fn)(x, y)
    topo = graph.find_topo_sort([loss])
    for n in list(topo):
        topo += list(getattr(n, "state_vars", []))
    return {n.name: tuple(n.shape) for n in topo
            if isinstance(n, graph.PlaceholderOp) and n.is_variable}


@pytest.mark.parametrize("fn", ["resnet34", "resnet50", "resnet101",
                                "resnet152", "vgg16", "vgg19"])
def test_deep_cnn_builds_jaxs_variables(fn):
    port, ref = _variables("torch", fn), _variables("jax", fn)
    assert port == ref and len(port) > 20


# ----------------------------------------------------------------------- #
# the MT Transformer
# ----------------------------------------------------------------------- #

def test_transformer_mt_three_adam_steps_match_jax():
    rng = np.random.RandomState(0)
    arrays = {n: rng.randint(1, 64, (2, 8)).astype(np.int32)
              for n in ("src", "tgt", "labels")}
    arrays["labels"][1, 6:] = 0              # padding id: ignored

    def build(key):
        m, models = PKG[key]
        cfg = models.TransformerConfig(
            src_vocab_size=64, tgt_vocab_size=64, hidden_size=16,
            num_layers=1, num_heads=2, ffn_size=32, dropout_rate=0.0,
            batch_size=2, src_len=8, tgt_len=8)
        phs = {n: m.placeholder_op(n) for n in ("src", "tgt", "labels")}
        loss, _ = models.transformer_mt(phs["src"], phs["tgt"],
                                        phs["labels"], config=cfg)
        return phs, loss, \
            m.optim.AdamOptimizer(learning_rate=1e-3).minimize(loss)

    _assert_same(_train_pair(build, arrays))


def test_sinusoid_table_is_jaxs():
    from hetu_tpu.models.transformer import _sinusoid_table as jtab
    from hetu_tpu_torch.models.transformer import _sinusoid_table as ttab
    np.testing.assert_array_equal(ttab(12, 16), jtab(12, 16))


# ----------------------------------------------------------------------- #
# CTR and NCF (each model function makes its own SGD optimizer)
# ----------------------------------------------------------------------- #

FEAT, EMB, BS = 1000, 8, 8


def _ctr_arrays(model):
    rng = np.random.RandomState(1)
    if model == "wdl_adult":
        a = {"x_wide": rng.randn(BS, 809).astype(np.float32),
             "y_": _onehot(rng.randint(0, 2, BS), 2)}
        for i in range(8):
            a[f"xd{i}"] = rng.randint(0, 50, (BS,)).astype(np.int32)
        for i in range(8, 12):
            a[f"xd{i}"] = rng.randn(BS).astype(np.float32)
        return a
    return {"dense": rng.randn(BS, 13).astype(np.float32),
            "sparse": rng.randint(0, FEAT, (BS, 26)).astype(np.int32),
            "y_": rng.randint(0, 2, (BS, 1)).astype(np.float32)}


@pytest.mark.parametrize("model", ["wdl_adult", "wdl_criteo", "dcn_criteo",
                                   "deepfm_criteo", "dc_criteo"])
def test_ctr_three_steps_match_jax(model):
    arrays = _ctr_arrays(model)

    def build(key):
        m, models = PKG[key]
        phs = {n: m.placeholder_op(n) for n in arrays}
        if model == "wdl_adult":
            loss, _, _, train = models.wdl_adult(
                [phs[f"xd{i}"] for i in range(12)], phs["x_wide"],
                phs["y_"])
        else:
            loss, _, _, train = getattr(models, model)(
                phs["dense"], phs["sparse"], phs["y_"],
                feature_dimension=FEAT, embedding_size=EMB)
        return phs, loss, train

    _assert_same(_train_pair(build, arrays))


def test_neural_mf_three_steps_match_jax():
    rng = np.random.RandomState(2)
    arrays = {"user": rng.randint(0, 100, (16,)).astype(np.int32),
              "item": rng.randint(0, 200, (16,)).astype(np.int32),
              "y_": rng.randint(0, 2, (16, 1)).astype(np.float32)}

    def build(key):
        m, models = PKG[key]
        phs = {n: m.placeholder_op(n) for n in arrays}
        loss, _, train = models.neural_mf(phs["user"], phs["item"],
                                          phs["y_"], num_users=100,
                                          num_items=200, lr=0.5)
        return phs, loss, train

    _assert_same(_train_pair(build, arrays))


def test_models_export_every_jax_name():
    tree = ast.parse((REPO / "hetu_tpu" / "models" /
                      "__init__.py").read_text())
    names = [a.asname or a.name for n in tree.body
             if isinstance(n, ast.ImportFrom) for a in n.names]
    assert len(names) > 40
    missing = [n for n in names if not hasattr(tmodels, n)]
    assert not missing, missing
    # expert parallelism is ported (held to JAX in
    # tests/test_torch_expert_parallel.py): a call with no mesh is
    # refused by the shard check, not as a missing module
    assert tmodels.resolve_moe_quant("int8") == "int8"
    from hetu_tpu_torch.analysis.integration import ShardCheckError
    with pytest.raises(ShardCheckError, match="needs a mesh"):
        tmodels.ep_shard_params({}, None,
                                tmodels.MoEDecodeConfig(num_hidden_layers=2))
