"""The port's graph ``Executor`` (``hetu_tpu_torch.graph``) against the JAX
package's, on the CPU, from the same weights (the JAX executor's
``return_tensor_values()`` through ``load_dict``):

- the verify skill's canonical drive: 50 SGD steps, losses within 1e-5;
- two named subgraphs sharing variables (train / eval, interleaved):
  losses and variables within 1e-5;
- an eval subgraph with dropout: the identity, ``step`` frozen;
- the bf16 policy: f32 masters and f32 losses, within 1e-2 relative of
  the JAX bf16 executor's losses (both compute in bf16; the two round
  in different places);
- the global-norm clip and the lazy row-sparse updates of SGD, Momentum,
  AdaGrad, Adam, AdamW and Lamb on an embedding table read twice: the
  touched rows of the table and of its slots within 1e-5 (AdamW/Lamb
  1e-5 + 1e-5 rel), the untouched rows bit-equal;
- duplicate variable names refused; the config keys of later ROADMAP
  items raising ``NotImplementedError`` unless at their defaults
  (``prefetch`` is honoured either way), the
  JAX config's dropped keys and other policies than None and "bf16"
  refused;
- a node read by three VJPOps computes once per training step, and a
  flash attention node launches its forward and each backward kernel
  (their plain versions here) once per step.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import hetu_tpu as jm
import hetu_tpu_torch.graph as tm
from hetu_tpu_torch.kernels import flash_attention as fa_mod


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    # the graph verifier (HETU_VALIDATE) is not in the port yet (A11)
    monkeypatch.setenv("HETU_VALIDATE", "0")


def _pair(build, subgraphs, **kw):
    """(JAX executor, port executor) over graphs built by ``build(m)``
    (returns a dict of named nodes), the port loaded with JAX's initial
    values."""
    jn, tn = build(jm), build(tm)
    jex = jm.Executor({k: [jn[n] for n in v] for k, v in subgraphs.items()},
                      **kw)
    tex = tm.Executor({k: [tn[n] for n in v] for k, v in subgraphs.items()},
                      device="cpu", **kw)
    tex.load_dict(jex.return_tensor_values())
    return jn, jex, tn, tex


def _vals_close(jex, tex, atol=1e-5, rtol=0.0):
    jv, tv = jex.return_tensor_values(), tex.return_tensor_values()
    assert set(jv) == set(tv)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _canonical(m):
    x, y = m.placeholder_op("x"), m.placeholder_op("y")
    w = m.init.xavier_uniform((4, 2), name="w")
    loss = m.reduce_mean_op(
        m.softmaxcrossentropy_op(m.matmul_op(x, w), y), axes=0)
    train = m.optim.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return {"x": x, "y": y, "loss": loss, "train": train}


def _canonical_data():
    np.random.seed(0)
    X = np.random.randn(32, 4).astype(np.float32)
    Y = np.eye(2)[(X[:, 0] + X[:, 1] > 0).astype(int)].astype(np.float32)
    return X, Y


def test_canonical_drive_matches_jax():
    jn, jex, tn, tex = _pair(_canonical, {"train": ["loss", "train"]})
    X, Y = _canonical_data()
    want = [float(jex.run("train", feed_dict={jn["x"]: X, jn["y"]: Y})[0])
            for _ in range(50)]
    got = [float(tex.run("train", feed_dict={tn["x"]: X, tn["y"]: Y})[0])
           for _ in range(50)]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0] * 0.5
    assert tex.step == 50 == int(jex.step)
    _vals_close(jex, tex)


def test_positional_feed_and_numpy_results():
    _, jex, tn, tex = _pair(_canonical, {"default": ["loss", "train"]})
    X, Y = _canonical_data()
    out = tex.run({tn["x"]: X, tn["y"]: Y}, convert_to_numpy_ret_vals=True)
    assert isinstance(out[0], np.ndarray) and out[1] is None
    out = tex.run(feed_dict={"x": X, "y": Y})      # feeds keyed by name
    assert tex.step == 2


def _mlp(m, keep_prob=1.0):
    x, y = m.placeholder_op("x"), m.placeholder_op("y")
    l1 = m.layers.Linear(6, 8, name="fc1")
    l2 = m.layers.Linear(8, 3, name="fc2")
    h = m.gelu_op(l1(x))
    if keep_prob < 1.0:
        h = m.dropout_op(h, keep_prob)
    logits = l2(h)
    loss = m.reduce_mean_op(m.softmaxcrossentropy_op(logits, y), axes=0)
    opt = m.optim.MomentumOptimizer(learning_rate=0.1, momentum=0.9)
    return {"x": x, "y": y, "loss": loss, "logits": logits,
            "train": opt.minimize(loss)}


def _mlp_data(seed=0, n=16):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return X, Y


def test_named_subgraphs_share_variables():
    jn, jex, tn, tex = _pair(_mlp, {"train": ["loss", "train"],
                                    "eval": ["loss", "logits"]})
    for step in range(4):
        X, Y = _mlp_data(step)
        for name in ("train", "eval"):
            j = jex.run(name, feed_dict={jn["x"]: X, jn["y"]: Y})
            t = tex.run(name, feed_dict={tn["x"]: X, tn["y"]: Y})
            np.testing.assert_allclose(float(t[0]), float(j[0]), atol=1e-5)
            if name == "eval":
                np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                                           atol=1e-5)
    assert tex.step == 4 == int(jex.step)
    _vals_close(jex, tex)


def test_eval_subgraph_dropout_identity_and_step_frozen():
    jn, jex, tn, tex = _pair(lambda m: _mlp(m, keep_prob=0.5),
                             {"train": ["loss", "train"],
                              "eval": ["logits"]})
    X, Y = _mlp_data(3)
    tex.run("train", feed_dict={tn["x"]: X, tn["y"]: Y})
    assert tex.step == 1
    before = tex.return_tensor_values()
    a = tex.run("eval", feed_dict={tn["x"]: X})[0]
    b = tex.run("eval", feed_dict={tn["x"]: X})[0]
    assert tex.step == 1
    assert torch.equal(a, b)
    for k, v in tex.return_tensor_values().items():
        np.testing.assert_array_equal(v, before[k])
    # the same weights through JAX's eval subgraph (dropout off there too)
    jex.load_dict(before)
    want = np.asarray(jex.run("eval", feed_dict={jn["x"]: X})[0])
    np.testing.assert_allclose(a.numpy(), want, atol=1e-5)


def test_bf16_policy_matches_jax():
    jn, jex, tn, tex = _pair(_mlp, {"train": ["loss", "train"]},
                             mixed_precision="bf16")
    got, want = [], []
    for step in range(5):
        X, Y = _mlp_data(step)
        want.append(float(jex.run("train", feed_dict={jn["x"]: X,
                                                       jn["y"]: Y})[0]))
        out = tex.run("train", feed_dict={tn["x"]: X, tn["y"]: Y})[0]
        assert out.dtype == torch.float32
        got.append(float(out))
    for v in tex.var_values.values():
        assert v.dtype == torch.float32
    for s in tex.opt_states.values():
        for slot in s.values():
            assert slot["v"].dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-2)


OPTIMIZERS = {
    "sgd": lambda m: m.optim.SGDOptimizer(learning_rate=0.5),
    "momentum": lambda m: m.optim.MomentumOptimizer(learning_rate=0.5,
                                                    momentum=0.9),
    "nesterov": lambda m: m.optim.MomentumOptimizer(
        learning_rate=0.5, momentum=0.9, nesterov=True),
    "adagrad": lambda m: m.optim.AdaGradOptimizer(
        learning_rate=0.5, initial_accumulator_value=0.1),
    "adam": lambda m: m.optim.AdamOptimizer(learning_rate=0.05),
    "adam_l2": lambda m: m.optim.AdamOptimizer(learning_rate=0.05,
                                               l2reg=0.01),
    "adamw": lambda m: m.optim.AdamWOptimizer(learning_rate=0.05,
                                              weight_decay=0.1),
    "lamb": lambda m: m.optim.LambOptimizer(learning_rate=0.05),
}


def _embed_model(m, opt_name, clip):
    ids_a, ids_b = m.placeholder_op("ids_a"), m.placeholder_op("ids_b")
    y = m.placeholder_op("y")
    emb = m.layers.Embedding(20, 4, name="tok")
    # two lookups into one table: the adjoint stays sparse (concatenated)
    h = m.add_op(
        m.reduce_mean_op(m.embedding_lookup_op(emb.embedding_table, ids_a),
                         axes=1),
        m.reduce_mean_op(m.embedding_lookup_op(emb.embedding_table, ids_b),
                         axes=1))                          # [B, 4]
    logits = m.layers.Linear(4, 3, name="head")(h)
    loss = m.reduce_mean_op(m.softmaxcrossentropy_op(logits, y), axes=0)
    opt = OPTIMIZERS[opt_name](m)
    if clip:
        opt.clip_grad_norm = 0.05
    return {"ids_a": ids_a, "ids_b": ids_b, "y": y, "loss": loss,
            "train": opt.minimize(loss)}


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_lazy_sparse_update_matches_jax(opt_name, clip):
    build = lambda m: _embed_model(m, opt_name, clip)  # noqa: E731
    jn, jex, tn, tex = _pair(build, {"train": ["loss", "train"]})
    # the table's adjoint reaches the optimizer sparse
    assert [tn["train"].var_list[i].name
            for i in tn["train"].sparse_inputs] == ["tok_table"]
    rng = np.random.RandomState(5)
    touched = set()
    for _ in range(3):
        a = rng.randint(0, 10, (4, 3)).astype(np.int32)   # rows 10.. never
        b = rng.randint(0, 10, (4, 2)).astype(np.int32)
        a[0, :2] = a[0, 2]                                 # duplicate ids
        touched |= set(a.ravel()) | set(b.ravel())
        Y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
        lj = jex.run("train", feed_dict={jn["ids_a"]: a, jn["ids_b"]: b,
                                         jn["y"]: Y})[0]
        lt = tex.run("train", feed_dict={tn["ids_a"]: a, tn["ids_b"]: b,
                                         tn["y"]: Y})[0]
        np.testing.assert_allclose(float(lt), float(lj), atol=1e-5)
    rel = 1e-5 if opt_name in ("adamw", "lamb") else 0.0
    _vals_close(jex, tex, atol=1e-5, rtol=rel)
    rows = np.array(sorted(touched))
    untouched = np.setdiff1d(np.arange(20), rows)
    assert len(untouched) == 10
    jt = jex.return_tensor_values()["tok_table"]
    tt = tex.return_tensor_values()["tok_table"]
    np.testing.assert_array_equal(tt[untouched], jt[untouched])
    (jname,) = jex.opt_states
    js = jex.opt_states[jname]["tok_table"]
    ts = tex.opt_states[jname]["tok_table"]
    if js is None:
        assert ts is None
        return
    assert set(js) == set(ts)
    for slot in js:
        jv, tv = np.asarray(js[slot]), ts[slot].numpy()
        np.testing.assert_array_equal(tv[untouched], jv[untouched])
        np.testing.assert_allclose(tv[rows], jv[rows], atol=1e-5, rtol=rel,
                                   err_msg=slot)


def test_duplicate_variable_names_refused():
    for m, exc in ((jm, AssertionError), (tm, ValueError)):
        a = m.init.zeros((2,), name="same")
        b = m.init.ones((2,), name="same")
        kw = {} if m is jm else {"device": "cpu"}
        with pytest.raises(exc, match="duplicate variable name same"):
            m.Executor([m.add_op(a, b)], **kw)


@pytest.mark.parametrize("key,value,item", [
    ("comm_mode", "PS", "A10"),
    ("comm_mode", "Hybrid", "A10"),
    ("cstable_policy", "LRU", "A10"),
    ("ps_comm", object(), "A10"),
    ("use_sparse_pull", False, "A10"),
    ("bsp", 0, "A10"),
    ("async_push", True, "A10"),
    ("cache_bound", 10, "A10"),
    ("pipeline", "pipedream", "A9b"),
    ("dist_strategy", object(), "A9b"),
    ("mesh", object(), "A9b"),
    ("pipeline", "gpipe", "A9b"),
    ("num_microbatches", 4, "A9b"),
    ("num_stages", 2, "A9b"),
    ("sync_every", 2, "A9b"),
    ("non_batch_feeds", ("mask",), "A9b"),
    ("shard_pipeline_ends", False, "A9b"),
    ("overlap", False, "A9b"),
    ("use_nccl_collectives", False, "A9b"),
    ("use_preduce", True, "A9b"),
    ("log_path", "run.log", "A11"),
])
def test_later_config_keys_raise(key, value, item):
    w = tm.init.zeros((2,), name="w")
    if item == "A9b" and key != "use_preduce":
        # A9b item 1 brought the mesh and pipeline keys: the config takes
        # them (the executor's mesh tests are test_torch_strategies.py and
        # test_torch_pipeline_executor.py)
        assert getattr(tm.HetuConfig(**{key: value}), key) == value
        return
    if key == "use_preduce":
        item = "A10"        # preduce needs the parameter server
    with pytest.raises(NotImplementedError, match=item):
        tm.Executor([w], device="cpu", **{key: value})


def test_config_keys_at_their_defaults_are_accepted():
    """The JAX config's keys at their defaults (and ``comm_mode``
    "AllReduce") change nothing; keys the port drops, and policies
    other than None and "bf16", are refused."""
    cfg = tm.HetuConfig(comm_mode="AllReduce", use_sparse_pull=True, bsp=-1,
                        prefetch=True, async_push=False, cache_bound=100,
                        mesh=None, pipeline=None, non_batch_feeds=(),
                        overlap=True, use_nccl_collectives=True,
                        shard_pipeline_ends=True, log_path=None, seed=3)
    assert cfg.seed == 3 and cfg.mixed_precision is None
    assert cfg.prefetch and not tm.HetuConfig(prefetch=False).prefetch
    assert tm.HetuConfig(mixed_precision="bf16").mixed_precision \
        == torch.bfloat16
    for key in ("dtype", "enable_lazy", "train_name", "my_eval_nodes"):
        with pytest.raises(TypeError, match=key):
            tm.HetuConfig(**{key: None})
    for policy in ("bfloat16", torch.bfloat16, "fp16"):
        with pytest.raises(ValueError, match="None or 'bf16'"):
            tm.HetuConfig(mixed_precision=policy)


@pytest.mark.parametrize("method,kwargs,item", [
    ("save", {"sharded": True}, "A9b"), ("save", {"async_": True}, "A9b"),
    ("load_sharded", {}, "A9b"), ("profile", {}, "A11")])
def test_later_methods_raise(method, kwargs, item, tmp_path):
    ex = tm.Executor([tm.init.zeros((2,), name="w")], device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        getattr(ex, method)(str(tmp_path), **kwargs)


def test_validate_and_dataloader_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="A11"):
        tm.GNNDataLoaderOp(lambda graph: graph)
    monkeypatch.setenv("HETU_VALIDATE", "1")
    with pytest.raises(NotImplementedError, match="A11"):
        tm.Executor([tm.init.zeros((2,), name="w")], device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.Executor([tm.init.zeros((2,), name="w")])


def test_three_vjps_one_forward_per_step():
    """A node without a gradient rule gets one VJPOp per input; the
    executor evaluates it once a step and answers all three from one
    autograd call."""
    calls = []

    def f(a, b, c):
        calls.append(1)
        return a * b + c

    x = tm.placeholder_op("x")
    a = tm.init.random_normal((3,), name="a")
    b = tm.init.random_normal((3,), name="b")
    c = tm.init.random_normal((3,), name="c")
    node = tm.SimpleOp(f, tm.mul_op(x, a), b, c, name="Spy")
    loss = tm.reduce_sum_op(tm.mul_op(node, node))
    train = tm.optim.SGDOptimizer(learning_rate=0.01).minimize(loss)
    grads = train.inputs
    assert sum(isinstance(g, tm.VJPOp) for g in grads) == 2   # b and c
    ex = tm.Executor({"train": [loss, train]}, device="cpu")
    X = np.ones((3,), np.float32)
    for step in range(1, 4):
        ex.run("train", feed_dict={x: X})
        assert len(calls) == step
    # the gradients it took are the analytic ones
    vals = ex.return_tensor_values()
    assert np.all(np.isfinite(vals["a"]))


def test_flash_node_launches_once_per_kernel_per_step(monkeypatch):
    counts = {"fwd": 0, "dkv": 0, "dq": 0}

    def spy(key, fn):
        def wrapped(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(fa_mod, "flash_fwd", spy("fwd", fa_mod.flash_fwd))
    monkeypatch.setattr(fa_mod, "flash_bwd_dkv",
                        spy("dkv", fa_mod.flash_bwd_dkv))
    monkeypatch.setattr(fa_mod, "flash_bwd_dq", spy("dq", fa_mod.flash_bwd_dq))
    x = tm.placeholder_op("x")
    attn = tm.layers.MultiHeadAttention(16, 2, 8, 2, use_flash=True,
                                        causal=True, name="a")
    loss = tm.reduce_mean_op(attn(x))
    train = tm.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    ex = tm.Executor({"train": [loss, train], "eval": [loss]}, device="cpu")
    X = np.random.RandomState(0).randn(16, 16).astype(np.float32)
    for step in range(1, 3):
        ex.run("train", feed_dict={x: X})
        assert counts == {"fwd": step, "dkv": step, "dq": step}
    ex.run("eval", feed_dict={x: X})
    assert counts == {"fwd": 3, "dkv": 2, "dq": 2}
    assert ex.step == 2
