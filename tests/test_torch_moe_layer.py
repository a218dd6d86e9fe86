"""The training MoE surface of the port against the JAX package's, on the
CPU: the ``graph/ops_moe.py`` factories, the gate family and
``MoELayer`` (``graph/layers/moe.py``), and the MoE models
(``models/bert_moe.py``, ``models/moe_models.py``).

- Each MoE factory's outputs and gradients on the same seeded inputs:
  floats within 1e-5 + 1e-5 relative; indices, locations and
  ``balance_assignment_op``'s permutation exactly, tied scores included.
- Each gate through ``MoELayer`` in its three forms (a list of
  ``Expert`` s, ``StackedExperts``, the balanced assignment layer), both
  from the port executor's initial values (given to the JAX graph's
  variables as values): the output within 1e-5, ``l_aux``
  within 1e-6, the gradients with respect to the input, the gate and
  the experts within 1e-5 + 1e-5 relative; one case with two gate
  columns equal, so the top-k ties.
- ``BertMoEForPreTraining`` (4 experts; top-1 with ``moe_every`` 2 and
  top-2 with ``moe_every`` 1): the losses of three AdamW steps within
  1e-5 relative and every variable within 1e-5 (k's bias 3 lr: its
  gradient is 0 and Adam turns rounding into +-lr), on the unfused
  attention under an additive mask (flash with ``kv_lens`` is held in
  ``test_torch_bert.py``); ``moe_mlp`` for every gate and
  ``moe_transformer_block``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

import hetu_tpu as jm
import hetu_tpu.graph as jgraph
import hetu_tpu.layers as jlayers
from hetu_tpu import models as jmodels
from hetu_tpu.graph import ops_moe as jmoe
from hetu_tpu.graph.node import TraceContext as JTraceContext
import hetu_tpu_torch.graph as tm
from hetu_tpu_torch import models as tmodels
from hetu_tpu_torch.graph import ops_moe as tmoe

REPO = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    # the graph verifier (HETU_VALIDATE) is not in the port yet (A11)
    monkeypatch.setenv("HETU_VALIDATE", "0")


PKG = {"jax": (jm, jmoe, jlayers, jmodels),
       "torch": (tm, tmoe, tm.layers, tmodels)}


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


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want.astype(got.dtype), atol=atol,
                               rtol=rtol, err_msg=what)


def seed_jax_variables(nodes, values):
    """Give every variable of the JAX graph over ``nodes`` its value in
    ``values`` (by name): the JAX executor then draws nothing, where its
    initializers compile once per shape."""
    topo = jgraph.find_topo_sort(nodes)
    for n in topo:
        if isinstance(n, jgraph.PlaceholderOp) and n.is_variable:
            n.tensor_value = np.asarray(values[n.name])
            n.initializer = None


# ----------------------------------------------------------------------- #
# the ops_moe factories
# ----------------------------------------------------------------------- #

N, D, E = 12, 6, 4


def _routing(rng, k, cap):
    """Top-k expert ids of N tokens (distinct per token) and their
    rank-major slot locations, as the gate makes them; some past
    ``cap``."""
    idx = np.stack([rng.permutation(E)[:k] for _ in range(N)]).astype(
        np.float32)
    loc = np.zeros((N, k), np.float32)
    count = np.zeros(E, int)
    for r in range(k):
        for t in range(N):
            e = int(idx[t, r])
            loc[t, r] = count[e]
            count[e] += 1
    assert (loc >= cap).any() and (loc < cap).any()
    return [idx[:, r] for r in range(k)], [loc[:, r] for r in range(k)]


def _op_case(name, k):
    """(build(m, mo, nodes...) -> out node, arrays, indices of the float
    inputs to differentiate)."""
    rng = np.random.RandomState(sum(map(ord, name)) + k)
    cap = 3
    idx, loc = _routing(rng, k, cap)
    x = rng.randn(N, D).astype(np.float32)
    data = rng.randn(E * cap, D).astype(np.float32)
    gates = [rng.rand(N).astype(np.float32) for _ in range(k)]
    g = rng.randn(N, D).astype(np.float32)
    if name == "layout_transform_op":
        return (lambda m, mo, x, *il: mo.layout_transform_op(
            x, list(il[:k]), list(il[k:]), cap, E)), [x] + idx + loc, [0]
    if name == "layout_transform_gradient_op":
        return (lambda m, mo, d, i, l: mo.layout_transform_gradient_op(
            d, i, l, cap)), [data, idx[0], loc[0]], []
    if name == "reverse_layout_transform_op":
        return (lambda m, mo, d, *r: mo.reverse_layout_transform_op(
            d, list(r[:k]), list(r[k:2 * k]), list(r[2 * k:]), cap, E)), \
            [data] + idx + loc + gates, [0] + list(range(1 + 2 * k,
                                                         1 + 3 * k))
    if name == "reverse_layout_transform_gradient_data_op":
        return (lambda m, mo, gg, *r:
                mo.reverse_layout_transform_gradient_data_op(
                    gg, list(r[:k]), list(r[k:2 * k]), list(r[2 * k:]),
                    cap, E)), [g] + idx + loc + gates, []
    if name == "reverse_layout_transform_gradient_gate_op":
        return (lambda m, mo, gg, d, i, l:
                mo.reverse_layout_transform_gradient_gate_op(
                    gg, d, i, l, cap)), [g, data, idx[0], loc[0]], []
    if name == "reverse_layout_transform_no_gate_op":
        return (lambda m, mo, d, *il: mo.reverse_layout_transform_no_gate_op(
            d, list(il[:k]), list(il[k:]), cap, E)), [data] + idx + loc, [0]
    if name == "alltoall_op":
        return (lambda m, mo, a: mo.alltoall_op(a)), [data], [0]
    if name == "halltoall_op":
        return (lambda m, mo, a: mo.halltoall_op(a)), [data], [0]
    if name == "sam_group_sum_op":
        return (lambda m, mo, a: mo.sam_group_sum_op(a, 2)), \
            [rng.rand(N, E).astype(np.float32)], [0]
    if name == "sam_max_op":
        a = rng.rand(N, E).astype(np.float32)
        grp = rng.randint(0, 2, (N, 1)).astype(np.float32)
        tki = (grp[:, 0] * 2 + rng.randint(0, 2, N)).astype(np.float32)
        return (lambda m, mo, a, gr, t: mo.sam_max_op(a, gr, t, 2)), \
            [a, grp, tki[:, None]], [0]
    raise ValueError(name)


FLOAT_OPS = [("layout_transform_op", 1), ("layout_transform_op", 2),
             ("layout_transform_gradient_op", 1),
             ("reverse_layout_transform_op", 1),
             ("reverse_layout_transform_op", 2),
             ("reverse_layout_transform_gradient_data_op", 2),
             ("reverse_layout_transform_gradient_gate_op", 1),
             ("reverse_layout_transform_no_gate_op", 2),
             ("alltoall_op", 1), ("halltoall_op", 1),
             ("sam_group_sum_op", 1), ("sam_max_op", 1)]


@pytest.mark.parametrize("name,k", FLOAT_OPS,
                         ids=[f"{n}-k{k}" for n, k in FLOAT_OPS])
def test_moe_op_matches_jax(name, k):
    build, arrays, diff = _op_case(name, k)
    outs, r_val = {}, None
    for key, ev in (("torch", _port_eval), ("jax", _jax_eval)):
        m, mo = PKG[key][:2]
        xs = [m.placeholder_op(f"in{i}") for i in range(len(arrays))]
        out = build(m, mo, *xs)
        feeds = dict(zip(xs, arrays))
        nodes = [out]
        if diff:
            if r_val is None:
                (fwd,) = ev([out], feeds)
                r_val = np.random.RandomState(7).randn(
                    *fwd.shape).astype(np.float32)
            r = m.placeholder_op("r")
            feeds[r] = r_val
            loss = m.reduce_sum_op(m.mul_op(out, r))
            nodes += m.gradients(loss, [xs[i] for i in diff])
        outs[key] = ev(nodes, feeds)
    for j, (got, want) in enumerate(zip(outs["torch"], outs["jax"])):
        _close(got, want, f"{name} output {j}")


def _tied_scores(rng, n, e, ties):
    s = rng.randn(n, e).astype(np.float32)
    if ties:
        s[:, 1] = s[:, 0]                 # every token ties experts 0, 1
        s[n // 2:] = s[0]                 # half the tokens tie each other
    return s


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("n,e", [(16, 4), (24, 3), (13, 4)],
                         ids=["16x4", "24x3", "13x4-uneven"])
def test_balance_assignment_op_permutation_is_jaxs(n, e, ties):
    s = _tied_scores(np.random.RandomState(n * e + ties), n, e, ties)
    outs = {}
    for key, ev in (("torch", _port_eval), ("jax", _jax_eval)):
        m, mo = PKG[key][:2]
        p = m.placeholder_op("s")
        (outs[key],) = ev([mo.balance_assignment_op(p)], {p: s})
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    perm = outs["torch"].astype(int)
    assert sorted(perm.tolist()) == list(range(n))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("topk", [1, 2])
def test_group_topk_idx_op_is_jaxs(topk, ties):
    rng = np.random.RandomState(3 + topk)
    a = _tied_scores(rng, N, 8, ties)
    grp = rng.randint(0, 2, (N, 1)).astype(np.float32)
    outs = {}
    for key, ev in (("torch", _port_eval), ("jax", _jax_eval)):
        m, mo = PKG[key][:2]
        pa, pg = m.placeholder_op("a"), m.placeholder_op("g")
        (outs[key],) = ev([mo.group_topk_idx_op(pa, pg, topk=topk,
                                                num_local_gpus=4)],
                          {pa: a, pg: grp})
    np.testing.assert_array_equal(outs["torch"], outs["jax"])


def test_dispatch_is_identity_keeping_parts():
    """``dispatch`` is a sharding annotation: the identity forward and
    backward in the executor, with or without a mesh (an axis the mesh
    lacks is ignored, as JAX's), ``parts`` kept on the node."""
    from hetu_tpu_torch.parallel import make_mesh
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    for parts, mesh in (({0: "tp"}, None),
                        ({1: "zz"}, make_mesh({"dp": 2}, device="cpu"))):
        xp = tm.placeholder_op("x")
        d = tm.dispatch(xp, parts)
        assert isinstance(d, tmoe.DispatchOp) and d.parts == parts
        loss = tm.reduce_sum_op(tm.mul_op(d, d), axes=[0, 1])
        (gx,) = tm.gradients(loss, [xp])
        ex = tm.Executor([d, gx], device="cpu", mesh=mesh)
        y, g = ex.run(feed_dict={xp: x}, convert_to_numpy_ret_vals=True)
        np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(g, 2 * x, rtol=1e-6)
        jd = jm.dispatch(jm.placeholder_op("x"), parts)
        np.testing.assert_array_equal(np.asarray(jd.compute(
            [jnp.asarray(x)], JTraceContext())), y)


# ----------------------------------------------------------------------- #
# the gates through MoELayer
# ----------------------------------------------------------------------- #

B, T, DM, F, EX = 2, 8, 8, 16, 4
TOKENS = B * T


def _layer(key, form, gate_type, k):
    """(x placeholder, out node, l_aux node or None) of an MoE layer."""
    m, _, L, _ = PKG[key]
    x = m.placeholder_op("x")
    if gate_type == "top":
        gate = L.TopKGate(DM, TOKENS, EX, k=k, capacity_factor=1.0)
    elif gate_type == "hash":
        gate = L.HashGate(DM, TOKENS, EX)
    elif gate_type == "ktop1":
        gate = L.KTop1Gate(DM, TOKENS, EX, num_local_gpus=2)
    elif gate_type == "sam":
        gate = L.SAMGate(DM, TOKENS, EX, num_local_gpus=2)
    else:
        gate = L.BalanceGate(DM, TOKENS, EX)
    if form == "stacked":
        experts = L.StackedExperts(EX, DM, F, activation="relu",
                                   name="expert")
    else:
        experts = [L.Expert(DM, F, activation="relu", name=f"expert_{i}")
                   for i in range(EX)]
    name = "BalanceAssignmentLayer" if form == "balance" else "MoELayer"
    layer = L.MoELayer(gate=gate, experts=experts, num_tokens=TOKENS,
                       embed_dim=DM, name=name, top=k)
    out = layer(x)
    if form == "balance":
        return x, out, None
    return x, out[0], out[1]


LAYER_CASES = [("list", "top", 1, False), ("list", "top", 2, False),
               ("list", "top", 2, True), ("stacked", "top", 2, False),
               ("stacked", "top", 1, True), ("list", "hash", 1, False),
               ("list", "ktop1", 1, False), ("list", "sam", 1, False),
               ("balance", "balance", 1, False)]


def _trainable(m, nodes):
    topo = (jgraph if m is jm else tm).find_topo_sort(nodes)
    return sorted((n for n in topo if isinstance(n, (
        jgraph.PlaceholderOp if m is jm else tm.PlaceholderOp))
        and n.is_variable and n.trainable), key=lambda n: n.name)


@pytest.mark.parametrize("form,gate_type,k,ties", LAYER_CASES,
                         ids=[f"{f}-{g}-k{k}" + ("-tied" if t else "")
                              for f, g, k, t in LAYER_CASES])
def test_moe_layer_matches_jax(form, gate_type, k, ties):
    rng = np.random.RandomState(11)
    xv = rng.randn(TOKENS, DM).astype(np.float32)
    rv = rng.randn(TOKENS, DM).astype(np.float32)
    res, init = {}, None
    for key in ("torch", "jax"):
        m = PKG[key][0]
        x, out, l_aux = _layer(key, form, gate_type, k)
        r = m.placeholder_op("r")
        loss = m.reduce_sum_op(m.mul_op(out, r))
        if l_aux is not None:
            loss = loss + l_aux
        wrt = _trainable(m, [loss])
        nodes = [out] + ([l_aux] if l_aux is not None else []) + \
            m.gradients(loss, [x] + wrt)
        feeds = {x: xv, r: rv}
        if key == "torch":
            ex = tm.Executor(nodes, device="cpu")
            init = ex.return_tensor_values()
            if ties:
                w = init["TopK_Gate_linear_weight"]
                w[:, 1] = w[:, 0]           # experts 0 and 1 tie everywhere
                ex.load_dict(init)
            got = [o.numpy() for o in ex.run(feed_dict=feeds)]
        else:
            seed_jax_variables(nodes, init)
            ex = jm.Executor(nodes)
            got = [np.asarray(o) for o in ex.run(feed_dict=feeds)]
        res[key] = (got, [n.name for n in wrt])
    (tg, tnames), (jg, jnames) = res["torch"], res["jax"]
    assert tnames == jnames and len(tnames) > 0
    _close(tg[0], jg[0], "output")
    off = 1
    if gate_type not in ("hash", "balance"):
        _close(tg[1], jg[1], "l_aux", atol=1e-6, rtol=0)
        off = 2
    for name, got, want in zip(["x"] + tnames, tg[off:], jg[off:]):
        _close(got, want, f"d/d {name}")


# ----------------------------------------------------------------------- #
# the MoE models
# ----------------------------------------------------------------------- #

def _moe_mlp_case(key, gate_type):
    m, _, _, models = PKG[key]
    x, y = m.placeholder_op("x"), m.placeholder_op("y_")
    n_local = 8 if gate_type in ("ktop1", "sam") else 2
    loss, _ = models.moe_mlp(x, y, batch_size=B, num_tokens=T,
                             model_dim=DM, hidden_size=F,
                             num_local_experts=n_local, gate_type=gate_type,
                             sparse_labels=True)
    return (x, y), loss


def _train_pair(build, feeds_of, steps=3, lr=0.05, adamw=False):
    """Losses and final variables of ``steps`` steps in both packages
    from the port executor's initial values."""
    out = {}
    init = None
    for key in ("torch", "jax"):
        m = PKG[key][0]
        phs, loss = build(key)
        opt = m.optim.AdamWOptimizer(learning_rate=lr, weight_decay=0.01) \
            if adamw else m.optim.SGDOptimizer(learning_rate=lr)
        train = opt.minimize(loss)
        if key == "torch":
            ex = tm.Executor({"train": [loss, train]}, device="cpu")
            init = ex.return_tensor_values()
        else:
            seed_jax_variables([loss, train], init)
            ex = jm.Executor({"train": [loss, train]})
        feeds = feeds_of(phs)
        losses = [float(np.asarray(ex.run("train", feed_dict=feeds)[0]))
                  for _ in range(steps)]
        out[key] = (losses, ex.return_tensor_values())
    return out


@pytest.mark.parametrize("gate_type", ["top", "hash", "ktop1", "sam",
                                       "balance"])
def test_moe_mlp_three_sgd_steps_match_jax(gate_type):
    rng = np.random.RandomState(2)
    X = rng.randn(B, T, DM).astype(np.float32)
    Y = rng.randint(0, DM, (B * T,)).astype(np.int32)
    out = _train_pair(lambda key: _moe_mlp_case(key, gate_type),
                      lambda phs: {phs[0]: X, phs[1]: Y})
    (tl, tv), (jl, jv) = out["torch"], out["jax"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert set(tv) == set(jv)
    for k in jv:
        _close(tv[k], jv[k], k)


def test_moe_transformer_block_matches_jax():
    rng = np.random.RandomState(4)
    X = rng.randn(B * T, DM).astype(np.float32)
    res, init = {}, None
    for key in ("torch", "jax"):
        m, _, _, models = PKG[key]
        x = m.placeholder_op("x")
        out = models.moe_transformer_block(
            x, batch_size=B, seq_len=T, model_dim=DM, num_heads=2,
            hidden_size=F, num_local_experts=2)
        if key == "torch":
            ex = tm.Executor({"fwd": [out]}, device="cpu")
            init = ex.return_tensor_values()
            res[key] = ex.run("fwd", feed_dict={x: X})[0].numpy()
        else:
            seed_jax_variables([out], init)
            ex = jm.Executor({"fwd": [out]})
            res[key] = np.asarray(ex.run("fwd", feed_dict={x: X})[0])
    assert res["torch"].shape == (B * T, DM)
    _close(res["torch"], res["jax"], "moe_transformer_block")


BS, SQ, V = 2, 16, 128
LR = 1e-3


def _bert_moe(key, top_k, moe_every, flash):
    m, _, _, models = PKG[key]
    cfg = models.BertMoEConfig(
        num_experts=4, top_k=top_k, moe_every=moe_every,
        capacity_factor=1.0, vocab_size=V, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, batch_size=BS, seq_len=SQ,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        use_flash_attention=flash)
    model = models.BertMoEForPreTraining(cfg)
    names = ("ids", "tok", "mask", "mlm", "nsp")
    phs = {n: m.placeholder_op(n) for n in names}
    if flash:
        phs["lens"] = m.placeholder_op("lens")
        loss, _, _ = model(phs["ids"], phs["tok"], None, phs["mlm"],
                           phs["nsp"], kv_lens=phs["lens"])
    else:
        loss, _, _ = model(phs["ids"], phs["tok"], phs["mask"], phs["mlm"],
                           phs["nsp"])
    return phs, loss


BERT_MOE_CASES = [(1, 2, False), (2, 1, False)]


@pytest.mark.parametrize("top_k,moe_every,flash", BERT_MOE_CASES,
                         ids=["top1-every2", "top2-every1"])
def test_bert_moe_three_adamw_steps_match_jax(top_k, moe_every, flash):
    rng = np.random.RandomState(9)
    lens = np.array([SQ, 5], np.int32)
    mask = (np.arange(SQ)[None, :] < lens[:, None]).astype(np.float32)
    arrays = dict(
        ids=rng.randint(0, V, (BS, SQ)).astype(np.int32),
        tok=np.zeros((BS, SQ), np.int32), mask=mask,
        mlm=np.where(rng.rand(BS, SQ) < 0.3, rng.randint(0, V, (BS, SQ)),
                     -1).astype(np.int32),
        nsp=rng.randint(0, 2, (BS,)).astype(np.int32), lens=lens)

    def feeds_of(phs):
        return {p: arrays[n] for n, p in phs.items()}

    out = _train_pair(lambda key: _bert_moe(key, top_k, moe_every, flash),
                      feeds_of, lr=LR, adamw=True)
    (tl, tv), (jl, jv) = out["torch"], out["jax"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tv) == set(jv)
    assert any("expert_stack" in k for k in tv)
    for k in jv:
        tol = 3 * LR if k.endswith("_attn_k_bias") else 1e-5
        d = float(np.abs(tv[k] - jv[k]).max())
        assert d <= tol, (k, d, tol)


def test_moe_sources_import_no_jax():
    code = (
        "import sys\n"
        "import hetu_tpu_torch.models, hetu_tpu_torch.train_bert\n"
        "import hetu_tpu_torch.graph.ops_moe, hetu_tpu_torch.graph.layers\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'hetu_tpu' or "
        "m.startswith('hetu_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
