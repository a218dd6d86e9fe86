"""The port's training path against the JAX package's, on the CPU, on the
same numpy inputs and weights.

- The ops (``functional``): ``layer_norm``, ``gelu`` and ``linear`` with
  their gradients against the JAX op functions and ``jax.vjp``;
  ``tied_lm_head_xent``'s loss and its three gradients against
  ``_chunked_xent_fwd``/``_chunked_xent_bwd`` (ignored labels, N not a
  multiple of the 8 chunks).  f32 ``1e-5``, bf16 ``2e-2``.
- ``MultiHeadAttention`` on its flash and unfused paths against the JAX
  layer from the same weights (output and weight gradients, ``1e-5``);
  the unfused path with ``kv_lens`` under the bf16 policy, whose f32
  mask promotes the output to f32 as in JAX (``2e-3``).
- Each optimizer's ``update_one`` over three steps against the JAX
  optimizer's (``1e-6``), and the clip: three clipped steps of a small
  model through both executors.
- Initializer statistics against the JAX initializers'; dropout's keep
  rate and its eval identity; ``Executor.step`` advances only on
  training steps.
- GPT tiny (2 layers, hidden 64, 2 heads, seq 64, vocab 128) from the
  JAX executor's ``var_values``, flash and unfused: the step-0 loss
  (relative ``1e-5``) and every gradient (``1e-5`` of each tensor's max
  |g|); the losses of three AdamW + clip steps (relative ``1e-5``) and
  the parameters after them (absolute ``1e-5``; AdamW's eps 1e-7 turns
  a rounding-level gradient into a +-lr update, so elements within 2 lr
  count as agreeing when they are at most 0.1% of all); the bf16 policy's
  three losses within ``2e-3`` relative of the JAX ``mixed_precision=
  "bf16"`` executor's (they read at most 3.1e-4 apart), with the blocks'
  activations in bf16.
- The trainer CLI runs two steps on the CPU.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

import hetu_tpu as ht
from hetu_tpu import initializers as jinit
from hetu_tpu import layers as jlayers
from hetu_tpu.graph import gelu_op, layer_normalization_op, linear_op
from hetu_tpu.graph.ops_loss import _chunked_xent_bwd, _chunked_xent_fwd
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTForCausalLM as JGPT
from hetu_tpu_torch import functional as Fn
from hetu_tpu_torch import initializers as tinit
from hetu_tpu_torch import layers as tlayers
from hetu_tpu_torch import optimizer as topt
from hetu_tpu_torch import train_gpt
from hetu_tpu_torch.executor import Executor as TExecutor
from hetu_tpu_torch.models import GPTConfig as TGPTConfig
from hetu_tpu_torch.models.gpt_module import GPTForCausalLMModule as TGPT

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ph(n):
    return [ht.placeholder_op(f"in{i}") for i in range(n)]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                               err_msg=what)


# ------------------------------------------------------------------- #
# the ops
# ------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["layer_norm", "gelu", "linear"])
def test_op_and_grads_match_jax(op, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(10, 16).astype(np.float32) * 2 + 0.5
    if op == "layer_norm":
        args = [x, 1 + 0.1 * rng.randn(16), 0.1 * rng.randn(16)]
        jf = layer_normalization_op(*_ph(3), eps=1e-5).jax_fn
        tf = Fn.layer_norm
    elif op == "gelu":
        args = [x]
        jf, tf = gelu_op(*_ph(1)).jax_fn, Fn.gelu
    else:
        args = [x, rng.randn(16, 12) * 0.3, rng.randn(12)]
        jf, tf = linear_op(*_ph(3)).jax_fn, Fn.linear
    g = rng.randn(*jf(*[_j(a) for a in args]).shape).astype(np.float32)
    ja = [_j(a, dtype) for a in args]
    want, vjp = jax.vjp(jf, *ja)
    want_g = vjp(_j(g, dtype))
    ta = [_t(a, dtype).requires_grad_() for a in args]
    got = tf(*ta)
    assert got.dtype == getattr(torch, dtype)
    got_g = torch.autograd.grad(got, ta, _t(g, dtype))
    _close(got, want, TOL[dtype], op)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        _close(a, b, TOL[dtype] * max(1.0, float(np.abs(_np(b)).max())),
               f"{op} grad {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [37, 40])
def test_tied_lm_head_xent_matches_jax(dtype, N):
    rng = np.random.RandomState(1)
    V, H = 50, 16
    h = rng.randn(N, H).astype(np.float32)
    W = (rng.randn(V, H) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    y = rng.randint(0, V, N).astype(np.int32)
    y[::5] = -1
    gr = rng.rand(N).astype(np.float32)
    want = _chunked_xent_fwd(_j(h, dtype), _j(W, dtype), _j(b, dtype),
                             jnp.asarray(y), -1, 8)
    want_g = _chunked_xent_bwd(jnp.asarray(gr), _j(h, dtype), _j(W, dtype),
                               _j(b, dtype), jnp.asarray(y), -1, 8)
    th, tW, tb = (_t(a, dtype).requires_grad_() for a in (h, W, b))
    got = Fn.tied_lm_head_xent(th, tW, tb, torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (N,)
    assert np.all(_np(got)[::5] == 0.0)
    got_g = torch.autograd.grad(got, (th, tW, tb), _t(gr))
    _close(got, want, TOL[dtype] * 3, "loss")
    for name, a, w in zip(("dh", "dW", "db"), got_g, want_g):
        assert a.dtype == getattr(torch, dtype)
        _close(a, w, TOL[dtype] * max(1.0, float(np.abs(_np(w)).max())),
               name)


def test_masked_mean_ignores_minus_one():
    # the head's loss is 0 on ignored rows; they leave the count
    loss = torch.tensor([1.0, 0.0, 3.0, 0.0])
    labels = torch.tensor([5, -1, 7, -1])
    assert float(Fn.masked_mean(loss, labels)) == pytest.approx(2.0)


# ------------------------------------------------------------------- #
# MultiHeadAttention
# ------------------------------------------------------------------- #


def _run_jax_graph(outputs, feeds, values, mp=None):
    ex = ht.Executor({"f": outputs}, mixed_precision=mp)
    for k, v in values.items():
        assert k in ex.var_values, k
        ex.var_values[k] = jnp.asarray(v)
    return [np.asarray(o) for o in ex.run("f", feed_dict=feeds,
                                           convert_to_numpy_ret_vals=True)]


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("kv_lens", [False, True])
def test_multihead_attention_matches_jax_layer(flash, kv_lens):
    B, S, Hd, nh = 2, 16, 32, 2
    rng = np.random.RandomState(2)
    x = rng.randn(B * S, Hd).astype(np.float32)
    r = rng.randn(B * S, Hd).astype(np.float32)
    lens = np.array([11, 16], np.int32) if kv_lens else None
    tm = tlayers.MultiHeadAttention(Hd, nh, S, use_flash=flash,
                                    causal=True, name="mha",
                                    generator=torch.Generator().manual_seed(0))
    values = {k: _np(p) + 0.01 * rng.randn(*p.shape).astype(np.float32)
              for k, p in tm.named_vars().items()}
    with torch.no_grad():
        for k, p in tm.named_vars().items():
            p.copy_(torch.from_numpy(values[k]))
    xs, rs = ht.placeholder_op("x"), ht.placeholder_op("r")
    jm = jlayers.MultiHeadAttention(Hd, nh, S, B, use_flash=flash,
                                    causal=True, name="mha")
    feeds = {xs: x, rs: r}
    kw = {}
    if kv_lens:
        ls = ht.placeholder_op("lens", dtype=jnp.int32)
        feeds[ls] = lens
        kw["kv_lens"] = ls
    out = jm(xs, **kw)
    loss = ht.reduce_sum_op(ht.mul_op(out, rs), [0, 1])
    names = sorted(values)
    jvars = {v.name: v for v in ht.optim.SGDOptimizer(0.1)
             .get_var_list(loss)}
    grads = ht.gradients(loss, [jvars[n] for n in names])
    res = _run_jax_graph([out] + grads, feeds, values)
    got = tm(_t(x), kv_lens=torch.from_numpy(lens) if kv_lens else None)
    tgrads = torch.autograd.grad((got * _t(r)).sum(),
                                 [tm.named_vars()[n] for n in names])
    _close(got, res[0], 1e-5, "output")
    for n, a, w in zip(names, tgrads, res[1:]):
        _close(a, w, 1e-5 * max(1.0, float(np.abs(w).max())), n)


def test_multihead_attention_bf16_kv_lens_matches_jax_layer():
    """The unfused path under the bf16 policy with kv_lens: the f32 lens
    mask promotes the scores, so the softmax, the context and the output
    are f32, as the JAX layer's are under ``mixed_precision="bf16"``
    (the causal triangle stays in the scores' bf16).  Output within 2e-3
    (measured 3.6e-7; each side is 1.3e-2 from the f32 layer, and the
    port was 1.2e-2 from JAX while its mask stayed bf16)."""
    B, S, Hd, nh = 2, 16, 32, 2
    rng = np.random.RandomState(2)
    x = rng.randn(B * S, Hd).astype(np.float32)
    lens = np.array([11, 16], np.int32)
    tm = tlayers.MultiHeadAttention(Hd, nh, S, use_flash=False, causal=True,
                                    name="mha",
                                    generator=torch.Generator().manual_seed(0))
    values = {k: _np(p) + 0.01 * rng.randn(*p.shape).astype(np.float32)
              for k, p in tm.named_vars().items()}
    jm = jlayers.MultiHeadAttention(Hd, nh, S, B, use_flash=False,
                                    causal=True, name="mha")
    xs = ht.placeholder_op("x")
    ls = ht.placeholder_op("lens", dtype=jnp.int32)
    want = _run_jax_graph([jm(xs, kv_lens=ls)], {xs: x, ls: lens}, values,
                          mp="bf16")[0]
    attrs = {n: a for a, n in tm._jax_names.items()}
    cast = {attrs[n]: _t(v, "bfloat16") for n, v in values.items()}
    got = torch.func.functional_call(tm, cast, (_t(x, "bfloat16"),),
                                     {"kv_lens": torch.from_numpy(lens)})
    assert want.dtype == np.float32 and got.dtype == torch.float32
    _close(got, want, 2e-3, "bf16 output")


# ------------------------------------------------------------------- #
# optimizers
# ------------------------------------------------------------------- #


OPTS = {
    "sgd": (ht.optim.SGDOptimizer, topt.SGDOptimizer,
            dict(learning_rate=0.1, l2reg=0.01)),
    "momentum": (ht.optim.MomentumOptimizer, topt.MomentumOptimizer,
                 dict(learning_rate=0.1, momentum=0.9)),
    "nesterov": (ht.optim.MomentumOptimizer, topt.MomentumOptimizer,
                 dict(learning_rate=0.1, momentum=0.9, nesterov=True)),
    "adagrad": (ht.optim.AdaGradOptimizer, topt.AdaGradOptimizer,
                dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    "adam": (ht.optim.AdamOptimizer, topt.AdamOptimizer,
             dict(learning_rate=0.01)),
    "amsgrad": (ht.optim.AdamOptimizer, topt.AdamOptimizer,
                dict(learning_rate=0.01, amsgrad=True)),
    "adamw": (ht.optim.AdamWOptimizer, topt.AdamWOptimizer,
              dict(learning_rate=0.01, weight_decay=0.05)),
    "lamb": (ht.optim.LambOptimizer, topt.LambOptimizer,
             dict(learning_rate=0.01, weight_decay=0.05)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_update_one_matches_jax_over_three_steps(name):
    jcls, tcls, kw = OPTS[name]
    jo, to = jcls(**kw), tcls(**kw)
    rng = np.random.RandomState(3)
    p = rng.randn(5, 7).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    js, ts = jo.init_state_one(jp), to.init_state_one(tp)
    lr = float(kw["learning_rate"])
    for step in range(3):
        g = rng.randn(5, 7).astype(np.float32)
        jp, js = jo.update_one(jp, jnp.asarray(g), js, jnp.float32(lr),
                               jnp.asarray(step, jnp.int32))
        tp, ts = to.update_one(tp, torch.from_numpy(g), ts,
                               torch.tensor(lr), torch.tensor(float(step)))
        _close(tp, jp, 1e-6, f"{name} step {step}")
        for slot in (js or {}):
            _close(ts[slot], js[slot], 1e-6, f"{name} slot {slot}")


class _Tiny(tlayers.BaseLayer):
    """loss = 10 * mean((x @ w + b)^2), large enough for the clip."""

    def __init__(self):
        super().__init__("tiny")
        self.lin = tlayers.Linear(4, 3, name="tiny",
                                  generator=torch.Generator().manual_seed(0))

    def forward(self, x, generator=None):
        return 10.0 * (self.lin(x) ** 2).mean()


@pytest.mark.parametrize("name", list(OPTS))
def test_clipped_steps_match_jax_executor(name):
    jcls, tcls, kw = OPTS[name]
    rng = np.random.RandomState(4)
    x = rng.randn(6, 4).astype(np.float32) * 3
    xs = ht.placeholder_op("x")
    lin = jlayers.Linear(4, 3, name="tiny")
    y = lin(xs)
    loss = ht.mul_byconst_op(ht.reduce_mean_op(ht.mul_op(y, y), [0, 1]),
                             10.0)
    jo = jcls(**kw)
    jo.clip_grad_norm = 1.0
    jex = ht.Executor({"train": [loss, jo.minimize(loss)]})
    tm = _Tiny()
    tm.lin.bias.data.normal_(generator=torch.Generator().manual_seed(1))
    for k, p in tm.named_vars().items():
        jex.var_values[k] = jnp.asarray(_np(p))
    to = tcls(**kw)
    to.clip_grad_norm = 1.0
    tex = TExecutor(tm, to, device="cpu")
    for step in range(3):
        jl = float(np.asarray(jex.run("train", feed_dict={xs: x})[0]))
        tl = float(tex.run({"x": x})[0])
        assert tl == pytest.approx(jl, rel=1e-5)
        for k, v in tex.var_values.items():
            _close(v, jex.var_values[k], 2e-6, f"{name} {k} step {step}")
    assert tex.step == 3


# ------------------------------------------------------------------- #
# initializers, dropout, the step counter
# ------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["normal", "xavier_normal",
                                  "xavier_uniform", "ones", "zeros"])
def test_initializer_statistics_match_jax(kind):
    shape = (300, 500)
    make = {
        "normal": lambda m: m.NormalInit(0.1, 0.02, shape),
        "xavier_normal": lambda m: m.XavierNormalInit(shape, gain=1.5),
        "xavier_uniform": lambda m: m.XavierUniformInit(shape),
        "ones": lambda m: m.OnesInit(shape),
        "zeros": lambda m: m.ZerosInit(shape)}[kind]
    got = make(tinit).generate(torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(make(jinit).generate(jax.random.PRNGKey(0)))
    assert got.shape == want.shape and got.dtype == np.float32
    for stat in (np.mean, np.std):
        assert stat(got) == pytest.approx(stat(want), abs=2e-3 * max(
            1.0, float(np.std(want))), rel=0.02)
    if kind == "xavier_uniform":
        limit = np.sqrt(6.0 / sum(shape))
        assert got.max() <= limit and got.min() >= -limit
        assert got.max() > 0.99 * limit and got.min() < -0.99 * limit
    assert not np.array_equal(got, want) or kind in ("ones", "zeros")


def test_initializer_fans():
    assert tinit._fans((7,)) == jinit._fans((7,)) == (7, 7)
    assert tinit._fans((3, 5)) == jinit._fans((3, 5))
    assert tinit._fans((8, 4, 3, 3)) == jinit._fans((8, 4, 3, 3))


def test_dropout_keep_rate_and_eval_identity():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = Fn.dropout(x, 0.8, g, training=True)
    kept = (y != 0).float().mean().item()
    assert kept == pytest.approx(0.8, abs=0.005)
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.8))
    assert Fn.dropout(x, 0.8, g, training=False) is x
    assert Fn.dropout(x, 1.0, g, training=True) is x


def _tiny_cfg(flash, batch=2):
    kw = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, max_position_embeddings=64,
              batch_size=batch, seq_len=64, dropout_rate=0.0,
              use_flash=flash)
    return JGPTConfig(**kw), TGPTConfig(**kw)


def _batch(seed, cfg):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.seq_len))
    y = (3 * x + 7) % cfg.vocab_size
    y[:, -1] = -1
    return x.astype(np.int32), y.astype(np.int32)


def test_executor_step_advances_only_on_training_steps():
    _, cfg = _tiny_cfg(False)
    cfg.num_hidden_layers = 1
    opt = topt.AdamWOptimizer(learning_rate=1e-3)
    ex = TExecutor(TGPT(cfg, seed=0), opt, device="cpu")
    x, y = _batch(0, cfg)
    feed = {"input_ids": x, "labels": y}
    assert ex.step == 0
    before = {k: v.clone() for k, v in ex.var_values.items()}
    ex.evaluate(feed)
    assert ex.step == 0
    assert all(torch.equal(before[k], v) for k, v in ex.var_values.items())
    ex.run(feed)
    ex.run(feed)
    ex.evaluate(feed)
    assert ex.step == 2
    assert set(ex.opt_states) == set(ex.var_values)
    assert set(ex.opt_states["gpt_wte_table"]) == {"m", "v"}


# ------------------------------------------------------------------- #
# GPT tiny against the JAX executor
# ------------------------------------------------------------------- #


def _jax_gpt(cfg, lr, mp=None):
    m = JGPT(cfg, name="gpt")
    ids = ht.placeholder_op("input_ids")
    labels = ht.placeholder_op("labels")
    loss, _ = m(ids, labels=labels)
    opt = ht.optim.AdamWOptimizer(learning_rate=lr, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    var_list = opt.get_var_list(loss)
    grads = ht.gradients(loss, var_list)
    ex = ht.Executor({"train": [loss, opt.minimize(loss)],
                      "grads": [loss] + grads}, mixed_precision=mp)
    return ex, ids, labels, [v.name for v in var_list]


def _torch_gpt(cfg, values, lr, mp=None):
    model = TGPT(cfg, seed=1).load_var_values(values)
    opt = topt.AdamWOptimizer(learning_rate=lr, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    return TExecutor(model, opt, mixed_precision=mp, device="cpu")


LR = 3e-4


@pytest.mark.parametrize("flash", [True, False])
def test_gpt_tiny_matches_jax_executor_f32(flash):
    jcfg, tcfg = _tiny_cfg(flash)
    jex, ids, labels, names = _jax_gpt(jcfg, LR)
    values = {k: np.asarray(v) for k, v in jex.var_values.items()}
    tex = _torch_gpt(tcfg, values, LR)
    model = tex.model
    assert set(model.var_values()) == set(values)
    assert all(np.array_equal(model.var_values()[k], v)
               for k, v in values.items())
    x, y = _batch(5, tcfg)

    # step 0: the loss and every gradient
    out = jex.run("grads", feed_dict={ids: x, labels: y},
                  convert_to_numpy_ret_vals=True)
    loss = model(torch.from_numpy(x), torch.from_numpy(y))
    tv = model.named_vars()
    tgrads = torch.autograd.grad(loss, [tv[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(out[0]), rel=1e-5)
    g_max = max(float(np.abs(np.asarray(w)).max()) for w in out[1:])
    for n, a, w in zip(names, tgrads, out[1:]):
        w = np.asarray(w)
        if n.endswith("_attn_k_bias"):
            # exactly 0: k's bias shifts a row of scores by a constant,
            # which softmax ignores; both sides hold rounding noise
            assert max(np.abs(w).max(), np.abs(_np(a)).max()) \
                <= 1e-6 * g_max, n
            continue
        _close(a, w, 1e-5 * float(np.abs(w).max()), n)

    # three AdamW + clip steps
    for step in range(3):
        x, y = _batch(10 + step, tcfg)
        jl = float(np.asarray(jex.run("train", feed_dict={ids: x,
                                                          labels: y})[0]))
        tl = float(tex.run({"input_ids": x, "labels": y})[0])
        assert tl == pytest.approx(jl, rel=1e-5), f"step {step}"
    assert tex.step == 3
    n_loose = n_all = 0
    for k, v in tex.var_values.items():
        d = np.abs(_np(v) - np.asarray(jex.var_values[k]))
        assert d.max() <= 2 * LR, k
        n_loose += int((d > 1e-5).sum())
        n_all += d.size
    print(f"{n_loose} of {n_all} parameters past 1e-5, all within 2 lr")
    assert n_loose <= 1e-3 * n_all, (n_loose, n_all)
    for n, s in tex.opt_states.items():
        assert set(s) == {"m", "v"}, n


@pytest.mark.parametrize("flash", [True, False])
def test_gpt_tiny_bf16_losses_match_jax_executor(flash):
    jcfg, tcfg = _tiny_cfg(flash)
    jex, ids, labels, _ = _jax_gpt(jcfg, LR, mp="bf16")
    values = {k: np.asarray(v) for k, v in jex.var_values.items()}
    tex = _torch_gpt(tcfg, values, LR, mp="bf16")
    # the policy runs the forward in bf16: an f32 forward's losses sit
    # as close to JAX's bf16 losses as the port's do, so hold the dtypes
    seen = []
    for mod in (tex.model.transformer.blocks[0].attn,
                tex.model.transformer.blocks[-1], tex.model.transformer.ln_f):
        mod.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    for step in range(3):
        x, y = _batch(20 + step, tcfg)
        jl = np.asarray(jex.run("train", feed_dict={ids: x, labels: y})[0])
        tl = tex.run({"input_ids": x, "labels": y})[0]
        assert tl.dtype == torch.float32 and jl.dtype == np.float32
        # measured: at most 3.1e-4 apart over both paths' six losses
        assert float(tl) == pytest.approx(float(jl), rel=2e-3), step
    assert seen == [torch.bfloat16] * 9
    # the f32 masters and the optimizer state stay f32
    assert all(v.dtype == torch.float32 for v in tex.var_values.values())
    assert tex.opt_states["gpt_wte_table"]["m"].dtype == torch.float32


def test_trainer_cli_runs_two_steps_on_the_cpu():
    losses = train_gpt.main(["--device", "cpu", "--num-layers", "2",
                             "--vocab-size", "128", "--seq-len", "64",
                             "--batch-size", "2", "--num-steps", "2",
                             "--use-flash"])
    assert len(losses) == 2 and all(np.isfinite(losses))
