"""The port's context parallelism and its carried flash forward (K2-carry)
against the JAX package's, on the CPU.

- ``flash_fwd_carry_reference`` (the plain version of the carried kernel
  in csrc/flash_fwd.cu) against the JAX ``_flash_fwd(carry=...)`` in
  interpret mode on the same numpy inputs: f32 and bf16, causal and not,
  a carry that is empty, live, or mixed row by row.  f32 ``atol 1e-5``;
  bf16 ``atol 2e-2`` (both round P to bf16 before PV, the Pallas body
  against the running max of each 16-key block, the plain version
  against the row's max, and with a carry the f32 output shows that:
  over these six bf16 cases the gap is at most 1.20e-3 in o and 4.8e-7
  in lse).
- ``FlashAttentionCarry`` (through ``flash_attention_with_carry``) and
  ``flash_attention_with_lse`` against ``jax.grad`` of the JAX wrappers,
  in every tensor argument and through both outputs: f32, ``1e-5`` of
  each tensor's max.
- ``ring_attention`` (exact and flash, causal and not) on the
  one-process ``VirtualMesh`` against JAX ``ring_attention`` on the
  8-device CPU mesh (B 2, S 32, H 4, D 8, cp 4, the shapes of
  tests/test_context_parallel.py) and against ``blockwise_attention``;
  ``ulysses_attention`` and ``blockwise_attention`` against theirs.
  Outputs and gradients of sum(o * g): ``1e-5`` (of each gradient's
  max).
- The ``torch.distributed`` path over four gloo processes on the CPU,
  one world for the whole module: the ring (flash and exact, forward
  and backward, cp 4), dp 2 x cp 2 against JAX's ``{"dp": 2, "cp": 2}``
  mesh, and Ulysses at cp 4.  The workers import only torch and
  hetu_tpu_torch; this process computes the JAX values and compares.
  The world has a gloo timeout and a join timeout of its own, and is
  killed when the join times out.
- CPU tensors launch no kernel.

The CUDA kernel is held to the plain version on the card by
test_torch_kernels_cuda.py and chip_smoke.py (phase 9).
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu.parallel import context_parallel as jcp
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu_torch.kernels import flash_attention as tfa
from hetu_tpu_torch.kernels import launch_counts, reset_launches
from hetu_tpu_torch.parallel import (MeshAxes, VirtualMesh,
                                     blockwise_attention,
                                     local_device_count, make_mesh,
                                     ring_attention, ulysses_attention)

REPO = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S, H, D = 2, 32, 4, 8
CP = 4
NEG_INF = -1e30


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _fold(x, dtype="float32"):
    """[B, S, H, D] -> the JAX kernels' [B*H, S, D]."""
    x = np.asarray(x, np.float32)
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                       getattr(jnp, dtype))


def _unfold(x, b, h):
    x = np.asarray(jnp.asarray(x, jnp.float32))
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _carry(rng, b, s, h, d, kind):
    """(o_c [b, s, h, d], lse_c [b, h, s]) f32: ``empty`` (lse -1e30
    everywhere, o_c zeros, as the ring starts), ``live`` (every row), or
    ``mixed`` (every third row empty)."""
    o_c = rng.randn(b, s, h, d).astype(np.float32)
    lse_c = (2.0 * rng.randn(b, h, s) + 3.0).astype(np.float32)
    if kind == "empty":
        o_c[:] = 0.0
        lse_c[:] = NEG_INF
    elif kind == "mixed":
        lse_c[..., ::3] = NEG_INF
    return o_c, lse_c


def _qkv(seed, b=B, s=S, sk=None, h=H, d=D):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32))


# ------------------------------------------------------------------- #
# K2-carry's plain version against the Pallas kernel
# ------------------------------------------------------------------- #


CARRY_SHAPES = [(True, 32, 32), (False, 24, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,s,sk", CARRY_SHAPES)
@pytest.mark.parametrize("kind", ["empty", "live", "mixed"])
def test_carry_reference_matches_jax_kernel(dtype, causal, s, sk, kind):
    q, k, v = _qkv(5, s=s, sk=sk, h=2)
    rng = np.random.RandomState(6)
    o_c, lse_c = _carry(rng, B, s, 2, D, kind)
    jo, jl = jfa._flash_fwd(
        _fold(q, dtype), _fold(k, dtype), _fold(v, dtype), None,
        causal=causal, block_q=8, block_k=16, interpret=True,
        carry=(_fold(o_c), jnp.asarray(lse_c.reshape(B * 2, 1, s))))
    to, tl = tfa.flash_fwd_carry_reference(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(o_c), _t(lse_c),
        causal=causal)
    assert to.dtype == torch.float32 and jo.dtype == jnp.float32
    want_o = _unfold(jo, B, 2)
    want_l = np.asarray(jl).reshape(B, 2, s)
    np.testing.assert_allclose(_f32(to), want_o, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(_f32(tl), want_l, atol=TOL[dtype], rtol=0)
    if kind == "empty" and dtype == "float32":
        # an empty carry is K2: the same output and lse
        o2, l2 = tfa.flash_fwd_reference(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(_f32(to), _f32(o2), atol=1e-6, rtol=0)
        np.testing.assert_allclose(_f32(tl), _f32(l2), atol=1e-5, rtol=0)


def test_carry_reference_dead_rows_and_chain():
    """A row with no live key in either part gets o 0 and lse +1e30 (no
    keys at all here); chaining two carried calls over halves of the
    keys equals one attention over all of them."""
    q, k, v = _qkv(7, s=16, sk=32)
    o0 = torch.zeros((B, 16, H, D))
    l0 = torch.full((B, H, 16), NEG_INF)
    o, lse = tfa.flash_fwd_carry_reference(_t(q), _t(k)[:, :0],
                                           _t(v)[:, :0], o0, l0)
    assert (o == 0).all() and (lse == -NEG_INF).all()
    o1, l1 = tfa.flash_attention_with_carry(_t(q), _t(k)[:, :16],
                                            _t(v)[:, :16], o0, l0)
    o2, l2 = tfa.flash_attention_with_carry(_t(q), _t(k)[:, 16:],
                                            _t(v)[:, 16:], o1, l1)
    want, want_l = tfa.flash_fwd_reference(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(_f32(o2), _f32(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_f32(l2), _f32(want_l), atol=1e-5, rtol=0)


def test_carry_refuses_kv_lens_and_bad_carries():
    q, k, v = (_t(x) for x in _qkv(8))
    o_c, lse_c = torch.zeros(q.shape), torch.full((B, H, S), NEG_INF)
    with pytest.raises(TypeError, match="kv_lens"):
        tfa.flash_fwd_carry(q, k, v, o_c, lse_c,
                            kv_lens=torch.full((B,), S, dtype=torch.int32))
    with pytest.raises(ValueError, match="o_carry"):
        tfa.flash_fwd_carry(q, k, v, o_c.double(), lse_c)
    with pytest.raises(ValueError, match="lse_carry"):
        tfa.flash_fwd_carry(q, k, v, o_c, lse_c[:, :, 1:])


# ------------------------------------------------------------------- #
# the autograd Functions against jax.grad
# ------------------------------------------------------------------- #


def _close_grads(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        b = _f32(b)
        np.testing.assert_allclose(
            _f32(a), b, atol=1e-5 * max(1.0, float(np.abs(b).max())),
            rtol=0, err_msg=f"{what} argument {i}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["empty", "live", "mixed"])
def test_flash_attention_with_carry_grads_match_jax(causal, kind):
    q, k, v = _qkv(9, s=24, sk=24, h=2)
    rng = np.random.RandomState(10)
    o_c, lse_c = _carry(rng, B, 24, 2, D, kind)
    go = rng.randn(B, 24, 2, D).astype(np.float32)
    gl = rng.randn(B, 2, 24).astype(np.float32)
    args = (q, k, v, o_c, lse_c)

    def jloss(*a):
        o, lse = jfa.flash_attention_with_carry(*a, causal=causal,
                                                block_q=8, block_k=8)
        return jnp.sum(o * go) + jnp.sum(lse * gl)

    jo, jl = jfa.flash_attention_with_carry(
        *(jnp.asarray(a) for a in args), causal=causal, block_q=8, block_k=8)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    xs = [_t(a).requires_grad_() for a in args]
    to, tl = tfa.flash_attention_with_carry(*xs, causal=causal)
    tg = torch.autograd.grad((to * _t(go)).sum() + (tl * _t(gl)).sum(), xs)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-5, rtol=0)
    assert float(tg[3].abs().max()) > 0 or kind == "empty"
    _close_grads(tg, jg, f"carry {kind} causal {causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_with_lse_grads_match_jax(causal):
    q, k, v = _qkv(11, s=24, sk=40, h=2)
    rng = np.random.RandomState(12)
    go = rng.randn(*q.shape).astype(np.float32)
    gl = rng.randn(B, 2, 24).astype(np.float32)

    def jloss(*a):
        o, lse = jfa.flash_attention_with_lse(*a, causal=causal,
                                              block_q=8, block_k=8)
        return jnp.sum(o * go) + jnp.sum(lse * gl)

    jq = [jnp.asarray(a) for a in (q, k, v)]
    jo, jl = jfa.flash_attention_with_lse(*jq, causal=causal, block_q=8,
                                          block_k=8)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*jq)
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    to, tl = tfa.flash_attention_with_lse(*xs, causal=causal)
    tg = torch.autograd.grad((to * _t(go)).sum() + (tl * _t(gl)).sum(), xs)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-5, rtol=0)
    _close_grads(tg, jg, f"lse causal {causal}")


# ------------------------------------------------------------------- #
# ring, Ulysses and blockwise on the one-process mesh
# ------------------------------------------------------------------- #


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, H, D).astype(np.float32) for _ in range(4))


@functools.lru_cache(maxsize=None)
def _jax_ring(kind, axes, causal, seed=0):
    """(o, dq, dk, dv) of JAX's ``kind`` ("flash", "exact", "ulysses")
    on a mesh of ``axes`` over the module's inputs, the gradients those
    of sum(o * g)."""
    q, k, v, g = _inputs(seed)
    mesh = jmake_mesh(dict(axes))

    def run(q, k, v):
        if kind == "ulysses":
            return jcp.ulysses_attention(q, k, v, mesh=mesh, causal=causal)
        kw = dict(block_q=8, block_k=8) if kind == "flash" else {}
        return jcp.ring_attention(q, k, v, mesh=mesh, causal=causal,
                                  impl=kind, **kw)

    jq = [jnp.asarray(a) for a in (q, k, v)]
    o = run(*jq)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(run(*a) * g),
                             argnums=(0, 1, 2)))(*jq)
    return tuple(np.asarray(x) for x in (o, *grads))


def _torch_grads(fn, q, k, v, g):
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    o = fn(*xs)
    return (o.detach(),) + torch.autograd.grad((o * _t(g)).sum(), xs)


def _close_all(got, want, what):
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), atol=1e-5,
                               rtol=0, err_msg=f"{what} output")
    _close_grads(got[1:], want[1:], what)


@pytest.mark.parametrize("axes, want", [
    ({"cp": CP}, {"cp": CP}),
    ({"cp": 2, "dp": 2}, {"dp": 2, "cp": 2}),
    (MeshAxes(dp=2, cp=2), {"dp": 2, "cp": 2}),
    ({"cp": 1}, {"cp": 1}),
    ({}, {"dp": 1}),
])
def test_make_mesh_axes_match_jax(axes, want):
    """Axes of size 1 drop out and the rest take the canonical order,
    as the JAX package's make_mesh names them."""
    mesh = make_mesh(axes, device="cpu")
    assert mesh.shape == want and mesh.device == torch.device("cpu")
    jaxes = {k: getattr(axes, k) for k in ("dcn", "pp", "dp", "ep", "cp",
                                            "tp")} \
        if isinstance(axes, MeshAxes) else axes
    jmesh = jmake_mesh(jaxes)
    assert dict(jmesh.shape) == want
    assert MeshAxes(dp=2, cp=2).total() == 4


def test_make_mesh_refusals_and_local_devices():
    """make_mesh follows JAX's rules: axes outside the canonical six go
    innermost in the caller's order, keyword sizes, ``default_mesh`` (one
    virtual rank without a world); a -1 needs a device count, which a
    VirtualMesh has not."""
    from hetu_tpu.parallel.mesh import MeshAxes as JMeshAxes
    from hetu_tpu_torch.parallel import default_mesh
    for axes, jaxes in ((({"ici": 2, "dp": 2},) * 2),
                        (({"tp": 2, "ici": 2, "pp": 2},) * 2),
                        (MeshAxes(dp=2, cp=2), JMeshAxes(dp=2, cp=2))):
        want = jmake_mesh(jaxes)
        got = make_mesh(axes, device="cpu")
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
    assert make_mesh(pp=4, device="cpu").shape == dict(jmake_mesh(pp=4).shape)
    assert default_mesh(device="cpu").shape == {"dp": 1}
    assert default_mesh(3, device="cpu").shape == {"dp": 3}
    assert jmake_mesh({"dp": -1, "tp": 2}).shape["dp"] == 4
    with pytest.raises(ValueError, match="no device count"):
        make_mesh({"cp": -1}, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh({"cp": 0}, device="cpu")
    assert local_device_count() == (torch.cuda.device_count()
                                    if torch.cuda.is_available() else 1)


@pytest.mark.parametrize("impl", ["exact", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_on_the_virtual_mesh_matches_jax(impl, causal):
    mesh = make_mesh({"cp": CP}, device="cpu")
    assert isinstance(mesh, VirtualMesh) and mesh.shape == {"cp": CP}
    q, k, v, g = _inputs()
    got = _torch_grads(lambda *a: ring_attention(
        *a, mesh=mesh, causal=causal, impl=impl), q, k, v, g)
    _close_all(got, _jax_ring(impl, (("cp", CP),), causal),
               f"ring {impl} causal {causal}")
    want = _torch_grads(lambda *a: blockwise_attention(
        *a, block_size=8, causal=causal), q, k, v, g)
    _close_all(got, want, f"ring {impl} vs blockwise")


def test_ring_impl_default_and_refusals():
    mesh = make_mesh({"cp": CP}, device="cpu")
    q, k, v, _ = (_t(a) for a in _inputs())
    reset_launches()
    a = ring_attention(q, k, v, mesh=mesh, causal=True)
    b = ring_attention(q, k, v, mesh=mesh, causal=True, impl="exact")
    assert torch.equal(a, b)          # None is exact on CPU tensors
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, k, v, mesh=mesh, impl="fast")
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q[:, :30], k[:, :30], v[:, :30], mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, k, v, mesh=make_mesh({"cp": 3},
                                                  device="cpu"))
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


def test_ring_composes_with_dp_on_the_virtual_mesh():
    mesh = make_mesh({"dp": 2, "cp": 2}, device="cpu")
    assert mesh.shape == {"dp": 2, "cp": 2}
    q, k, v, g = _inputs()
    got = _torch_grads(lambda *a: ring_attention(
        *a, mesh=mesh, causal=True, impl="flash"), q, k, v, g)
    _close_all(got, _jax_ring("flash", (("dp", 2), ("cp", 2)), True),
               "dp x cp")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_on_the_virtual_mesh_matches_jax(causal):
    mesh = make_mesh({"cp": CP}, device="cpu")
    q, k, v, g = _inputs()
    got = _torch_grads(lambda *a: ulysses_attention(
        *a, mesh=mesh, causal=causal), q, k, v, g)
    _close_all(got, _jax_ring("ulysses", (("cp", CP),), causal),
               f"ulysses causal {causal}")
    flash = ulysses_attention(*(_t(a) for a in (q, k, v)), mesh=mesh,
                              causal=causal,
                              attn_fn=lambda q, k, v, c: tfa.flash_attention(
                                  q, k, v, causal=c))
    np.testing.assert_allclose(_f32(flash), _f32(got[0]), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [8, 12])
def test_blockwise_matches_jax(causal, block):
    q, k, v, g = _inputs(3)
    jq = [jnp.asarray(a) for a in (q, k, v)]

    def jrun(*a):
        return jcp.blockwise_attention(*a, block_size=block, causal=causal)

    want = (np.asarray(jrun(*jq)),) + tuple(jax.grad(
        lambda *a: jnp.sum(jrun(*a) * g), argnums=(0, 1, 2))(*jq))
    got = _torch_grads(lambda *a: blockwise_attention(
        *a, block_size=block, causal=causal), q, k, v, g)
    _close_all(got, want, f"blockwise {block} causal {causal}")


def test_cpu_ring_launches_no_kernel():
    mesh = make_mesh({"cp": CP}, device="cpu")
    reset_launches()
    xs = [_t(a).requires_grad_() for a in _inputs()[:3]]
    o = ring_attention(*xs, mesh=mesh, causal=True, impl="flash")
    o.sum().backward()
    tfa.flash_fwd_carry(*(x.detach() for x in xs), torch.zeros(B, S, H, D),
                        torch.full((B, H, S), NEG_INF))
    assert set(launch_counts().values()) == {0}


# ------------------------------------------------------------------- #
# torch.distributed: one gloo world of four processes
# ------------------------------------------------------------------- #

WORLD = 4
GLOO_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300

_WORKER = textwrap.dedent('''
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from hetu_tpu_torch.parallel import (make_mesh, ring_attention,
                                         ulysses_attention)

    rank, world, init, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds={gloo_timeout}))
    d = np.load(data)
    full = [torch.from_numpy(d[n]) for n in ("q", "k", "v", "g")]
    res = {{}}

    def run(name, fn, b_sl, s_sl):
        xs = [x[b_sl, s_sl].clone().requires_grad_() for x in full[:3]]
        o = fn(*xs)
        grads = torch.autograd.grad((o * full[3][b_sl, s_sl]).sum(), xs)
        for key, x in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            res[f"{{name}}/{{key}}"] = x.detach().numpy()

    cp4 = make_mesh({{"cp": world}})
    me = cp4.get_local_rank("cp")
    S = full[0].shape[1]
    blk = slice(me * S // world, (me + 1) * S // world)
    res["cp4/rank"] = np.array(me)
    for impl in ("flash", "exact"):
        for causal in (False, True):
            run(f"ring-{{impl}}-{{int(causal)}}",
                lambda *a: ring_attention(*a, mesh=cp4, causal=causal,
                                          impl=impl), slice(None), blk)
    run("ulysses-1", lambda *a: ulysses_attention(*a, mesh=cp4,
                                                   causal=True),
        slice(None), blk)
    dpcp = make_mesh({{"dp": 2, "cp": 2}})
    dp, cp = dpcp.get_local_rank("dp"), dpcp.get_local_rank("cp")
    res["dpcp/rank"] = np.array([dp, cp])
    run("dpcp-flash-1", lambda *a: ring_attention(*a, mesh=dpcp,
                                                  causal=True,
                                                  impl="flash"),
        slice(dp, dp + 1), slice(cp * S // 2, (cp + 1) * S // 2))
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
''').format(gloo_timeout=GLOO_TIMEOUT_S)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """Run the worker in four gloo processes over the module's inputs and
    return each rank's results; kill the world if it does not finish
    within JOIN_TIMEOUT_S."""
    tmp = tmp_path_factory.mktemp("gloo")
    q, k, v, g = _inputs()
    np.savez(tmp / "data.npz", q=q, k=k, v=v, g=g)
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(WORLD), init,
         str(tmp / "data.npz"), str(tmp / f"rank{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the gloo world did not finish in {JOIN_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _gather_cp4(world, name):
    """The four ranks' shards of case ``name``, joined along the
    sequence in cp order."""
    by_rank = sorted(world, key=lambda r: int(r["cp4/rank"]))
    return tuple(np.concatenate([r[f"{name}/{key}"] for r in by_rank],
                                axis=1) for key in ("o", "dq", "dk", "dv"))


@pytest.mark.parametrize("impl", ["flash", "exact"])
@pytest.mark.parametrize("causal", [False, True])
def test_distributed_ring_matches_jax(gloo_world, impl, causal):
    got = _gather_cp4(gloo_world, f"ring-{impl}-{int(causal)}")
    _close_all(got, _jax_ring(impl, (("cp", CP),), causal),
               f"gloo ring {impl} causal {causal}")


def test_distributed_ulysses_matches_jax(gloo_world):
    got = _gather_cp4(gloo_world, "ulysses-1")
    _close_all(got, _jax_ring("ulysses", (("cp", CP),), True),
               "gloo ulysses")


def test_distributed_dp_by_cp_matches_jax(gloo_world):
    parts = {}
    for r in gloo_world:
        dp, cp = (int(x) for x in r["dpcp/rank"])
        parts[dp, cp] = r
    assert sorted(parts) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    got = tuple(np.concatenate([np.concatenate(
        [parts[dp, cp][f"dpcp-flash-1/{key}"] for cp in (0, 1)], axis=1)
        for dp in (0, 1)], axis=0) for key in ("o", "dq", "dk", "dv"))
    _close_all(got, _jax_ring("flash", (("dp", 2), ("cp", 2)), True),
               "gloo dp x cp")
