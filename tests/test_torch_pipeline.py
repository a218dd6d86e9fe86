"""The port's pipeline schedules, host-loop trainer and stage pipelines
(``hetu_tpu_torch.parallel.pipeline``) against the JAX package's
``parallel/pipeline.py`` on the same seeded numpy inputs:

- ``gpipe_schedule`` / ``one_f_one_b_schedule`` equal JAX's lists over
  an (M, S, stage) grid;
- ``PipelineTrainer`` in gpipe, 1f1b, pipedream (weight stashing) and
  hetpipe (a fake parameter server, as tests/test_pipeline.py's) against
  JAX's trainer: losses and parameters within 1e-5, with SGD and with a
  momentum optimizer;
- ``spmd_pipeline`` (plain and ``checkpoint_stages``) and
  ``spmd_pipeline_1f1b`` on ``make_mesh({"pp": 4}, device="cpu")`` (a
  VirtualMesh) against JAX's on its 4-device ``pp`` mesh: outputs and the
  gradients of the stacked params and of the input within 1e-5;
- the boundary-slot high-water: 1f1b at most min(M, 2S - 1), gpipe
  exactly M (every microbatch's stage input lives until the backward),
  at M 8 and 16.
"""

import itertools

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from hetu_tpu.optimizer import MomentumOptimizer as JMomentum
from hetu_tpu.parallel import pipeline as jp
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu_torch.optimizer import MomentumOptimizer as TMomentum
from hetu_tpu_torch.parallel import make_mesh
from hetu_tpu_torch.parallel import pipeline as tp

HID, S, M, MB = 16, 4, 8, 4
TOL = 1e-5


def _params(seed):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(HID, HID) * 0.3).astype(np.float32),
             "b": (rng.randn(HID) * 0.1).astype(np.float32)}
            for _ in range(S)]


def j_stage(params, x, m=None):
    return jnp.tanh(x @ params["w"] + params["b"])


def t_stage(params, x, m=None):
    return torch.tanh(x @ params["w"] + params["b"])


@pytest.mark.parametrize("m,s", list(itertools.product([1, 3, 4, 8],
                                                       [1, 2, 4])))
def test_schedules_equal_jax(m, s):
    assert tp.gpipe_schedule(m) == jp.gpipe_schedule(m)
    for stage in range(s):
        assert tp.one_f_one_b_schedule(m, stage, s) == \
            jp.one_f_one_b_schedule(m, stage, s)


class FakePS:
    """Accumulating store, the contract of ps/server.py's push()."""

    def __init__(self):
        self.store = {}
        self.pushes = 0

    def push(self, k, v):
        self.pushes += 1
        self.store[k] = self.store.get(k, 0) + np.asarray(v)

    def pull(self, k):
        return self.store[k]


def _trainers(mode, opt):
    per = _params(5)
    j = jp.PipelineTrainer(
        [jp.PipelineStage(apply=j_stage,
                          params={k: jnp.asarray(v) for k, v in p.items()})
         for p in per], mode=mode, optimizer=opt[0],
        loss_fn=lambda y, t: jnp.mean((y - t) ** 2), sync_every=2,
        ps=FakePS())
    t = tp.PipelineTrainer(
        [tp.PipelineStage(apply=t_stage,
                          params={k: torch.from_numpy(v)
                                  for k, v in p.items()})
         for p in per], mode=mode, optimizer=opt[1],
        loss_fn=lambda y, t: torch.mean((y - t) ** 2), sync_every=2,
        ps=FakePS())
    return j, t


@pytest.mark.parametrize("mode", ["gpipe", "1f1b", "pipedream", "hetpipe"])
@pytest.mark.parametrize("optim", ["sgd", "momentum"])
def test_trainer_matches_jax(mode, optim):
    opt = (None, None) if optim == "sgd" else \
        (JMomentum(learning_rate=0.05, momentum=0.9),
         TMomentum(learning_rate=0.05, momentum=0.9))
    j, t = _trainers(mode, opt)
    rng = np.random.RandomState(7)
    for _ in range(4):
        x = rng.randn(M, MB, HID).astype(np.float32)
        y = rng.randn(M, MB, HID).astype(np.float32)
        lj = j.train_batch(list(jnp.asarray(x)), list(jnp.asarray(y)))
        lt = t.train_batch(list(torch.from_numpy(x)),
                           list(torch.from_numpy(y)))
        np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    for sj, st in zip(j.stages, t.stages):
        for k in sj.params:
            np.testing.assert_allclose(st.params[k].numpy(),
                                       np.asarray(sj.params[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
    if mode == "hetpipe":
        assert t.ps.pushes == j.ps.pushes == 2 * S * 2
        for k, v in j.ps.store.items():
            np.testing.assert_allclose(t.ps.store[k], v, rtol=TOL,
                                       atol=TOL)


def _jax_pipeline(kind, stacked, mb, g):
    mesh = jmake_mesh({"pp": S})

    def loss(p, x):
        if kind == "1f1b":
            y = jp.spmd_pipeline_1f1b(j_stage, p, x, mesh=mesh)
        else:
            y = jp.spmd_pipeline(j_stage, p, x, mesh=mesh,
                                 checkpoint_stages=kind == "remat")
        return jnp.sum(y * g), y

    (_, y), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(stacked, mb)
    return np.asarray(y), {k: np.asarray(v) for k, v in dp.items()}, \
        np.asarray(dx)


@pytest.mark.parametrize("kind", ["gpipe", "remat", "1f1b"])
def test_spmd_pipelines_match_jax(kind):
    per = _params(2)
    rng = np.random.RandomState(3)
    mb = rng.randn(M, MB, HID).astype(np.float32)
    g = rng.randn(M, MB, HID).astype(np.float32)
    want = _jax_pipeline(kind, jp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per]),
        jnp.asarray(mb), jnp.asarray(g))
    mesh = make_mesh({"pp": S}, device="cpu")
    stacked = tp.shard_stacked_params(tp.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per]),
        mesh)
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    x = torch.from_numpy(mb).requires_grad_()
    if kind == "1f1b":
        y = tp.spmd_pipeline_1f1b(t_stage, leaves, x, mesh=mesh)
    else:
        y = tp.spmd_pipeline(t_stage, leaves, x, mesh=mesh,
                             checkpoint_stages=kind == "remat")
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want[0], rtol=TOL,
                               atol=TOL)
    for k in leaves:
        np.testing.assert_allclose(leaves[k].grad.numpy(), want[1][k],
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), want[2], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", [8, 16])
def test_boundary_high_water(m):
    mesh = make_mesh({"pp": S}, device="cpu")
    stacked = tp.stack_stage_params(
        [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
         for p in _params(4)])
    x = torch.randn(m, MB, HID, generator=torch.Generator().manual_seed(0))
    for kind in ("gpipe", "1f1b"):
        fn = tp.spmd_pipeline_1f1b if kind == "1f1b" else tp.spmd_pipeline
        fn(t_stage, stacked, x, mesh=mesh).sum().backward()
    assert tp.HIGH_WATER["gpipe"] == m
    assert tp.HIGH_WATER["1f1b"] == min(m, 2 * S - 1)
