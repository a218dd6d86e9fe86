"""Expert parallelism in the PyTorch port against the JAX package on the
CPU (``hetu_tpu_torch.models.moe_decode``: ``ep_shard_params``,
``moe_ffn_ep_reference``, ``resolve_moe_quant``; the communicators'
``all_to_all``; ``graph/ops_moe.py``'s ``alltoall_op`` /
``halltoall_op``):

- ``moe_ffn_ep_reference`` over ``make_mesh({"ep": 4})`` (a
  ``VirtualMesh``) against JAX's over 4 devices of the 8-device CPU
  platform, on JAX's own fixture (2 layers, D 32, 4 experts, top-2,
  capacity factor 8.0, x [16, 32] from ``RandomState(0)``): within
  1e-5 of JAX's, and within JAX's 1e-4 of the unsharded ``moe_ffn``;
  with the int8 wire within ``INT8_TOL`` of JAX's int8 reference and
  within JAX's 0.2 of ``moe_ffn``; at a binding capacity (0.5) within
  1e-5 of JAX's;
- ``ep_shard_params`` refuses the bad meshes of JAX's tests before it
  places anything, with JAX's error kind; each virtual rank's view of a
  stack holds E/n experts, the gate and the rest are replicated;
- the engine (paged, mixed waves) over an ep-placed dict on a virtual
  ep 2 and ep 4: the same greedy tokens and expert load / drop counts
  as the unsharded engine and as JAX's engine on the same weights, with
  every expert product run on E/n experts;
- the all-to-all ops in the per-rank view (``run_per_rank``) against
  JAX's under ``shard_map`` bit for bit: the flat exchange over ``ep``
  4 (twice restores the input, once is not the identity) and the
  hierarchical exchange over ``("dcn", "ici")`` 2 x 2, which equals the
  flat exchange over 4;
- one gloo world of two processes (a ``DeviceMesh``; gloo timeout 60 s,
  join 300 s): ``ProcessComm.all_to_all`` equals the virtual one, the
  ep-placed ``moe_ffn`` on each process is bit-equal to the unsharded
  one (and so is an engine over the placed dict, before and after a
  ``swap_params`` of whole values), each process stores only its
  experts, and ``moe_ffn_ep_reference`` (f32 and int8) equals the
  virtual mesh's.

``INT8_TOL``: both int8 references encode the same f32 values, which
differ by f32 rounding alone (~1e-7); a value that sits on a rounding
tie may round to the neighbouring code on one side, a change of one
step (its row's amax / 127) before the gates weight it (their sum is
<= 1).  The bound allows one such step at the scale of the output:
1e-5 + max |y| / 127.
"""

import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import hetu_tpu as jht
from hetu_tpu.analysis.shard_check import ShardCheckError as JShardCheckError
from hetu_tpu.analysis.shard_check import check_expert_mesh as jcheck
from hetu_tpu.graph import ops_moe as jops
from hetu_tpu.graph.node import TraceContext as JTC
from hetu_tpu.models import moe_decode as jmd
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu.serving import Request as JRequest
from hetu_tpu.serving import ServingEngine as JEngine
import hetu_tpu_torch.graph as tht
from hetu_tpu_torch.analysis.integration import ShardCheckError
from hetu_tpu_torch.graph import ops_moe as tops
from hetu_tpu_torch.graph.node import TraceContext as TTC
from hetu_tpu_torch.models import moe_decode as tmd
from hetu_tpu_torch.parallel import make_mesh
from hetu_tpu_torch.parallel.collectives import run_per_rank
from hetu_tpu_torch.parallel import sharding
from hetu_tpu_torch.parallel.sharding import placement, rank_pieces
from hetu_tpu_torch.serving import Request as TRequest
from hetu_tpu_torch.serving import ServingEngine as TEngine

REPO = Path(__file__).resolve().parent.parent
US = "moe_h1"
EP_TOL = 1e-5           # port vs JAX reference, f32
LOCAL_TOL = 1e-4        # the reference vs moe_ffn (JAX's own bound)
INT8_LOCAL_TOL = 0.2    # the int8 wire vs moe_ffn (JAX's own bound)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**over):
    # tests/test_moe_serving.py's _moe_cfg
    kw = dict(vocab_size=97, hidden_size=32, num_hidden_layers=4,
              num_attention_heads=2, ffn_mult=2, seq_len=48,
              dropout_rate=0.0, max_position_embeddings=48, num_experts=4,
              top_k=2, capacity_factor=2.0, moe_every=2)
    kw.update(over)
    return kw


# TestExpertParallel's fixture: 2 layers, 32 positions, capacity 8.0
EP_KW = _kw(num_hidden_layers=2, seq_len=32, max_position_embeddings=32,
            capacity_factor=8.0)


@pytest.fixture(scope="module")
def ep():
    tcfg, jcfg = tmd.MoEDecodeConfig(**EP_KW), jmd.MoEDecodeConfig(**EP_KW)
    p = tmd.init_moe_params(tcfg, name="moe", seed=0)
    x = np.random.RandomState(0).randn(16, 32).astype(np.float32)
    return types.SimpleNamespace(
        p=p, x=x, tcfg=tcfg, jcfg=jcfg,
        tp={k: torch.from_numpy(v) for k, v in p.items()},
        tmesh=make_mesh({"ep": 4}, device="cpu"),
        jmesh=Mesh(np.array(jax.devices()[:4]), ("ep",)))


def _specs(ep, cf):
    return (tmd.moe_spec_of(ep.tcfg)._replace(capacity_factor=cf),
            jmd.moe_spec_of(ep.jcfg)._replace(capacity_factor=cf))


def _jax_ref(ep, cf, quant):
    placed = jmd.ep_shard_params(ep.p, ep.jmesh, ep.jcfg, axis="ep",
                                 name="moe")
    return np.asarray(jax.jit(lambda p, x: jmd.moe_ffn_ep_reference(
        p, US, x, _specs(ep, cf)[1], ep.jmesh, quant=quant))(
            placed, jnp.asarray(ep.x)))


def _port_ref(ep, cf, quant, placed=True):
    params = (tmd.ep_shard_params(ep.p, ep.tmesh, ep.tcfg, name="moe")
              if placed else ep.tp)
    return tmd.moe_ffn_ep_reference(
        params, US, torch.from_numpy(ep.x), _specs(ep, cf)[0], ep.tmesh,
        quant=quant).numpy()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_ep_reference_matches_jax(ep, quant):
    want = _jax_ref(ep, 8.0, quant)
    got = _port_ref(ep, 8.0, quant)
    local = tmd.moe_ffn(ep.tp, US, torch.from_numpy(ep.x),
                        _specs(ep, 8.0)[0]).numpy()
    err = np.abs(got - want).max()
    if quant is None:
        assert err <= EP_TOL, err
        assert np.abs(got - local).max() <= LOCAL_TOL
    else:
        assert err <= EP_TOL + np.abs(want).max() / 127, err
        assert np.abs(got - local).max() < INT8_LOCAL_TOL
        # the wire is really int8: not the f32 exchange's result
        assert not np.array_equal(got, _port_ref(ep, 8.0, None))
    # whole stacks give the placed stacks' result
    np.testing.assert_array_equal(_port_ref(ep, 8.0, quant, placed=False),
                                  got)


def test_ep_reference_binding_capacity_matches_jax(ep):
    """Capacity 0.5 binds (per-shard capacity 2 for 8 pairs a shard):
    the reference drops pairs, as JAX's does, and so leaves moe_ffn."""
    got = _port_ref(ep, 0.5, None)
    np.testing.assert_allclose(got, _jax_ref(ep, 0.5, None), atol=EP_TOL,
                               rtol=0)
    assert np.abs(got - _port_ref(ep, 8.0, None)).max() > 1e-3


def test_ep_reference_refuses_indivisible(ep):
    spec = _specs(ep, 8.0)[0]
    with pytest.raises(ValueError, match="token count"):
        tmd.moe_ffn_ep_reference(ep.tp, US, torch.zeros(6, 32), spec,
                                 ep.tmesh)
    with pytest.raises(ValueError, match="num_experts"):
        tmd.moe_ffn_ep_reference(ep.tp, US, torch.zeros(16, 32), spec,
                                 make_mesh({"ep": 3}, device="cpu"))


def test_resolve_moe_quant_matches_jax(monkeypatch):
    for env in (None, "", "int8", "off"):
        if env is None:
            monkeypatch.delenv("HETU_MOE_QUANT", raising=False)
        else:
            monkeypatch.setenv("HETU_MOE_QUANT", env)
        for mode in (None, "int8", "0", "none"):
            assert tmd.resolve_moe_quant(mode) == jmd.resolve_moe_quant(mode)
    with pytest.raises(ValueError):
        tmd.resolve_moe_quant("fp8")


# ------------------------------------------------------------------- #
# ep_shard_params
# ------------------------------------------------------------------- #

BAD_MESHES = {
    "indivisible": (3, {"ep": 4}),
    "missing_axis": (4, {"dp": 4}),
    "no_mesh": (4, None),
}


@pytest.mark.parametrize("case", sorted(BAD_MESHES))
def test_ep_shard_params_rejects_bad_mesh_before_placement(case,
                                                           monkeypatch):
    E, axes = BAD_MESHES[case]
    cfg = tmd.MoEDecodeConfig(**_kw(num_experts=E))
    params = tmd.init_moe_params(cfg, name="moe", seed=0)
    jmesh = None if axes is None else Mesh(
        np.array(jax.devices()[:4]), tuple(axes))
    with pytest.raises(JShardCheckError) as je:
        jcheck(jmesh, E, "ep")
    placed = []
    monkeypatch.setattr(sharding, "prep_param",
                        lambda *a, **k: placed.append(a))
    mesh = None if axes is None else make_mesh(axes, device="cpu")
    with pytest.raises(ShardCheckError) as te:
        tmd.ep_shard_params(params, mesh, cfg, axis="ep", name="moe")
    assert te.value.kind == je.value.kind == "expert_mesh"
    assert not placed


def test_ep_shard_params_places_experts_per_rank(ep):
    placed = tmd.ep_shard_params(ep.p, ep.tmesh, ep.tcfg, name="moe")
    jplaced = jmd.ep_shard_params(ep.p, ep.jmesh, ep.jcfg, axis="ep",
                                  name="moe")
    assert sorted(placed) == sorted(jplaced)
    for k, v in placed.items():
        np.testing.assert_array_equal(v.numpy(), ep.p[k])
        place = placement(v)
        if "_moe_expert_stack_" not in k:
            assert place is None, k
            continue
        assert place == (ep.tmesh, "ep", 0), k
        spec = ("ep",) + (None,) * (v.dim() - 1)
        want = {s.data.shape for s in jplaced[k].addressable_shards}
        assert {tuple(q.shape) for q in rank_pieces(v, spec, ep.tmesh)} \
            == want == {(1,) + tuple(v.shape[1:])}, k
    # the placement survives what a consumer does to a parameter
    w1 = placed[f"{US}_moe_expert_stack_w1"]
    for t in (w1.to(torch.float32), w1.contiguous(), w1.clone(),
              w1.clone().copy_(w1)):
        assert placement(t) == (ep.tmesh, "ep", 0)
    assert placement(w1 + 0) is None


def test_expert_parallel_spec_matches_jax():
    tc = tmd.MoEDecodeConfig(**_kw(ep_axis="ep"))
    jc = jmd.MoEDecodeConfig(**_kw(ep_axis="ep"))
    assert tc.ep_axis == "ep"
    assert tuple(tmd.moe_spec_of(tc)) == tuple(jmd.moe_spec_of(jc))
    assert tmd.moe_spec_of(tmd.MoEDecodeConfig(**_kw())).ep_axis is None


# ------------------------------------------------------------------- #
# the engine over an ep-placed dict
# ------------------------------------------------------------------- #

PROMPTS = [[5, 9, 2], [7, 1, 4, 3, 8], [11, 6]]
MAX_NEW = 8
ENGINE = dict(paged=16, ragged=True)


def _reqs(Req):
    return [Req(request_id=str(i), prompt=pr, max_new_tokens=MAX_NEW,
                temperature=0.0, seed=0) for i, pr in enumerate(PROMPTS)]


def _run(eng, Req):
    res = eng.run(_reqs(Req))
    return ({k: [int(t) for t in r.tokens] for k, r in res.items()},
            eng.expert_load.tolist(), eng.expert_drops.tolist(),
            eng.moe_tokens)


@pytest.fixture(scope="module")
def engines():
    tcfg = tmd.MoEDecodeConfig(**_kw())
    p = tmd.init_moe_params(tcfg, name="moe", seed=0)
    jeng = JEngine(p, jmd.MoEDecodeConfig(**_kw()), slots=4, name="moe",
                   fast_path=False, **ENGINE)
    whole = TEngine(p, tcfg, slots=4, name="moe", device="cpu", **ENGINE)
    return p, tcfg, _run(jeng, JRequest), _run(whole, TRequest)


@pytest.mark.parametrize("n", [2, 4])
def test_engine_over_ep_placed_params(engines, n, monkeypatch):
    p, tcfg, want_jax, want_whole = engines
    mesh = make_mesh({"ep": n}, device="cpu")
    placed = tmd.ep_shard_params(p, mesh, tcfg, name="moe")
    eng = TEngine(placed, tcfg, slots=4, name="moe", device="cpu", **ENGINE)
    assert all(placement(v) == (mesh, "ep", 0)
               for k, v in eng.params.items() if "_moe_expert_stack_" in k)
    seen = []
    inner = tmd._experts
    monkeypatch.setattr(tmd, "_experts", lambda xe, w1, *a: (
        seen.append(w1.shape[0]), inner(xe, w1, *a))[1])
    got = _run(eng, TRequest)
    assert got == want_whole
    assert got == want_jax
    assert seen and set(seen) == {tcfg.num_experts // n}


# ------------------------------------------------------------------- #
# the all-to-all ops, per rank, against shard_map
# ------------------------------------------------------------------- #


def _port_per_rank(node, x, axes):
    """The node's per-rank outputs on blocks of x's rows (row-major over
    the mesh's ranks, as P(axes) splits them), joined back."""
    mesh = make_mesh(dict(axes), device="cpu")
    n = int(np.prod(list(axes.values())))
    blocks = [(b,) for b in torch.from_numpy(x).chunk(n)]
    outs = run_per_rank(
        lambda comm, b: node.compute([b], TTC(device="cpu", comm=comm)),
        mesh, blocks)
    return torch.cat(outs).numpy()


def _jax_per_rank(fn, x, axes):
    names = tuple(axes)
    mesh = jmake_mesh(dict(axes))
    spec = P(names if len(names) > 1 else names[0])
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=spec, out_specs=spec))(jnp.asarray(x)))


def _jax_node(node, names):
    return lambda b: node.compute([b], JTC(axis_env=names))


def test_flat_alltoall_matches_shard_map():
    xs = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    node = tops.AllToAllOp(tht.placeholder_op("t"), axis="ep")
    jnode = jops.alltoall_op(jht.placeholder_op("t"), axis="ep")
    out = _port_per_rank(node, xs, {"ep": 4})
    np.testing.assert_array_equal(
        out, _jax_per_rank(_jax_node(jnode, ("ep",)), xs, {"ep": 4}))
    np.testing.assert_array_equal(_port_per_rank(node, out, {"ep": 4}), xs)
    assert not np.array_equal(out, xs)
    # the adjoint is the same exchange
    (g,) = node.gradient(tht.placeholder_op("g"))
    assert isinstance(g, tops.AllToAllOp) and g.axis == "ep"


def test_hierarchical_alltoall_matches_flat_and_shard_map():
    xs = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    axes = {"dcn": 2, "ici": 2}
    assert make_mesh(axes, device="cpu").axis_names == ("dcn", "ici")
    node = tops.halltoall_op(tht.placeholder_op("t"), axes=("ici", "dcn"))
    jnode = jops.halltoall_op(jht.placeholder_op("t"), axes=("ici", "dcn"))
    out = _port_per_rank(node, xs, axes)
    np.testing.assert_array_equal(
        out, _jax_per_rank(_jax_node(jnode, ("ici", "dcn")), xs, axes))
    np.testing.assert_array_equal(_port_per_rank(node, out, axes), xs)
    assert not np.array_equal(out, xs)

    def flat(x):
        parts = x.reshape(4, x.shape[0] // 4, *x.shape[1:])
        return jax.lax.all_to_all(parts, ("dcn", "ici"), split_axis=0,
                                  concat_axis=0).reshape(x.shape)

    np.testing.assert_array_equal(out, _jax_per_rank(flat, xs, axes))
    flat4 = tops.alltoall_op(tht.placeholder_op("t"), axis="ep")
    np.testing.assert_array_equal(out, _port_per_rank(flat4, xs, {"ep": 4}))


def test_alltoall_whole_value_view_is_identity():
    x = torch.randn(8, 3)
    for node in (tops.alltoall_op(tht.placeholder_op("t")),
                 tops.halltoall_op(tht.placeholder_op("t"))):
        assert node.compute([x], TTC(device="cpu")) is x
    # one of the two hierarchical axes present: the flat exchange over it
    node = tops.halltoall_op(tht.placeholder_op("t"), axes=("ici", "dcn"))
    xs = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    flat = tops.alltoall_op(tht.placeholder_op("t"), axis="ici")
    np.testing.assert_array_equal(_port_per_rank(node, xs, {"ici": 4}),
                                  _port_per_rank(flat, xs, {"ici": 4}))


@pytest.mark.parametrize("split,concat", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_comm_all_to_all_is_tiled_lax_all_to_all(split, concat):
    x = np.arange(4 * 8 * 4 * 3, dtype=np.float32).reshape(4, 8, 4, 3)
    want = _jax_per_rank(
        lambda b: jax.lax.all_to_all(b[0], "ep", split, concat,
                                     tiled=True)[None], x, {"ep": 4})
    mesh = make_mesh({"ep": 4}, device="cpu")
    got = run_per_rank(lambda comm, b: comm.all_to_all(b, "ep", split,
                                                       concat),
                       mesh, [(torch.from_numpy(b),) for b in x])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    with pytest.raises(ValueError, match="equal blocks"):
        run_per_rank(lambda comm, b: comm.all_to_all(b, "ep", 0, 0), mesh,
                     [(torch.zeros(3, 2),)] * 4)


# ------------------------------------------------------------------- #
# torch.distributed: one gloo world of two processes
# ------------------------------------------------------------------- #

WORLD = 2
GLOO_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300

_WORKER = textwrap.dedent('''
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from hetu_tpu_torch.models import moe_decode as md
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.collectives import ProcessComm
    from hetu_tpu_torch.serving import Request, ServingEngine

    rank, world, init, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds={gloo_timeout}))
    d = dict(np.load(data))
    res = {{}}
    mesh = make_mesh({{"ep": world}})
    comm = ProcessComm(mesh)
    me = comm.index("ep")
    res["rank"] = np.array(me)
    a2a = torch.from_numpy(d["a2a"][me])
    for s in (0, 1):
        for c in (0, 1):
            res[f"a2a/{{s}}{{c}}"] = comm.all_to_all(a2a, "ep", s, c).numpy()
    res["a2a/int8"] = comm.all_to_all(a2a.to(torch.int8), "ep", 0, 1).numpy()
    cfg = md.MoEDecodeConfig(**{ep_kw})
    params = {{k[2:]: v for k, v in d.items() if k.startswith("p/")}}
    placed = md.ep_shard_params(params, mesh, cfg, name="moe")
    for k, v in placed.items():
        if "_moe_expert_stack_" in k:
            res[f"stored/{{k}}"] = v.numpy()
    x = torch.from_numpy(d["x"])
    spec = md.moe_spec_of(cfg)
    res["moe_ffn"] = md.moe_ffn(placed, "moe_h1", x, spec).numpy()
    for q in ("f32", "int8"):
        res[f"ref/{{q}}"] = md.moe_ffn_ep_reference(
            placed, "moe_h1", x, spec, mesh,
            quant=None if q == "f32" else q).numpy()
    eng = ServingEngine(placed, cfg, slots=2, name="moe", paged=16,
                        ragged=True, device="cpu")
    got = eng.run([Request(request_id="0", prompt=[5, 9, 2],
                           max_new_tokens=6)])
    res["engine"] = np.asarray(got["0"].tokens)
    # a swap of whole values writes this rank's experts into its piece
    eng.swap_params(params)
    res["swapped"] = np.asarray(eng.run([Request(
        request_id="1", prompt=[5, 9, 2], max_new_tokens=6)])["1"].tokens)
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
''').format(gloo_timeout=GLOO_TIMEOUT_S, ep_kw=repr(EP_KW))


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory, ep):
    """The worker in two gloo processes; each rank's results.  The world
    is killed if it does not finish within JOIN_TIMEOUT_S."""
    tmp = tmp_path_factory.mktemp("gloo_ep")
    a2a = np.arange(WORLD * 4 * 6, dtype=np.float32).reshape(WORLD, 4, 6)
    np.savez(tmp / "data.npz", a2a=a2a, x=ep.x,
             **{f"p/{k}": v for k, v in ep.p.items()})
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
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    assert [int(r["rank"]) for r in ranks] == list(range(WORLD))
    return a2a, ranks


def test_gloo_all_to_all_equals_virtual(gloo_world):
    a2a, ranks = gloo_world
    mesh = make_mesh({"ep": WORLD}, device="cpu")
    blocks = [(torch.from_numpy(b),) for b in a2a]
    for s in (0, 1):
        for c in (0, 1):
            want = run_per_rank(lambda comm, b: comm.all_to_all(
                b, "ep", s, c), mesh, blocks)
            for r in range(WORLD):
                np.testing.assert_array_equal(ranks[r][f"a2a/{s}{c}"],
                                              want[r].numpy())
    want = run_per_rank(lambda comm, b: comm.all_to_all(
        b.to(torch.int8), "ep", 0, 1), mesh, blocks)
    for r in range(WORLD):
        assert ranks[r]["a2a/int8"].dtype == np.int8
        np.testing.assert_array_equal(ranks[r]["a2a/int8"], want[r].numpy())


def test_gloo_ep_placed_moe_ffn_and_storage(gloo_world, ep):
    _, ranks = gloo_world
    spec = tmd.moe_spec_of(ep.tcfg)
    x = torch.from_numpy(ep.x)
    want = tmd.moe_ffn(ep.tp, US, x, spec).numpy()
    E = ep.tcfg.num_experts
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["moe_ffn"], want)
        stored = {k[7:]: v for k, v in ranks[r].items()
                  if k.startswith("stored/")}
        assert stored and len(stored) == 4 * tmd.moe_spec_of(
            ep.tcfg).moe_layers(ep.tcfg.num_hidden_layers)
        for k, v in stored.items():
            e = E // WORLD
            np.testing.assert_array_equal(v, ep.p[k][r * e:(r + 1) * e])
    virtual = make_mesh({"ep": WORLD}, device="cpu")
    for q in ("f32", "int8"):
        ref = tmd.moe_ffn_ep_reference(
            ep.tp, US, x, spec, virtual,
            quant=None if q == "f32" else q).numpy()
        for r in range(WORLD):
            np.testing.assert_array_equal(ranks[r][f"ref/{q}"], ref)


def test_gloo_engine_over_placed_params(gloo_world, ep):
    _, ranks = gloo_world
    eng = TEngine(ep.p, ep.tcfg, slots=2, name="moe", device="cpu",
                  **ENGINE)
    want = eng.run([TRequest(request_id="0", prompt=[5, 9, 2],
                             max_new_tokens=6)])["0"].tokens
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["engine"], want)
        np.testing.assert_array_equal(ranks[r]["swapped"], want)
