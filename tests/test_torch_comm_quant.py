"""The int8 gradient all-reduce of the port (``quant.quantize`` /
``dequantize``, the quantize -> all-gather -> dequantize trio of
``graph/ops_comm.py``, ``DataParallel(aggregate="int8")`` and
``$HETU_COMM_QUANT``, ``shard_check.check_quantized_collectives``)
against the JAX package's, on the CPU:

- the codec: ``quantize`` / ``dequantize`` equal ``quantize_jax`` /
  ``dequantize_jax`` bit for bit (outliers, an all-zero chunk, ties at
  half a step), and the numpy half ``quantize_np`` / ``dequantize_np``
  equals JAX's;
- the port's versions of JAX's passing trio tests
  (``tests/test_quant.py::TestCommQuantPair``): the whole-value view is
  a fake-quant within the codec's bound ``amax / 254``; the shard check
  accepts the paired trio and rejects the four broken pairings with
  JAX's messages; ``check_parallelism`` runs it; the strategy splices the
  trio onto every dense gradient and trains (within 0.05 of the plain
  run); the environment knob turns the splice on;
- the per-rank view over a virtual dp 4: each rank's result is the sum
  of the four ranks' gradients within 4 x the codec's bound, the same on
  every rank, and the recorded collective sequence carries int8;
- ``DataParallel(aggregate="int8", num_devices=2)``'s losses equal the
  JAX executor's under the same strategy within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu import quant as jquant
from hetu_tpu_torch import quant
from hetu_tpu_torch.analysis.shard_check import (
    ShardCheckError, check_parallelism, check_quantized_collectives)
from hetu_tpu_torch.graph.node import TraceContext
from hetu_tpu_torch.graph.ops_comm import (
    DequantizeCommOp, QuantAllReduceCommunicateOp, QuantizeCommOp)
from hetu_tpu_torch.parallel import (check_collective_order, make_mesh,
                                     quantized_collectives)
from hetu_tpu_torch.parallel.collectives import run_per_rank


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")

@pytest.fixture(autouse=True)
def _one_thread():
    # tiny tensors: one intra-op thread is the fastest, and many
    # processes of the suite share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _err_bound(x):
    """Half a quantization step of the worst chunk of one encode."""
    m = float(np.abs(x).max()) if np.asarray(x).size else 0.0
    return m / 254.0 + 1e-7


def _codec_input():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 512).astype(np.float32)
    x[0, 3] = 80.0                           # an outlier's chunk
    x[1, 256:] = 0.0                         # an all-zero chunk
    x[2, :256] = np.arange(256) * 0.5 - 64   # ties at half a step
    return x


@pytest.mark.parametrize("chunk", [256, 64])
def test_codec_equals_jax_bit_for_bit(chunk):
    x = _codec_input()
    q, s = quant.quantize(torch.from_numpy(x), chunk)
    jq, js = jquant.quantize_jax(jnp.asarray(x), chunk)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s[1, 256 // chunk]) == 1.0
    d = quant.dequantize(q, s, chunk)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jquant.dequantize_jax(jq, js, chunk)))
    assert float(np.abs(d.numpy() - x).max()) <= _err_bound(x)
    # the numpy half, on a size that leaves a partial chunk
    flat = x.reshape(-1)[:1000]
    nq, ns = quant.quantize_np(flat, chunk)
    wq, ws = jquant.quantize_np(flat, chunk)
    np.testing.assert_array_equal(nq, wq)
    np.testing.assert_array_equal(ns, ws)
    np.testing.assert_array_equal(quant.dequantize_np(nq, ns, chunk),
                                  jquant.dequantize_np(wq, ws, chunk))
    with pytest.raises(ValueError, match="divisible"):
        quant.quantize(torch.zeros(3, 100), chunk)


def _trio(shape=(8, 32)):
    return tht.quantized_allreduce_op(tht.placeholder_op("qgrad"),
                                      shape=shape)


def _apply(trio, x, tc):
    gth = trio.inputs[0]
    q = gth.inputs[0]
    return trio.compute([gth.compute([q.compute([x], tc)], tc)], tc)


def test_pjit_mode_is_fake_quant():
    x = np.random.RandomState(14).randn(8, 32).astype(np.float32)
    out = _apply(_trio(), torch.from_numpy(x), TraceContext())
    assert tuple(out.shape) == (8, 32)
    assert np.abs(out.numpy() - x).max() <= _err_bound(x)
    # JAX's trio in its pjit mode gives the same values
    jt = jht.quantized_allreduce_op(jht.placeholder_op("qg"), shape=(8, 32))
    from hetu_tpu.graph.node import TraceContext as JTC
    want = _apply(jt, jnp.asarray(x), JTC())
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_shard_check_accepts_paired_rejects_unpaired():
    trio = _trio()
    assert len(check_quantized_collectives([trio])) == 1
    # a quantize whose pair never crosses a collective
    q = QuantizeCommOp(tht.placeholder_op("g1"))
    d = DequantizeCommOp(q, (4, 4))
    with pytest.raises(ShardCheckError, match="quant"):
        check_quantized_collectives([d])
    # a collective with no dequantize consumer
    gth = QuantAllReduceCommunicateOp(QuantizeCommOp(
        tht.placeholder_op("g2")))
    with pytest.raises(ShardCheckError, match="paired"):
        check_quantized_collectives([gth])
    # a collective over a raw (unquantized) input
    d2 = DequantizeCommOp(QuantAllReduceCommunicateOp(
        tht.placeholder_op("g3")), (4, 4))
    with pytest.raises(ShardCheckError, match="QuantizeCommOp"):
        check_quantized_collectives([d2])
    # an axis disagreement inside one trio
    q3 = QuantizeCommOp(tht.placeholder_op("g4"), axis="dp")
    d3 = DequantizeCommOp(QuantAllReduceCommunicateOp(q3, axis="dp"),
                          (4, 4), axis="tp")
    with pytest.raises(ShardCheckError, match="axis"):
        check_quantized_collectives([d3])


def test_check_parallelism_wires_the_pairing():
    gth = QuantAllReduceCommunicateOp(QuantizeCommOp(
        tht.placeholder_op("g5")))
    with pytest.raises(ShardCheckError):
        check_parallelism([gth], None)
    assert check_parallelism([_trio()], None) == []


def _mlp(ht, aggregate, num_devices=1):
    x = ht.placeholder_op("x")
    w = ht.init.xavier_uniform((32, 32), name="dpq_w")
    h = ht.relu_op(ht.matmul_op(x, w))
    loss = ht.reduce_mean_op(ht.reduce_mean_op(h, axes=1), axes=0)
    train = ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    strategy = ht.dist.DataParallel(aggregate=aggregate,
                                    num_devices=num_devices)
    kw = dict(device="cpu") if ht is tht else {}
    ex = ht.Executor({"train": [loss, train]}, seed=3,
                     dist_strategy=strategy, **kw)
    return x, ex


def _losses(x, ex, feed, n=6):
    return [float(np.asarray(ex.run("train", feed_dict={x: feed})[0]))
            for _ in range(n)]


def test_strategy_splices_and_trains():
    feed = np.ones((8, 32), np.float32)
    x, ex_q = _mlp(tht, "quant_allreduce")
    (opt,) = [n for nodes in ex_q.eval_node_dict.values() for n in nodes
              if isinstance(n, tht.optim.OptimizerOp)]
    assert all(isinstance(g, DequantizeCommOp) for g in opt.inputs)
    assert len(check_quantized_collectives([opt])) == len(opt.inputs)
    lq = _losses(x, ex_q, feed)
    x, ex = _mlp(tht, None)     # the same seed: the same initial values
    le = _losses(x, ex, feed)
    assert lq[-1] < lq[0]
    assert abs(lq[-1] - le[-1]) < 0.05


def test_env_knob_activates_splice(monkeypatch):
    monkeypatch.setenv("HETU_COMM_QUANT", "int8")
    assert tht.dist.DataParallel()._quantized()
    x, ex = _mlp(tht, None)
    (opt,) = [n for n in ex.eval_node_dict["train"]
              if isinstance(n, tht.optim.OptimizerOp)]
    assert isinstance(opt.inputs[0], DequantizeCommOp)
    monkeypatch.delenv("HETU_COMM_QUANT")
    assert not tht.dist.DataParallel()._quantized()
    assert tht.dist.DataParallel(aggregate="allreduce")._quantized() is False


def test_int8_data_parallel_equals_jax_executor():
    """Under the whole-value view both packages' trio has one participant:
    the step's gradient is the global gradient through the codec."""
    rng = np.random.RandomState(5)
    feeds = [rng.randn(8, 32).astype(np.float32) for _ in range(4)]
    jx, jex = _mlp(jht, "int8", num_devices=2)
    x, ex = _mlp(tht, "int8", num_devices=2)
    ex.load_dict(jex.return_tensor_values())
    want = [float(np.asarray(jex.run("train", feed_dict={jx: f})[0]))
            for f in feeds]
    got = [float(ex.run("train", feed_dict={x: f})[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_per_rank_all_gather_sum():
    """The trio in the per-rank view over a virtual dp 4: the wire leg
    all-gathers (int8, scales), and each rank's result is the sum of the
    ranks' gradients within 4 x the codec's bound."""
    n = 4
    mesh = make_mesh({"dp": n}, device="cpu")
    rng = np.random.RandomState(13)
    xs = [rng.randn(8, 32).astype(np.float32) for _ in range(n)]
    trio = _trio()

    def body(comm, x):
        return _apply(trio, x, TraceContext(comm=comm))

    args = [(torch.from_numpy(x),) for x in xs]
    outs = run_per_rank(body, mesh, args)
    ref = np.sum(xs, axis=0)
    bound = sum(_err_bound(x) for x in xs)
    assert bound <= n * max(_err_bound(x) for x in xs)
    for o in outs:
        assert np.abs(o.numpy() - ref).max() <= bound
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())
    seq = check_collective_order(body, mesh, args)
    assert [s[0] for s in seq] == ["all_gather", "all_gather"]
    assert quantized_collectives(seq) == [seq[0]]
    assert seq[0][3] == ("int8",)
