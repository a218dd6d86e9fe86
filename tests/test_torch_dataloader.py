"""The port's ``Dataloader`` and its graph feeds against the JAX
package's, on the CPU:

- batch sequences over several epochs (shuffle, drop_last, a partial
  tail, dp rank, a batch shard) equal the JAX loader's exactly, and so
  do ``state_dict``/``load_state_dict`` fast-forwards mid-epoch;
- the prefetch ring hands out the serial order, and a producer's error
  surfaces at ``get_arr``;
- a graph fed by ``dataloader_op`` trains the same with ``prefetch`` on
  and off (losses and variables bit-equal), and its losses equal the
  JAX executor's over the same loaders; ``batch_num``.

The ring's copies onto a card are held in
``test_torch_dataloader_cuda.py``.
"""

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

import hetu_tpu as jm
from hetu_tpu import dataloader as jdl
import hetu_tpu_torch.graph as tm
from hetu_tpu_torch import dataloader as tdl


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    # the graph verifier (HETU_VALIDATE) is not in the port yet (A11)
    monkeypatch.setenv("HETU_VALIDATE", "0")


DATA = np.random.RandomState(0).randn(23, 3)          # float64: coerced


CASES = [dict(batch_size=4), dict(batch_size=4, shuffle=True, seed=3),
         dict(batch_size=5, drop_last=False),
         dict(batch_size=5, drop_last=False, shuffle=True, seed=1),
         dict(batch_size=3, shuffle=True, dp=(1, 2)),
         dict(batch_size=4, shuffle=True, shard=(1, 3))]


def _pair(case):
    case = dict(case)
    dp, shard = case.pop("dp", None), case.pop("shard", None)
    out = []
    for m in (jdl, tdl):
        ld = m.Dataloader(DATA, name="train", **case)
        if dp:
            ld.set_dp_rank(*dp)
        if shard:
            ld.set_batch_shard(*shard)
        out.append(ld)
    return out


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_batch_sequences_and_fast_forward_equal_jax(case):
    jl, tl = _pair(case)
    for i in range(17):                      # several epochs
        np.testing.assert_array_equal(tl.get_arr(), jl.get_arr(),
                                      err_msg=f"batch {i}")
    assert tl.state_dict() == jl.state_dict()
    jl.init_states()
    tl.init_states()
    assert tl.batch_num == jl.batch_num
    for consumed in (0, 3, tl.batch_num, 2 * tl.batch_num + 1):
        jl2, tl2 = _pair(case)
        state = {"consumed": consumed, "seed": jl2.seed,
                 "shuffle": jl2.shuffle}
        jl2.load_state_dict(state)
        tl2.load_state_dict(state)
        for _ in range(5):
            np.testing.assert_array_equal(tl2.get_arr(), jl2.get_arr())


def test_ring_order_and_producer_error():
    serial, ring = (tdl.Dataloader(DATA, 4, shuffle=True, seed=2)
                    for _ in range(2))
    ring.start_prefetch()
    try:
        for _ in range(12):
            np.testing.assert_array_equal(ring.get_arr(), serial.get_arr())
        np.testing.assert_array_equal(ring.peek_arr(), serial.peek_arr())
    finally:
        ring.stop_prefetch()
    calls = []

    def producer():
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("bad batch")
        return np.zeros(2)

    r = tdl._PrefetchRing(producer, depth=2)
    r.get()
    r.get()
    with pytest.raises(ValueError, match="bad batch"):
        r.get()
    r.stop()


def _graph(m, x_dl, y_dl, lr=0.1):
    w = m.init.random_normal((3, 2), stddev=0.5, name="w")
    b = m.init.zeros((2,), name="b")
    logits = m.matmul_op(x_dl, w) + m.broadcastto_op(b, m.matmul_op(x_dl, w))
    loss = m.reduce_mean_op(m.softmaxcrossentropy_op(logits, y_dl), axes=0)
    return loss, m.optim.SGDOptimizer(learning_rate=lr).minimize(loss)


def _labels():
    return np.eye(2, dtype=np.float32)[(DATA[:, 0] > 0).astype(int)]


def _train(m, steps, prefetch, init=None):
    x = m.dataloader_op([m.Dataloader(DATA, 4, "train", shuffle=True,
                                      seed=5)])
    y = m.dataloader_op([m.Dataloader(_labels(), 4, "train", shuffle=True,
                                      seed=5)])
    loss, train = _graph(m, x, y)
    if m is jm:
        ex = jm.Executor({"train": [loss, train]}, prefetch=prefetch)
    else:
        ex = tm.Executor({"train": [loss, train]}, prefetch=prefetch,
                         device="cpu")
    if init is not None:
        ex.load_dict(init)
    losses = [float(np.asarray(ex.run("train")[0])) for _ in range(steps)]
    return ex, losses


def test_prefetch_on_and_off_train_alike_and_equal_jax():
    jex, _ = _train(jm, 0, True)
    init = jex.return_tensor_values()
    jl = [float(np.asarray(jex.run("train")[0])) for _ in range(12)]
    runs = {}
    for prefetch in (True, False):
        ex, losses = _train(tm, 12, prefetch, init)
        runs[prefetch] = (losses, ex.return_tensor_values(), ex.batch_num)
    assert runs[True][0] == runs[False][0]
    for k, v in runs[True][1].items():
        assert np.array_equal(v, runs[False][1][k]), k
    assert runs[True][2] == 5 == jex.batch_num
    np.testing.assert_allclose(runs[True][0], jl, rtol=1e-5)
