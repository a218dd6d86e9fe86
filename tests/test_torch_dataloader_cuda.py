"""The dataloader ring's host-to-device step on a card (``cuda``-marked:
skipped without one; this file imports nothing of JAX, so it runs on
the card with ``python -m pytest --noconftest
tests/test_torch_dataloader_cuda.py``):

- the ring's batches arrive on the card through ``device_transform``
  (pinned, ``non_blocking`` on a side stream, the consumer waiting on
  the copy's event), coerced to f32/int32, in the serial order;
- a failing copy surfaces at ``get_arr``.
"""

import numpy as np
import pytest
import torch

from hetu_tpu_torch import dataloader as tdl

pytestmark = pytest.mark.cuda

DATA = np.random.RandomState(0).randn(23, 3)          # float64: coerced


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_ring_stages_batches_on_the_card(cuda):
    for data, dtype in ((DATA, torch.float32),
                        (np.arange(46).reshape(23, 2), torch.int32)):
        serial = tdl.Dataloader(data, 4, shuffle=True, seed=2)
        ring = tdl.Dataloader(data, 4, shuffle=True, seed=2)
        ring.start_prefetch(transform=tdl.device_transform(cuda))
        try:
            for _ in range(12):
                got = ring.get_arr()
                assert got.is_cuda and got.dtype == dtype
                np.testing.assert_array_equal(
                    got.cpu().numpy(), tdl.coerce(serial.get_arr()))
        finally:
            ring.stop_prefetch()


def test_a_failing_copy_surfaces_at_get(cuda):
    transform = tdl.device_transform(cuda)
    ring = tdl.Dataloader(np.array(["a", "b", "c", "d"]), 2)
    ring.start_prefetch(transform=transform)
    try:
        with pytest.raises(TypeError):
            ring.get_arr()
    finally:
        ring.stop_prefetch()
