"""The port's collective-order check
(``hetu_tpu_torch.parallel.collective_check``) on the six cases of the
JAX package's ``tests/test_collective_check.py``, in the per-rank idiom:
a program is ``fn(comm, x)`` as ``run_per_rank`` runs it, and a branch on
``comm.index(axis)`` takes the place of JAX's ``lax.cond`` on
``axis_index``.  The check runs every rank over a recording
communicator, so no case needs its peers: a divergent program raises
before any real collective runs."""

import pytest
import torch

from hetu_tpu_torch.parallel import (CollectiveOrderError,
                                     check_collective_order, make_mesh)
from hetu_tpu_torch.parallel.collective_check import quantized_collectives


@pytest.fixture(autouse=True)
def _one_thread():
    # tiny tensors: one intra-op thread is the fastest, and many
    # processes of the suite share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"dp": 8}, device="cpu")


def ones(n=8):
    return [(torch.ones(8),)] * n


def test_straightline_sequence_reported(mesh):
    def body(comm, x):
        y = comm.all_reduce(x, "dp")
        return comm.ppermute(y, "dp", 1)

    seq = check_collective_order(body, mesh, ones())
    assert [s[0] for s in seq] == ["all_reduce", "ppermute"]
    assert seq[0] == ("all_reduce", "dp", ((8,),), ("float32",))
    assert quantized_collectives(seq) == []


def test_divergent_branch_flagged(mesh):
    def body(comm, x):
        if comm.index("dp") < 4:
            return comm.all_reduce(x, "dp")
        return x * 2.0

    with pytest.raises(CollectiveOrderError, match=r"ranks 0 .* and 4 "):
        check_collective_order(body, mesh, ones())


def test_same_type_different_order_flagged(mesh):
    def b0(comm, v):
        return comm.ppermute(comm.all_reduce(v, "dp") + 0 * v, "dp", 1)

    def b1(comm, v):
        return comm.all_reduce(comm.ppermute(v, "dp", 1), "dp") * 0 \
            + 0 * v + comm.ppermute(0 * v, "dp", 1)

    def body(comm, x):
        return (b0 if comm.index("dp") < 4 else b1)(comm, x)

    with pytest.raises(CollectiveOrderError, match="entry 0"):
        check_collective_order(body, mesh, ones())


def test_matching_branches_pass(mesh):
    def body(comm, x):
        if comm.index("dp") < 4:
            return comm.all_reduce(x * 2, "dp")
        return comm.all_reduce(x + 1, "dp")

    seq = check_collective_order(body, mesh, ones())
    assert len([s for s in seq if s[0] == "all_reduce"]) == 1


def test_loop_bodies_walked(mesh):
    def body(comm, x):
        for _ in range(3):
            x = comm.all_reduce(x, "dp")
        return x

    seq = check_collective_order(body, mesh, ones())
    assert [s[0] for s in seq] == ["all_reduce"] * 3


def test_pipeline_body_is_clean():
    """A stage rotation over 'pp' of a pp 4 x dp 2 mesh passes, with the
    shapes and dtypes of each rank's own input; a dp-dependent dtype on
    the wire is a divergence."""
    pp_mesh = make_mesh({"pp": 4, "dp": 2}, device="cpu")

    def body(comm, x):
        return comm.ppermute(x, "pp", 1)

    args = [(torch.ones(2),)] * 8
    seq = check_collective_order(body, pp_mesh, args)
    assert seq[0][0] == "ppermute" and seq[0][1] == "pp"
    mixed = [(torch.ones(2, dtype=torch.int8 if r % 2 else torch.float32),)
             for r in range(8)]
    with pytest.raises(CollectiveOrderError, match="ranks 0 .* and 1 "):
        check_collective_order(body, pp_mesh, mixed)
