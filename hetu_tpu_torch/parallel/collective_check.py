"""Collective-order check for hand-written per-rank programs, the port
of the JAX package's ``parallel/collective_check.py``.

A per-rank program (``fn(comm, *args)``, run by
``parallel.collectives.run_per_rank``) deadlocks or mixes data when its
ranks disagree on the sequence of collectives: under SPMD the realistic
way is a branch on ``comm.index(axis)`` with a collective on one side
only, or the same collectives in another order.  JAX traces its
shard_map program and compares the branches of each ``lax.cond``; eager
torch has no trace, so :func:`check_collective_order` runs ``fn`` once
for every rank of the mesh over a recording communicator that exchanges
nothing (each collective returns a result of the right shape and dtype,
not the collective's values), records each rank's sequence of
``(collective, axis, shapes, dtypes)`` and raises
:class:`CollectiveOrderError` naming the first two ranks that disagree,
before any real collective runs.  The dtypes are in the signature, so an
int8 (quantized) leg differs from its f32 twin.
"""

from __future__ import annotations

import itertools

from .collectives import _Comm
from .mesh import axis_names, mesh_shape


class CollectiveOrderError(AssertionError):
    pass


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


class RecordingComm(_Comm):
    """A rank's communicator that records its collectives and exchanges
    nothing: every peer's value is taken to be this rank's own."""

    def __init__(self, mesh, coords):
        super().__init__(mesh, coords)
        self.sequence = []

    def _group_values(self, x, axis):
        return [x] * self.size(axis)

    def _record(self, name, axis, x):
        self.sequence.append((name, axis, (tuple(x.shape),),
                              (_dtype(x),)))

    def all_reduce(self, x, axis):
        self._record("all_reduce", axis, x)
        return super().all_reduce(x, axis)

    def all_gather(self, x, axis, dim=0):
        self._record("all_gather", axis, x)
        return super().all_gather(x, axis, dim)

    def reduce_scatter(self, x, axis, dim=0):
        self._record("reduce_scatter", axis, x)
        return super().reduce_scatter(x, axis, dim)

    def broadcast(self, x, axis, root=0):
        self._record("broadcast", axis, x)
        return super().broadcast(x, axis, root)

    def ppermute(self, x, axis, shift):
        self._record("ppermute", axis, x)
        return super().ppermute(x, axis, shift)


def _all_coords(mesh):
    """{axis: index} of every rank of ``mesh``, row-major (either kind of
    mesh: a ``DeviceMesh``'s other processes' ranks too)."""
    names = axis_names(mesh)
    shape = mesh_shape(mesh)
    return [dict(zip(names, c))
            for c in itertools.product(*(range(shape[a]) for a in names))]


def check_collective_order(fn, mesh, args_per_rank=None):
    """Run ``fn(comm, *args_per_rank[r])`` for every rank r of ``mesh``
    (row-major) over a :class:`RecordingComm` and check that every rank
    issues the same collectives in the same order.  Returns the sequence
    [(collective, axis, shapes, dtypes), ...]; raises
    :class:`CollectiveOrderError` naming the first two ranks that
    disagree and the first entry where they do."""
    coords = _all_coords(mesh)
    args = args_per_rank or [()] * len(coords)
    seqs = []
    for r, c in enumerate(coords):
        comm = RecordingComm(mesh, c)
        fn(comm, *args[r])
        seqs.append(comm.sequence)
    for r, s in enumerate(seqs[1:], 1):
        if s != seqs[0]:
            at = next((i for i, (a, b) in enumerate(zip(seqs[0], s))
                       if a != b), min(len(s), len(seqs[0])))
            first = seqs[0][at] if at < len(seqs[0]) else "none"
            other = s[at] if at < len(s) else "none"
            raise CollectiveOrderError(
                f"ranks 0 {coords[0]} and {r} {coords[r]} disagree on "
                f"their collectives at entry {at}: rank 0 issues "
                f"{first}, rank {r} issues {other} (rank 0: "
                f"{seqs[0] or 'none'}; rank {r}: {s or 'none'}) — the "
                f"axis would deadlock or mix data")
    return seqs[0]


def quantized_collectives(seq):
    """The int8-carrying entries of a recorded sequence: the wire legs of
    ``graph/ops_comm``'s quantize -> collective -> dequantize trios."""
    return [s for s in seq
            if len(s) > 3 and any(d == "int8" for d in s[3])]
