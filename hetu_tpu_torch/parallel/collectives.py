"""Collectives over a mesh axis in the per-rank view, the counterpart of
``jax.lax``'s named-axis collectives under ``shard_map``.

:func:`run_per_rank` runs a function once per rank with a communicator
(``comm``) whose methods are the collectives of one axis:

- on a ``DeviceMesh`` this process runs its one rank, and the axis's
  process group carries them (NCCL on the card, gloo on the CPU);
- on a :class:`~.mesh.VirtualMesh` the virtual ranks run as threads of
  this process, in lockstep at each collective (a barrier), so that a
  collective sees every rank's value, as the devices of a JAX mesh do.

The collectives: ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``broadcast``, ``ppermute`` and ``all_to_all`` (``lax.all_to_all``
tiled; ``all_to_all_single`` over the axis group on a ``DeviceMesh``).
Every rank must call the same collectives in the same order, as under
SPMD.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from .mesh import VirtualMesh, axis_names, mesh_shape, rank_coords

# a virtual rank that waits this long at a collective for its peers
# gives up (a peer raised or diverged)
_BARRIER_TIMEOUT_S = 600


class _Comm:
    """The collectives of one rank; ``coords`` its {axis: index}."""

    def __init__(self, mesh, coords):
        self.mesh = mesh
        self.coords = coords
        self.shape = mesh_shape(mesh)
        self.axes = axis_names(mesh)

    def has_axis(self, axis):
        return axis in self.axes

    def index(self, axis):
        return self.coords.get(axis, 0)

    def size(self, axis):
        return self.shape.get(axis, 1)

    # the collectives, each over ``axis``: the group of ranks whose
    # other coordinates equal this rank's
    def all_reduce(self, x, axis):
        return self._sum(self._group_values(x, axis))

    def all_gather(self, x, axis, dim=0):
        return torch.cat(self._group_values(x, axis), dim=dim)

    def reduce_scatter(self, x, axis, dim=0):
        total = self.all_reduce(x, axis)
        return total.chunk(self.size(axis), dim=dim)[self.index(axis)]

    def broadcast(self, x, axis, root=0):
        return self._group_values(x, axis)[root]

    def ppermute(self, x, axis, shift):
        """The value of the rank ``shift`` places before this one on
        ``axis`` (a rotation: +1 sends to the successor)."""
        n = self.size(axis)
        return self._group_values(x, axis)[(self.index(axis) - shift) % n]

    def all_to_all(self, x, axis, split_dim, concat_dim):
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
        ``x`` cut into n equal blocks along ``split_dim``, block j sent to
        the rank of index j on ``axis``, and the blocks received joined
        along ``concat_dim`` in their senders' order.  (The JAX call sites'
        untiled form splits a dim of size n into blocks of one, which is
        this on the same tensor.)"""
        n = self.size(axis)
        _check_split(x, axis, split_dim, n)
        me = self.index(axis)
        return torch.cat([v.chunk(n, dim=split_dim)[me]
                          for v in self._group_values(x, axis)],
                         dim=concat_dim)

    @staticmethod
    def _sum(vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out


class _VirtualHub:
    """The shared state of the virtual ranks of one run."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=_BARRIER_TIMEOUT_S)
        self.slots = [None] * n


class VirtualComm(_Comm):
    def __init__(self, mesh, coords, rank, hub):
        super().__init__(mesh, coords)
        self.rank = rank
        self.hub = hub

    def _group_values(self, x, axis):
        hub = self.hub
        hub.slots[self.rank] = x
        hub.barrier.wait()
        n = self.size(axis)
        strides = _strides(self.mesh)
        base = self.rank - self.index(axis) * strides.get(axis, 0)
        vals = [hub.slots[base + i * strides.get(axis, 0)]
                for i in range(n)]
        hub.barrier.wait()
        return vals


class ProcessComm(_Comm):
    """This process's rank of a ``DeviceMesh``."""

    def __init__(self, mesh):
        super().__init__(mesh, rank_coords(mesh)[0])

    def group(self, axis):
        return self.mesh.get_group(axis)

    def peer(self, axis, index):
        """The global rank of ``index`` on this rank's ``axis`` group."""
        return dist.get_global_rank(self.group(axis), index % self.size(axis))

    def _group_values(self, x, axis):
        # a group of one gathers too: a one-rank world still goes through
        # the backend
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size(axis))]
        dist.all_gather(out, x, group=self.group(axis))
        return out

    def all_reduce(self, x, axis):
        # a group of one reduces too: a one-rank world still goes through
        # the backend
        y = x.clone()
        dist.all_reduce(y, group=self.group(axis))
        return y

    def broadcast(self, x, axis, root=0):
        if self.size(axis) == 1:
            return x
        y = x.contiguous().clone()
        dist.broadcast(y, src=self.peer(axis, root), group=self.group(axis))
        return y

    def all_to_all(self, x, axis, split_dim, concat_dim):
        # one all_to_all_single over the axis group: the split dim moved
        # to the front, so that block j of it goes to rank j; a group of
        # one exchanges too (a one-rank world still goes through the
        # backend)
        n = self.size(axis)
        _check_split(x, axis, split_dim, n)
        send = x.movedim(split_dim, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group(axis))
        return torch.cat([b.movedim(0, split_dim)
                          for b in recv.chunk(n, dim=0)], dim=concat_dim)

    def ppermute(self, x, axis, shift):
        n = self.size(axis)
        if n == 1:
            return x
        me = self.index(axis)
        out = torch.empty_like(x)
        send_recv(x.contiguous(), self.peer(axis, me + shift), out,
                  self.peer(axis, me - shift), self.group(axis))
        return out


def _check_split(x, axis, split_dim, n):
    if x.shape[split_dim] % n:
        raise ValueError(
            f"all_to_all over {axis!r} (size {n}): dim {split_dim} of shape "
            f"{tuple(x.shape)} does not split into {n} equal blocks")


def send_recv(send, dst, recv, src, group):
    """Send ``send`` to global rank ``dst`` and receive into ``recv`` from
    ``src`` (either may be None) in one batch, and wait for both."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send, dst, group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return recv


def _strides(mesh):
    """{axis: the rank distance of one step along it} (row-major)."""
    out, step = {}, 1
    for a, s in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        out[a] = step
        step *= s
    return out


def run_per_rank(fn, mesh, args_per_rank=None):
    """``fn(comm, *args)`` for each rank this process runs, in the per-rank
    view: on a ``DeviceMesh`` once, with ``args_per_rank`` this rank's
    argument tuple, returning its result; on a ``VirtualMesh`` once per
    virtual rank (threads, row-major rank order), with
    ``args_per_rank[r]`` rank r's tuple, returning the list of results."""
    if not isinstance(mesh, VirtualMesh):
        return fn(ProcessComm(mesh), *(args_per_rank or ()))
    coords = rank_coords(mesh)
    n = len(coords)
    args = args_per_rank or [()] * n
    hub = _VirtualHub(n)
    results, errors = [None] * n, [None] * n

    def one(r):
        try:
            results[r] = fn(VirtualComm(mesh, coords[r], r, hub), *args[r])
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors[r] = e
            hub.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results
