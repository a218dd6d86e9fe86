"""Where a variable's values live on a mesh: each rank stores its shard
of the master (and of its optimizer slots) under the variable's
``sharding_spec``, and a step gathers the whole value where it reads it.

A spec is JAX's ``PartitionSpec`` as a tuple: per dimension a mesh axis
name or None (``("tp", None)`` splits dim 0 over ``tp``); None, or all
None, is replicated.  Dimension d split over an axis of size n keeps
piece ``coords[axis]`` of n equal pieces.

- On a ``DeviceMesh`` a sharded value is a :class:`Shards` holding this
  rank's one piece, and gathering is an all-gather over each spec axis's
  process group.
- On a ``VirtualMesh`` every virtual rank shares one device, so pieces
  would save nothing: the whole tensor is stored, and
  :func:`rank_pieces` gives each virtual rank's piece as a view.

The graph executor computes the Megatron pattern per rank on these
pieces (``graph/tensor_parallel.py``); any other reader of a split
value gathers it whole.

:class:`Placed` is the serving side's placement: a parameter split over
one mesh axis (Megatron-style by ``models.gpt_decode.tp_shard_params``,
by expert by ``models.moe_decode.ep_shard_params``), the placement
riding the tensor, and :class:`AxisGroup` the ranks of its mesh axis
that this process runs.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..weights import prep_param
from .collectives import ProcessComm
from .mesh import (VirtualMesh, axis_names, axis_size, mesh_shape,
                   rank_coords)


def norm_spec(spec):
    """A spec as a tuple with trailing Nones dropped; None when it splits
    nothing.  Accepts JAX-style objects that iterate (``PartitionSpec``)."""
    if spec is None:
        return None
    t = tuple(spec)
    while t and t[-1] is None:
        t = t[:-1]
    if not any(a is not None for a in t):
        return None
    for a in t:
        if a is not None and not isinstance(a, str):
            raise NotImplementedError(
                f"sharding spec {t}: a dimension split over several axes "
                f"is not in hetu_tpu_torch yet (ROADMAP A9b item 2)")
    return t


class Shards:
    """This rank's ``piece`` of a value split under ``spec`` over a
    ``DeviceMesh``; ``shape`` is the whole value's."""

    def __init__(self, spec, shape, piece):
        self.spec = spec
        self.shape = tuple(shape)
        self.piece = piece

    @property
    def dtype(self):
        return self.piece.dtype


def _split_axes(spec):
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def _piece(full, spec, coords, sizes):
    """The view of ``full`` that the rank at ``coords`` holds."""
    out = full
    for d, a in _split_axes(spec):
        out = out.chunk(sizes[a], dim=d)[coords[a]]
    return out


def place(full, spec, mesh):
    """``full`` stored under ``spec`` on ``mesh``: this rank's
    :class:`Shards` on a ``DeviceMesh``, else the tensor itself (checked
    against the spec)."""
    spec = norm_spec(spec)
    if spec is None or not isinstance(full, torch.Tensor):
        return full
    sizes = mesh_shape(mesh)
    for d, a in _split_axes(spec):
        if a not in sizes:
            raise ValueError(f"sharding spec {spec} names axis {a!r}, absent "
                             f"from mesh axes {axis_names(mesh)}")
        if full.shape[d] % sizes[a]:
            raise ValueError(f"dimension {d} of shape {tuple(full.shape)} "
                             f"does not divide over mesh axis {a!r} "
                             f"(size {sizes[a]})")
    if isinstance(mesh, VirtualMesh):
        return full
    piece = _piece(full, spec, rank_coords(mesh)[0], sizes)
    return Shards(spec, full.shape, piece.contiguous())


def gather(value, mesh):
    """The whole value of a stored one (a :class:`Shards` or a tensor)."""
    if not isinstance(value, Shards):
        return value
    out = value.piece
    comm = ProcessComm(mesh)
    for d, a in _split_axes(value.spec):
        out = comm.all_gather(out, a, dim=d)
    return out


def rank_pieces(value, spec, mesh):
    """What each rank this process runs holds of ``value`` stored under
    ``spec``: a list in ``rank_coords`` order (views on a
    ``VirtualMesh``)."""
    if isinstance(value, Shards):
        return [value.piece]
    spec = norm_spec(spec)
    if spec is None:
        return [value for _ in rank_coords(mesh)]
    sizes = mesh_shape(mesh)
    return [_piece(value, spec, c, sizes) for c in rank_coords(mesh)]


def place_tree(tree, like_shape, spec, mesh):
    """Place every tensor leaf of ``tree`` shaped like its variable
    (optimizer slots: zeros_like(param)) under the variable's spec."""
    return pytree.tree_map(
        lambda x: place(x, spec, mesh)
        if isinstance(x, torch.Tensor) and tuple(x.shape) == like_shape
        else x, tree)


def gather_tree(tree, mesh):
    return pytree.tree_map(lambda x: gather(x, mesh), tree,
                           is_leaf=lambda x: isinstance(x, Shards))


# ------------------- serving placement over one mesh axis ------------------- #


class AxisGroup:
    """The ranks of ``axis`` of ``mesh`` that this process runs: all
    ``n`` of a ``VirtualMesh`` (in turn, each on its own pieces), or this
    process's one rank of a ``DeviceMesh``.  ``all_reduce`` sums one
    partial per local rank: in rank order on a ``VirtualMesh`` (as its
    collectives sum), over the axis's process group on a
    ``DeviceMesh``."""

    def __init__(self, mesh, axis):
        self.mesh, self.axis = mesh, axis
        self.n = axis_size(mesh, axis)
        self.virtual = isinstance(mesh, VirtualMesh)
        if self.virtual:
            self.comm = None
            self.ranks = tuple(range(self.n))
        else:
            self.comm = ProcessComm(mesh)
            self.ranks = (self.comm.index(axis),)

    def piece(self, t, r):
        """Rank ``r``'s piece of a :class:`Placed` tensor as a plain
        contiguous tensor (:meth:`Placed.rank_pieces`); any other tensor
        (or None) is whole on every rank."""
        if not isinstance(t, Placed):
            return t
        return t.rank_pieces()[self.ranks.index(r)]

    def all_reduce(self, parts):
        if self.virtual:
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return self.comm.all_reduce(parts[0], self.axis)

    def join(self, parts, dim):
        """The whole value of per-rank pieces split on ``dim``."""
        if self.virtual:
            return torch.cat(parts, dim=dim)
        return self.comm.all_gather(parts[0], self.axis, dim=dim)

    def split(self, whole, dim):
        """The local ranks' pieces of a whole value, stacked on a new
        leading dim (the rank-major layout of a tensor-parallel KV
        cache)."""
        pieces = whole.chunk(self.n, dim=dim)
        return torch.stack([pieces[r] for r in self.ranks])


class Placed(torch.Tensor):
    """A serving parameter split on ``place_dim`` over the mesh axis of
    ``place_group`` (an :class:`AxisGroup`), the placement riding the
    tensor as a JAX array's ``NamedSharding`` does: a q/k/v or FFN
    weight placed by ``models.gpt_decode.tp_shard_params`` (the Megatron
    column or row split), an expert stack by
    ``models.moe_decode.ep_shard_params`` (dim 0).  On a ``VirtualMesh``
    the tensor is the whole value; on a ``DeviceMesh`` it is this rank's
    piece.  What the engine does to a parameter (``to``, ``contiguous``,
    ``clone``, an in-place ``copy_``) keeps the placement; every other
    operation returns a plain tensor."""

    _KEEP = frozenset((torch.Tensor.to, torch.Tensor.contiguous,
                       torch.Tensor.clone, torch.Tensor.copy_))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        if func in cls._KEEP and type(out) is torch.Tensor:
            return placed(out, args[0].place_group, args[0].place_dim)
        return out

    def rank_pieces(self):
        """Each local rank's piece as a plain contiguous tensor, in the
        order of the group's ranks: cut once and kept until the tensor
        is written in place (its version counter moves, as under
        ``swap_params``' ``copy_``), so a serving step slices nothing.
        An inference-mode tensor tracks no version: cut on every call."""
        cache = self.__dict__.get("_pieces")
        version = None if self.is_inference() else self._version
        if cache is None or version is None or cache[0] != version:
            whole = self.as_subclass(torch.Tensor)
            g = self.place_group
            pieces = ([c.contiguous()
                       for c in whole.chunk(g.n, dim=self.place_dim)]
                      if g.virtual else [whole])
            cache = self._pieces = (version, pieces)
        return cache[1]


def placed(t, group, dim):
    """``t`` tagged as split on ``dim`` over ``group``."""
    s = t.as_subclass(Placed)
    s.place_group, s.place_dim = group, dim
    return s


def placement(t):
    """(mesh, axis, dim) of a :class:`Placed` tensor, else None."""
    if isinstance(t, Placed):
        g = t.place_group
        return g.mesh, g.axis, t.place_dim
    return None


def group_of(t):
    """The :class:`AxisGroup` of a :class:`Placed` tensor, else None."""
    return t.place_group if isinstance(t, Placed) else None


def _stores_piece(t):
    """True when ``t`` holds one ``DeviceMesh`` rank's piece only."""
    return isinstance(t, Placed) and not t.place_group.virtual


def whole_shape(t):
    """The whole value's shape of a parameter (its own shape unless it
    is one ``DeviceMesh`` rank's piece)."""
    shape = tuple(t.shape)
    if not _stores_piece(t):
        return shape
    d = t.place_dim
    return shape[:d] + (shape[d] * t.place_group.n,) + shape[d + 1:]


def _rank_slice(value, group, dim):
    """This ``DeviceMesh`` rank's piece of a whole ``value`` (a numpy
    array or a tensor) split on ``dim`` over ``group``."""
    m = value.shape[dim] // group.n
    r = group.ranks[0]
    return value[(slice(None),) * dim + (slice(r * m, (r + 1) * m),)]


def local_value(resident, value):
    """What ``resident`` stores of a whole new ``value`` (a numpy array
    or a tensor): a ``DeviceMesh`` rank's piece, else the value itself."""
    if not _stores_piece(resident):
        return value
    return _rank_slice(value, resident.place_group, resident.place_dim)


def mesh_device(mesh):
    """Where a mesh's values live: a ``VirtualMesh``'s device, or this
    rank's card (or CPU) of a ``DeviceMesh``."""
    if isinstance(mesh, VirtualMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_params(params, name, mesh, axis, dim_of):
    """Model ``name``'s parameters of ``params`` on the mesh's device,
    each one whose key ``dim_of`` maps to a dim :class:`Placed` on it
    over ``axis`` (the whole value on a ``VirtualMesh``, this rank's
    piece on a ``DeviceMesh``), the rest whole."""
    group = AxisGroup(mesh, axis)
    dev = mesh_device(mesh)
    out = {}
    for k, v in params.items():
        if not k.startswith(name + "_"):
            continue
        d = dim_of(k)
        if d is None:
            out[k] = prep_param(v, dev)
            continue
        if not group.virtual:
            v = _rank_slice(v, group, d)
        out[k] = placed(prep_param(v, dev), group, d)
    return out
