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

Only the stored pieces shrink, and only on a ``DeviceMesh``: a step
gathers whole values, computes with them and scatters what it writes
(the tensor-parallel compute split of a sharded matmul is not derived
from the specs, as XLA derives it).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .collectives import ProcessComm
from .mesh import VirtualMesh, axis_names, mesh_shape, rank_coords


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
