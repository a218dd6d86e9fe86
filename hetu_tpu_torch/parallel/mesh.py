"""Device meshes with named axes, the port of ``hetu_tpu/parallel/mesh.py``:
``MeshAxes``, ``make_mesh``, ``default_mesh`` and ``local_device_count``,
with the helpers that read either kind of mesh alike (``axis_names``,
``mesh_shape``, ``axis_size``, ``rank_coords``).

A mesh is one of two kinds:

- a ``torch.distributed.device_mesh.DeviceMesh`` with named axes, the
  counterpart of ``jax.sharding.Mesh``, when ``torch.distributed`` is
  initialised: each rank holds its own shard, and an axis's process
  group carries the collectives (NCCL on the card, gloo on the CPU);
- a :class:`VirtualMesh`, one process whose ranks are virtual and share
  one device, the counterpart of the JAX tests' 8-host-device CPU mesh:
  the functions over it take the global arrays and run the ranks one
  after another.  It is what one card runs.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device

# canonical axis order, outermost first (hetu_tpu/parallel/mesh.py)
AXIS_ORDER = ("dcn", "pp", "dp", "ep", "cp", "tp")


@dataclass
class MeshAxes:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    cp: int = 1
    dcn: int = 1

    def total(self):
        return self.dp * self.tp * self.pp * self.ep * self.cp * self.dcn


@dataclass(frozen=True)
class VirtualMesh:
    """Named axes over virtual ranks in one process on ``device``;
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does."""
    axis_names: tuple
    sizes: tuple
    device: torch.device

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))


def local_device_count():
    """CUDA devices of this process's host (1 without a card: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _world_size():
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else None


def _resolve_sizes(axes, world):
    """(names, dims) by the JAX package's rules: the canonical axes of
    size > 1 in :data:`AXIS_ORDER`, then any other axis of size > 1
    innermost in the caller's order (e.g. ``'ici'`` for the hierarchical
    all-to-all); a single -1 is what the world leaves, which needs a
    world to count."""
    if isinstance(axes, MeshAxes):
        axes = {k: getattr(axes, k) for k in AXIS_ORDER}
    sizes = {k: int(v) for k, v in axes.items()}
    free = [k for k, v in sizes.items() if v == -1]
    if len(free) > 1 or any(v < 1 and v != -1 for v in sizes.values()):
        raise ValueError(f"mesh {sizes}: every size must be >= 1, or one "
                         f"of them -1")
    if free:
        if world is None:
            raise ValueError(
                f"mesh {sizes}: a size of -1 means all remaining devices, "
                f"and a VirtualMesh has no device count (its ranks are "
                f"virtual): give every size")
        sizes[free[0]] = world // math.prod(v for v in sizes.values()
                                            if v > 0)
    names = [a for a in AXIS_ORDER if sizes.get(a, 1) > 1]
    names += [a for a in sizes if a not in AXIS_ORDER and sizes[a] > 1]
    if not names:
        names = [next(iter(sizes))] if sizes else ["dp"]
    return tuple(names), tuple(sizes.get(a, 1) for a in names)


def make_mesh(axes=None, *, device=None, **kwargs):
    """A mesh from axis sizes: ``axes`` is a :class:`MeshAxes`, a dict
    such as ``{"dp": 2, "cp": 4}``, or keyword sizes
    (``make_mesh(pp=4)``).  Axes of size 1 are dropped, the canonical
    ones ordered as :data:`AXIS_ORDER` and any other appended innermost
    in the caller's order; one size may be -1, all remaining devices
    (JAX's rules).

    Under ``torch.distributed`` it is a ``DeviceMesh`` over the world
    (its product must equal the world size; device type ``cuda`` with
    NCCL, ``cpu`` with gloo).  Otherwise it is a :class:`VirtualMesh` on
    ``device``: the card unless ``device="cpu"`` is asked for, and any
    size, since its ranks are virtual."""
    if axes is None:
        axes = kwargs
    world = _world_size()
    names, dims = _resolve_sizes(axes, world)
    if world is not None:
        from torch.distributed.device_mesh import init_device_mesh
        if math.prod(dims) != world:
            raise ValueError(f"mesh {dict(zip(names, dims))} needs "
                             f"{math.prod(dims)} ranks, the world has "
                             f"{world}")
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(kind, dims, mesh_dim_names=names)
    return VirtualMesh(names, dims, resolve_device(device))


def default_mesh(dp=None, *, device=None):
    """Every device on one ``'dp'`` axis (the AllReduce data-parallel
    default): the world under ``torch.distributed``, else a virtual mesh
    of ``dp`` ranks, one unless given (its ranks share one device, so
    the host's other cards would add nothing)."""
    n = dp or _world_size() or 1
    return make_mesh({"dp": n}, device=device)


def axis_names(mesh):
    """The axis names of either kind of mesh, outermost first."""
    if isinstance(mesh, VirtualMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh):
    """{axis: size} of either kind of mesh, as ``jax.sharding.Mesh.shape``."""
    if isinstance(mesh, VirtualMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def axis_size(mesh, axis):
    """The size of ``axis`` on either kind of mesh (1 if absent)."""
    return mesh_shape(mesh).get(axis, 1)


def rank_coords(mesh):
    """The coordinates {axis: index} of each rank this process runs: every
    virtual rank of a :class:`VirtualMesh`, in row-major order over its
    axes, or this process's one rank of a ``DeviceMesh``."""
    names = axis_names(mesh)
    if isinstance(mesh, VirtualMesh):
        return [dict(zip(names, c))
                for c in itertools.product(*(range(s) for s in mesh.sizes))]
    return [{a: mesh.get_local_rank(a) for a in names}]
