"""Device meshes with named axes, the port of ``hetu_tpu/parallel/mesh.py``
as far as context parallelism needs it: ``MeshAxes``, ``make_mesh`` and
``local_device_count``.

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


def _resolve_sizes(axes):
    if isinstance(axes, MeshAxes):
        axes = {k: getattr(axes, k) for k in AXIS_ORDER}
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not among "
                         f"{AXIS_ORDER}")
    sizes = {k: int(v) for k, v in axes.items()}
    if any(v < 1 for v in sizes.values()):
        raise ValueError(f"mesh {sizes}: every size must be >= 1")
    names = tuple(a for a in AXIS_ORDER if sizes.get(a, 1) > 1) \
        or (next(iter(sizes), "dp"),)
    return names, tuple(sizes.get(a, 1) for a in names)


def make_mesh(axes, *, device=None):
    """A mesh from explicit axis sizes: ``axes`` is a :class:`MeshAxes`
    or a dict such as ``{"dp": 2, "cp": 4}``.  Axes of size 1 are
    dropped and the rest ordered as :data:`AXIS_ORDER`, as the JAX
    package does.

    Under ``torch.distributed`` it is a ``DeviceMesh`` over the world
    (its product must equal the world size; device type ``cuda`` with
    NCCL, ``cpu`` with gloo).  Otherwise it is a :class:`VirtualMesh` on
    ``device``: the card unless ``device="cpu"`` is asked for, and any
    size, since its ranks are virtual."""
    names, dims = _resolve_sizes(axes)
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size()
        if math.prod(dims) != world:
            raise ValueError(f"mesh {dict(zip(names, dims))} needs "
                             f"{math.prod(dims)} ranks, the world has "
                             f"{world}")
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(kind, dims, mesh_dim_names=names)
    return VirtualMesh(names, dims, resolve_device(device))


def axis_size(mesh, axis):
    """The size of ``axis`` on either kind of mesh (1 if absent)."""
    if isinstance(mesh, VirtualMesh):
        return mesh.shape.get(axis, 1)
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1
