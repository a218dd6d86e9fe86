"""Parallelism in the port: meshes and context parallelism (ring
attention on the carried flash kernel, Ulysses, blockwise attention).
The rest of the JAX package's ``parallel/`` (partition, strategies,
pipeline, preduce, collective checks) is not ported yet."""

from .mesh import MeshAxes, VirtualMesh, local_device_count, make_mesh
from . import context_parallel
from .context_parallel import (blockwise_attention, ring_attention,
                               ulysses_attention)

__all__ = ["MeshAxes", "VirtualMesh", "blockwise_attention",
           "context_parallel", "local_device_count", "make_mesh",
           "ring_attention", "ulysses_attention"]
