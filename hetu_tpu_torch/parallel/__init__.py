"""Parallelism in the port: meshes, distribution strategies, the pipeline
schedules and pipelines, context parallelism (ring attention on the
carried flash kernel, Ulysses, blockwise attention), the per-rank
collectives with their order check (``collective_check``) and the
sharded storage of variables.

Not here yet: ``preduce`` (ROADMAP A10, it needs the parameter
server)."""

from .mesh import (MeshAxes, VirtualMesh, default_mesh, local_device_count,
                   make_mesh)
from . import pipeline
from .pipeline import (
    spmd_pipeline, spmd_pipeline_1f1b, stack_stage_params,
    shard_stacked_params,
    gpipe_schedule, one_f_one_b_schedule, PipelineStage, PipelineTrainer,
)
from . import context_parallel
from .context_parallel import (blockwise_attention, ring_attention,
                               ulysses_attention)
from . import distributed_strategies
from .collective_check import (CollectiveOrderError,  # noqa: F401
                               check_collective_order,
                               quantized_collectives)
from .distributed_strategies import (
    DataParallel, ModelParallel4LM, ExpertParallel, PipelineParallel4LM,
    FSDP, BaseSearchingStrategy, ShardingPlan,
)

__all__ = ["MeshAxes", "VirtualMesh", "blockwise_attention",
           "context_parallel", "default_mesh", "local_device_count",
           "make_mesh", "ring_attention", "ulysses_attention", "pipeline",
           "spmd_pipeline", "spmd_pipeline_1f1b", "stack_stage_params",
           "shard_stacked_params", "gpipe_schedule", "one_f_one_b_schedule",
           "PipelineStage", "PipelineTrainer", "distributed_strategies",
           "DataParallel", "ModelParallel4LM", "ExpertParallel",
           "PipelineParallel4LM", "FSDP", "BaseSearchingStrategy",
           "ShardingPlan", "CollectiveOrderError", "check_collective_order",
           "quantized_collectives"]
