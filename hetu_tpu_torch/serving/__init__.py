"""Serving for the PyTorch port: the continuous-batching engine over the
slot-contiguous cache or the block-table paged KV pool, with the
phase-split or the mixed-mode scheduler, and the serving fleet around
it — the health-aware router over supervised replicas
(``ServingRouter``), the prefill-to-decode KV handoff, the fleet prefix
directory, the tiered KV host ring (``TieredKVStore``), rolling weight
swaps (``WeightSyncCoordinator``), the autoscaler and the seeded traffic
generator."""

from ..telemetry.slo import SLO, SLOMonitor  # noqa: F401
from .autoscaler import FleetAutoscaler  # noqa: F401
from .engine import QueueFull, ServingEngine  # noqa: F401
from .kv_manager import (  # noqa: F401
    KVCacheManager, PagedKVManager, assemble_mixed_wave,
    resolve_handoff_quant, resolve_kv_block, resolve_kv_quant,
    round_up_pow2,
)
from .kv_tiers import TieredKVStore  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .prefix_directory import PrefixDirectory, prefix_hash  # noqa: F401
from .replica import Replica  # noqa: F401
from .request import Request, Result  # noqa: F401
from .router import RouterShed, ServingRouter  # noqa: F401
from .traffic import TrafficGenerator, TrafficSpec, replay  # noqa: F401
from .weight_sync import WeightSyncCoordinator  # noqa: F401

__all__ = ["FleetAutoscaler", "KVCacheManager", "PagedKVManager",
           "PrefixDirectory", "QueueFull", "Replica", "Request", "Result",
           "RouterShed", "SLO", "SLOMonitor", "ServingEngine",
           "ServingMetrics", "ServingRouter", "TieredKVStore",
           "TrafficGenerator", "TrafficSpec", "WeightSyncCoordinator",
           "assemble_mixed_wave", "prefix_hash", "replay",
           "resolve_handoff_quant", "resolve_kv_block", "resolve_kv_quant",
           "round_up_pow2"]
