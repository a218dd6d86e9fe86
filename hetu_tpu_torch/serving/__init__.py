"""Serving for the PyTorch port: the continuous-batching engine over the
slot-contiguous cache or the block-table paged KV pool, with the
phase-split or the mixed-mode scheduler."""

from .engine import QueueFull, ServingEngine  # noqa: F401
from .kv_manager import (KVCacheManager, PagedKVManager,  # noqa: F401
                         assemble_mixed_wave)
from .metrics import ServingMetrics  # noqa: F401
from .request import Request, Result  # noqa: F401

__all__ = ["KVCacheManager", "PagedKVManager", "QueueFull", "Request",
           "Result", "ServingEngine", "ServingMetrics",
           "assemble_mixed_wave"]
