"""Serving for the PyTorch port: the continuous-batching engine over the
block-table paged KV pool with the mixed-mode scheduler."""

from .engine import QueueFull, ServingEngine  # noqa: F401
from .kv_manager import PagedKVManager, assemble_mixed_wave  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .request import Request, Result  # noqa: F401

__all__ = ["PagedKVManager", "QueueFull", "Request", "Result",
           "ServingEngine", "ServingMetrics", "assemble_mixed_wave"]
