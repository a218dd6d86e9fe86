"""Static checks of the PyTorch port: the serving engine's build-time
check ``validate_serving`` (``HETU_VALIDATE=1``), the JAX package's
``analysis/integration.py`` hook with its two error types, and the
static parallelism checks of ``shard_check``.  The graph verifier and
the executor's ``HETU_VALIDATE`` hook wait for ROADMAP A11."""

from .integration import (  # noqa: F401
    GraphVerifyError, ShardCheckError, validate_serving,
    validation_enabled,
)

__all__ = ["GraphVerifyError", "ShardCheckError", "validate_serving",
           "validation_enabled"]
