"""Static checks of the PyTorch port.  So far the serving engine's
build-time check alone: ``validate_serving`` (``HETU_VALIDATE=1``), the
JAX package's ``analysis/integration.py`` hook with its two error types.
The graph verifier and parallelism checker wait for ROADMAP A11."""

from .integration import (  # noqa: F401
    GraphVerifyError, ShardCheckError, validate_serving,
    validation_enabled,
)

__all__ = ["GraphVerifyError", "ShardCheckError", "validate_serving",
           "validation_enabled"]
