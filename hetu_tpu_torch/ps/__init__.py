"""The parameter-server package of the PyTorch port.  Only the seeded
fault injector (``faults``: the ``HETU_CHAOS`` plans the serving fleet
draws from) is ported so far; the server, client, sharded client and
wire codec wait for ROADMAP A10."""

from .faults import FaultPlan  # noqa: F401

__all__ = ["FaultPlan"]
