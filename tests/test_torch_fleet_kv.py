"""Fleet-wide KV on port engines, on the CPU: the scenarios of the JAX
package's ``tests/test_fleet_kv.py`` run unchanged on the port
(``torch_fleet_shim``) and are held to that file's own assertions.

- The prefix directory's unit surface (register, longest cut, short
  prompts, eviction, replica drop, TTL, the stable hash).
- Directory-first routing: a warm wave's hits and the snapshot surface,
  the fleet without a directory, a chaos directory kill with zero loss
  and token identity, role validation.
- Prefill/decode disaggregation: a role-split fleet hands every long
  prompt's KV from the prefill replica to its decode home at retirement
  (``export_blocks`` / ``import_blocks`` through ``retire_hook``),
  token-identical to offline ``generate_fast``; short prompts skip the
  detour; the int8 wire is cheaper than the exact one.
- The trace's handoff pairing rule and the ``hetu_top --fleet`` role
  and directory columns on the port's streams.

The export/import unit scenarios are in test_torch_fleet_wire.py.
"""

import test_fleet_kv as J
from torch_fleet_shim import CpuEngine, port_fixture

model = J.model
_fresh = port_fixture(J, helpers=True)


class TestTorchPrefixDirectory(J.TestPrefixDirectory):
    pass


class TestTorchDirectoryRouting(J.TestDirectoryRouting):
    pass


class TestTorchHandoffRouting(J.TestHandoffRouting):
    pass


class TestTorchHandoffTraceRule(J.TestHandoffTraceRule):
    pass


class TestTorchFleetTopKV(J.TestFleetTopKV):
    pass


def test_factory_builds_port_engines(model):
    eng = J._factory(model)(0)
    assert isinstance(eng, CpuEngine) and eng.paged
