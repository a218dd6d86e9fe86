"""The elastic fleet on port engines, on the CPU: the scenarios of the
JAX package's ``tests/test_autoscaler.py`` run unchanged on the port
(``torch_fleet_shim``) and are held to that file's own assertions —
the control loop's hysteresis and cooldown, a scale-down deferred
mid-rollout, scale up and down under traffic with zero loss, the warm
prefix handoff on scale-up, a retirement requeueing its in-flight
requests, chaos kills mid-scale-up and mid-drain, the seeded traffic
generator (a pure function of its seed; diurnal, flash and session
shapes; a JSON-able description), and a disabled autoscaler leaving the
static fleet's outputs byte-identical.
"""

import test_autoscaler as J
from torch_fleet_shim import port_fixture
from torch_one_thread import one_torch_thread  # noqa: F401

model = J.model
_fresh = port_fixture(J)


class TestTorchControlLoop(J.TestControlLoop):
    pass


class TestTorchElasticity(J.TestElasticity):
    pass


class TestTorchChaos(J.TestChaos):
    pass


class TestTorchTraffic(J.TestTraffic):
    pass


def test_torch_disabled_autoscaler_is_byte_identical_to_static(model):
    J.test_disabled_autoscaler_is_byte_identical_to_static(model)
