"""Runs a JAX fleet test module's scenarios against the PyTorch port.

``port_globals(module)`` maps every global of a JAX test module that
names something of the JAX package (a module, class or function whose
``__module__`` is under ``hetu_tpu``) to the port's object of the same
name and module path under ``hetu_tpu_torch``, so the module's own test
bodies, helpers and assertions run unchanged on port engines.  Two
names differ on purpose: ``ServingEngine`` becomes ``CpuEngine`` (the
port's engine on ``device="cpu"``, dropping the JAX engine's
``fast_path=`` argument, which the port has no counterpart for) and
``generate_fast`` runs the port's on the CPU.  Names with no port
counterpart (``GPTConfig``: configs are duck-typed; the PS server and
client, ROADMAP A10) stay the JAX objects.

A port test file subclasses the JAX test classes under new names (the
JAX classes themselves are not module attributes there, so pytest
does not collect them twice) and applies the mapping with an autouse
fixture that runs before the JAX module's own fixtures.
"""

import importlib
import types

from hetu_tpu_torch.models import gpt_decode as _tgd
from hetu_tpu_torch.serving import ServingEngine as _TEngine


class CpuEngine(_TEngine):
    """The port's engine on the CPU, accepting the JAX engine's
    ``fast_path=`` (ignored: the port has one attention path)."""

    def __init__(self, params, config, *, fast_path=None, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(params, config, **kw)


def cpu_generate_fast(params, config, prompts, num_tokens, **kw):
    kw.setdefault("device", "cpu")
    kw.pop("prefill", None)
    return _tgd.generate_fast(params, config, prompts, num_tokens, **kw)


_KEEP = {"GPTConfig", "ht", "jnp", "PSServer", "ShardedPSClient"}
_SPECIAL = {"ServingEngine": CpuEngine, "generate_fast": cpu_generate_fast}


def _port_name(modname):
    assert modname == "hetu_tpu" or modname.startswith("hetu_tpu."), modname
    return "hetu_tpu_torch" + modname[len("hetu_tpu"):]


def port_globals(module):
    """{global name: port object} for ``module``'s JAX-package names."""
    out = {}
    for name, val in vars(module).items():
        if name in _KEEP or name.startswith("__"):
            continue
        if name in _SPECIAL:
            out[name] = _SPECIAL[name]
            continue
        if isinstance(val, types.ModuleType):
            mod = val.__name__
            if mod.startswith("hetu_tpu.") or mod == "hetu_tpu":
                out[name] = importlib.import_module(_port_name(mod))
            continue
        mod = getattr(val, "__module__", None) or ""
        if mod.startswith("hetu_tpu."):
            port = importlib.import_module(_port_name(mod))
            out[name] = getattr(port, getattr(val, "__name__", name))
    return out


def use_port(monkeypatch, module):
    """Point ``module``'s JAX-package globals at the port for one test,
    and check that nothing of the JAX package is left among them but
    the names kept on purpose."""
    for name, val in port_globals(module).items():
        monkeypatch.setattr(module, name, val)
    for name, val in vars(module).items():
        if name in _KEEP or name.startswith("__"):
            continue
        mod = (val.__name__ if isinstance(val, types.ModuleType)
               else getattr(val, "__module__", None) or "")
        assert not (mod == "hetu_tpu" or mod.startswith("hetu_tpu.")), \
            (name, mod)


# ------------------------------------------------------------------- #
# the port's versions of the JAX fleet tests' pool helpers (theirs
# write jnp arrays into the pool; these write the port's tensors)
# ------------------------------------------------------------------- #

def port_mgr(**kw):
    """``test_fleet_kv._mgr`` on the port: a paged pool on the CPU
    (``dtype=jnp.int8`` selects the int8 pool, as there)."""
    import numpy as np

    from hetu_tpu_torch.serving import PagedKVManager
    base = dict(layers=2, heads=2, head_dim=8, slots=2, max_seq_len=32,
                block=8, prefix_share=True, device="cpu")
    base.update(kw)
    dt = base.get("dtype")
    if dt is not None and not isinstance(dt, str) \
            and np.dtype(dt) == np.int8:
        base["dtype"] = "int8"
    return PagedKVManager(**base)


def port_fill(m, seed=0):
    """``test_fleet_kv._fill`` on the port: the same random content,
    written in place into every plane of the pool."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    for cache in (m.cache_k, m.cache_v):
        if isinstance(cache, tuple):
            q = rng.randint(-127, 128, tuple(cache[0].shape)).astype(np.int8)
            s = (rng.rand(*cache[1].shape) + 0.01).astype(np.float32)
            cache[0].copy_(torch.from_numpy(q))
            cache[1].copy_(torch.from_numpy(s))
        else:
            cache.copy_(torch.from_numpy(
                rng.randn(*cache.shape).astype(np.float32)))


def port_span_f32(m, slot):
    """``test_fleet_kv._span_f32`` on the port: the slot's filled span
    as dequantized f32 numpy arrays."""
    from hetu_tpu_torch import quant

    n = m.blocks_needed(int(m.lengths[slot]))
    idx = [int(b) for b in m.tables[slot, :n]]

    def one(cache):
        if isinstance(cache, tuple):
            return quant.kv_decode(cache[0][:, idx],
                                   cache[1][:, idx]).numpy()
        return cache[:, idx].float().numpy()

    return one(m.cache_k), one(m.cache_v)


def use_port_helpers(monkeypatch, module):
    """``use_port`` plus the pool helpers a KV test module defines."""
    use_port(monkeypatch, module)
    for name, fn in (("_mgr", port_mgr), ("_fill", port_fill),
                     ("_span_f32", port_span_f32)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, fn)


def port_fixture(module, helpers=False):
    """An autouse fixture for a port test file built on ``module``: the
    JAX module's ``_fresh`` (telemetry on, chaos and the fleet's env
    knobs cleared, fault plans and telemetry reset around the test) on
    the PORT's fault plans and telemetry, after ``use_port`` (or
    ``use_port_helpers``) has pointed the module at the port."""
    import pytest

    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.ps import faults

    @pytest.fixture(autouse=True)
    def _fresh(monkeypatch):
        (use_port_helpers if helpers else use_port)(monkeypatch, module)
        monkeypatch.setenv("HETU_TELEMETRY", "1")
        for var in ("HETU_CHAOS", "HETU_HANDOFF_QUANT",
                    "HETU_KV_HOST_BYTES", "HETU_KV_PS_TIER"):
            monkeypatch.delenv(var, raising=False)
        faults.reset_plans()
        telemetry.reset()
        yield
        faults.reset_plans()
        telemetry.reset()

    return _fresh
