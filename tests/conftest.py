"""Test config: force a virtual 8-device CPU platform BEFORE jax initializes.

This is the TPU build's substitute for the reference's multi-process local
clusters (SURVEY.md §4 tier-2/3): N-device semantics on CPU so the
equivalence suite runs anywhere.  Note: the TPU plugin in this image ignores
the JAX_PLATFORMS env var, so we force via jax.config, which wins.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# static checks default-ON for the whole suite: every Executor/
# ServingEngine build runs the pre-trace verifier + parallelism checker
# (hetu_tpu/analysis/), so a graph regression fails with the node named
# instead of an XLA stack dump.  Explicit HETU_VALIDATE=0 still wins.
os.environ.setdefault("HETU_VALIDATE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# jax-version shims (e.g. pre-0.5 runtimes lack top-level jax.shard_map)
# must land before any test module runs `from jax import shard_map`
from hetu_tpu._compat import ensure_jax_compat  # noqa: E402

ensure_jax_compat()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tier (excluded from tier-1 runs)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc (the PyTorch port's kernels); "
        "skips without one")
    config.addinivalue_line(
        "markers",
        "smoke: <3-min verification tier (run with -m smoke; see "
        "ROADMAP.md tier-1 line)")
