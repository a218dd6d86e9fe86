"""The port stands alone: no module of ``hetu_tpu_torch/``, and not
``chip_smoke.py`` or ``kernel_times.py``, imports ``jax`` or anything of
the JAX package ``hetu_tpu`` (its pure-numpy modules included: the port
keeps its own copies).  Only the tests import both."""

import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+hetu_tpu(?![\w])"
    r"|from\s+hetu_tpu(?![\w])(\.|\s))")


def _sources():
    yield from sorted((ROOT / "hetu_tpu_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"
    yield ROOT / "kernel_times.py"


def test_pattern_catches_the_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import "
                 "lax", "    from jax.experimental import pallas",
                 "import hetu_tpu", "import hetu_tpu as ht",
                 "from hetu_tpu.data import load_criteo",
                 "from hetu_tpu import glue"):
        assert FORBIDDEN.match(line), line
    for line in ("import hetu_tpu_torch", "from hetu_tpu_torch import graph",
                 "import jaxlib_free_name_x", "# import jax",
                 "    ``hetu_tpu/data.py``"):
        assert not FORBIDDEN.match(line), line


def test_no_jax_or_hetu_tpu_import_in_the_port():
    hits = []
    for path in _sources():
        for i, line in enumerate(path.read_text(encoding="utf-8")
                                 .splitlines(), 1):
            if FORBIDDEN.match(line):
                hits.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_the_parallel_modules_are_scanned():
    """The pipeline, strategy, collective, collective-check and
    shard-check modules, the graph GPT, the ``nn.Module`` GPT,
    ``serve_gpt``, expert parallelism, the GCN and ``train_gcn``, and
    the tensor-parallel split (the graph's per-rank evaluation, the
    serving cores and the KV managers) are among the sources the scan
    above reads."""
    scanned = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/partition.py", "parallel/pipeline.py",
                "parallel/distributed_strategies.py",
                "parallel/collectives.py", "parallel/sharding.py",
                "pipeline_executor.py", "graph/ops_comm.py",
                "analysis/shard_check.py", "parallel/collective_check.py",
                "models/gpt.py", "models/gpt_module.py", "serve_gpt.py",
                "quant.py", "models/moe_decode.py", "graph/ops_moe.py",
                "graph/ops_gnn.py", "train_gcn.py", "gnn_common.py",
                "graph/tensor_parallel.py", "models/gpt_decode.py",
                "serving/kv_manager.py"):
        assert f"hetu_tpu_torch/{rel}" in scanned, rel
