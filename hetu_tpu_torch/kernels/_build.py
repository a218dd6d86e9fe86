"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The sources compile in parallel, one ``nvcc`` each, into
``hetu_tpu_torch/_build/<digest>/`` where the digest covers every source
and header plus the flags: an edit to any of them builds anew, and an
unchanged tree reuses the libraries.  A failed build raises with the
compiler's output; nothing falls back.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on anything but success.  :data:`LAUNCHES` counts
kernel launches by name: a wrapper adds one where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import locks

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset (see reset_launches)
LAUNCHES = collections.Counter()

_lock = locks.TracedLock("kernels.build")
_libs = {}
# name -> nvcc output of the build this process ran (ptxas register and
# spill report)
BUILD_LOG = {}


def reset_launches():
    LAUNCHES.clear()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): the port's "
        "kernels are built from hetu_tpu_torch/kernels/csrc at first use")


def digest():
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all():
    """Compile every kernel library that is not built yet (all ``nvcc``
    processes started together) and return {name: path}.  Raises
    RuntimeError with the compiler output when any build fails."""
    out_dir = BUILD_ROOT / digest()
    paths = {n: out_dir / f"lib{n}.so" for n in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    if not todo:
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out_dir / f".lib{n}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc {n}.cu exited {p.returncode}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name):
    """The loaded ctypes library of kernel source ``name`` (built on the
    first call in the process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            lib.hetu_error_string.argtypes = [ctypes.c_int]
            lib.hetu_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib, rc, what):
    if rc != 0:
        msg = lib.hetu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def check_aligned(tensors, names):
    """The tensor-core and split-K kernels copy 16-byte chunks: every
    tensor's data must start on a 16-byte boundary (a fresh or
    contiguous-sliced tensor does).  ``names`` names them in the error.
    Raises ValueError."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the tensor-core and split-K kernels take {names} "
                         f"starting on 16-byte boundaries")


def stream_of(t):
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
