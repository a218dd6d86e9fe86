"""Device selection for the port's entry points.

Every entry point (``ServingEngine``, ``generate_fast``,
``params_from_numpy``) runs on the card unless the caller asks for the
CPU by name.  Without a card and without ``device="cpu"`` they raise:
the port never carries on on the CPU silently, because a CPU run of a
serving path measures PyTorch's CPU kernels, not the system.
"""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """``None``/``"cuda"`` -> the current CUDA device (raises when CUDA
    is absent); ``"cpu"`` -> the CPU, only when asked for.  Accepts a
    ``torch.device`` or a string such as ``"cuda:1"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hetu_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
