"""The one torch device an engine keeps its state on and launches on.

``EngineConfig.device`` names it.  A CUDA device must exist: asking for
one on a machine without CUDA raises, it never falls back to the CPU.
Only an explicit ``"cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device`` of ``name``; raises if it is a CUDA device that
    this machine does not have."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain versions")
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} does not exist "
                               f"({torch.cuda.device_count()} present)")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: cuda or cpu")
    return dev
