"""The torch devices an engine keeps its state on and launches on.

``EngineConfig.device`` names the engine's device and
``EngineConfig.devices`` spreads its shards over the cards
(``shard_devices``).  A CUDA device must exist: asking for one on a
machine without CUDA raises, it never falls back to the CPU.  Only an
explicit ``"cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import contextlib

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


def shard_devices(num_shards: int, device: str,
                  limit: int | None) -> list[torch.device] | None:
    """Home device of each of ``num_shards`` shards, or None for the
    single-device path (every shard on ``device``).

    ``limit`` 0 is that path.  None is auto: that path where at most one
    card is visible, else round-robin over up to ``num_shards`` cards.
    N pins round-robin over cuda:0 .. cuda:min(N, count) - 1 (N = 1 puts
    every shard on cuda:0).  With a CPU ``device`` every shard is on the
    CPU: pinned (a list) for N > 0, the single-device path otherwise.
    """
    n = int(num_shards)
    if limit == 0:
        return None
    if torch.device(device).type == "cpu":
        return None if limit is None else [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if limit is None:
        if count <= 1:
            return None
        limit = min(n, count)
    if count < 1:
        raise RuntimeError(f"devices={limit} requested but no CUDA device "
                           "is visible")
    cards = max(1, min(int(limit), count))
    return [torch.device("cuda", s % cards) for s in range(n)]


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for a kernel launch (raw
    launches run on the current device's context); a no-op on the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
