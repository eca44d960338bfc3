"""uint32 bit patterns in torch storage, and the plain versions' math.

Device state and kernel operands keep u32 values as their bit patterns
in ``torch.int32`` storage; the kernels read them as ``uint32_t``.
PyTorch on the CPU has no ``>>``, ``%``, ``<`` or ``searchsorted`` for
``torch.uint32``, so the plain versions widen to int64 (``widen``) and
mask after every step that can carry past 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def to_device(arr, device, dtype=np.uint32) -> torch.Tensor:
    """Copy a host array of u32 (or i32) values to ``device`` as int32
    storage."""
    a = np.array(arr, dtype=dtype)  # a fresh, writable host copy
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor, dtype=np.uint32) -> np.ndarray:
    """Bring int32 storage back to the host as ``dtype`` (u32 default)."""
    return t.detach().cpu().numpy().view(dtype)


def widen(t: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns in int32 storage -> their int64 values."""
    return t.to(torch.int64) & MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def mix32(x: torch.Tensor, seed) -> torch.Tensor:
    """core.eve.mix32 on int64 tensors holding u32 values."""
    x = (x ^ seed) & MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)
