"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_pallas`` and its wrapper's (B, S, H, D) interface.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel,
one launch over every (batch, head, query tile), or raises.  The kernel
reads the (B, S, H, D) layout as it lies: nothing is padded or
transposed.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs import span
from .. import native
from .ref import attention_ref

MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, scale=None, causal: bool = True,
                    window: int | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's
    type."""
    with span("kernel.flash_attention", n=int(q.numel())):
        if q.device.type == "cpu":
            return attention_ref(q, k, v, scale=scale, causal=causal,
                                 window=window)
        return _launch(q, k, v, scale, causal, window)


def _launch(q, k, v, scale, causal, window):
    dev = native.require_cuda("flash_attention", q, k, v,
                              dtypes=native.FLOATS)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v in one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    fn = native.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(native.ptr(q), native.ptr(k), native.ptr(v), native.ptr(o), b,
             sq, skv, hq, hkv, d, float(scale), int(causal),
             int(window is not None), int(window or 0),
             int(q.dtype == torch.bfloat16), native.stream(dev))
    native.check("flash_attention", err)
    native.count_launch("flash_attention")
    return o
