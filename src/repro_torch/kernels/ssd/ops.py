"""Chunked SSD scan: the intra-chunk kernel (``csrc/ssd.cu``) plus the
inter-chunk recurrence in torch.

``ssd_chunks`` is the kernel's wrapper and replaces
``src/repro/kernels/ssd/kernel.py::ssd_chunks_pallas``: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel, one launch
over every (batch, head, chunk) cell, or raises.  ``ssd_chunked_scan``
keeps the outer algorithm of ``repro.kernels.ssd.ops.ssd_chunked_scan``:
the ``dac`` cumsum, a loop over chunks carrying the state, and the
inter-chunk output.  Unlike the reference it never broadcasts B and C
over heads: the kernel reads them by batch index, and ``y_inter``
applies ``exp(dac)`` after the head-free product with C.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs import span
from .. import native
from .ref import ssd_chunks_ref


def ssd_chunks(x, dac, dt, B, C, *, chunk: int):
    """Intra-chunk outputs and end-of-chunk states; shapes as in
    ``ssd_chunks_ref``."""
    with span("kernel.ssd", n=int(x.numel())):
        if x.device.type == "cpu":
            return ssd_chunks_ref(x, dac, dt, B, C, chunk=chunk)
        return _launch(x, dac, dt, B, C, chunk)


def _launch(x, dac, dt, B, C, chunk):
    dev = native.require_cuda("ssd", x, dac, dt, B, C,
                              dtypes=native.FLOATS)
    if not x.dtype == B.dtype == C.dtype:
        raise TypeError(f"ssd: x, B, C in one type, got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if not dac.dtype == dt.dtype == torch.float32:
        raise TypeError("ssd: dac and dt must be float32")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk or B.shape != (b, s, n) or C.shape != (b, s, n) \
            or dac.shape != (b, s, h) or dt.shape != (b, s, h):
        raise ValueError(f"ssd: bad shapes x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}, dac {tuple(dac.shape)}, "
                         f"chunk {chunk}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    states = torch.empty((b, s // chunk, h, n, p), dtype=torch.float32,
                         device=dev)
    fn = native.library("ssd").ssd_chunks_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(native.ptr(x), native.ptr(dac), native.ptr(dt), native.ptr(B),
             native.ptr(C), native.ptr(y), native.ptr(states), b, s, h, p,
             n, chunk, int(x.dtype == torch.bfloat16), native.stream(dev))
    native.check("ssd", err)
    native.count_launch("ssd")
    return y, states


def ssd_chunked_scan(x, dt, A, B, C, *, chunk: int = 64,
                     return_final: bool = False):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,); B/C: (b, s, n); s a
    multiple of ``chunk``.

    Returns y: (b, s, h, p) in x's type, plus the final recurrent state
    (b, h, n, p) f32 when ``return_final=True``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0
    nc = s // chunk
    da = dt.float() * A.float()[None, None, :]
    dac = torch.cumsum(da.reshape(b, nc, chunk, h), dim=2)
    y_intra, states = ssd_chunks(x.contiguous(), dac.reshape(b, s, h),
                                 dt.float().contiguous(), B.contiguous(),
                                 C.contiguous(), chunk=chunk)
    chunk_decay = torch.exp(dac[:, :, -1, :])  # (b, nc, h)
    hprevs = torch.empty_like(states)  # state entering each chunk
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    for c in range(nc):
        hprevs[:, c] = state
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    # y_inter[t] = exp(dac_t) * (C_t @ h_prev), per head.
    y_inter = torch.einsum("bctn,bchnp->bcthp",
                           C.reshape(b, nc, chunk, n).float(), hprevs)
    y_inter = y_inter * torch.exp(dac)[..., None]
    y = (y_intra.reshape(b, nc, chunk, h, p) + y_inter).reshape(
        b, s, h, p).to(x.dtype)
    if return_final:
        return y, state
    return y
