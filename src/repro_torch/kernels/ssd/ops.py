"""Chunked SSD scan: the intra-chunk kernels (``csrc/ssd_sm90.cu`` and
``csrc/ssd.cu``) plus the inter-chunk recurrence in torch.

``ssd_chunks`` is the kernels' wrapper and replaces
``src/repro/kernels/ssd/kernel.py::ssd_chunks_pallas``: a CPU tensor
takes the plain version, a CUDA tensor launches one kernel over every
(batch, head, chunk) cell, or raises.  ``kernel_for`` picks that kernel
from the dtype and the shape alone, before the launch: bf16 with p, n
and the chunk multiples of 16 goes to the tensor-core kernel, the rest
(f32, small states) to the CUDA-core kernel.  ``ssd_chunked_scan``
keeps the outer algorithm of ``repro.kernels.ssd.ops.ssd_chunked_scan``:
the ``dac`` cumsum, a loop over chunks carrying the state, and the
inter-chunk output.  Unlike the reference it never broadcasts B and C
over heads: the kernels read them by batch index, and ``y_inter``
applies ``exp(dac)`` after the head-free product with C.

On a CUDA tensor the launch goes through ``SSDChunks``, whose backward
is the plain version's vector-Jacobian product, so a loss built on the
kernel's outputs has the gradient the reference trains with.

DTensor operands (a model sharded on a mesh) run on every rank's local
shards (``sharded.local_apply``: sequence, chunk, p and n replicated,
batch and heads as sharded, B and C whole on every rank of a head
shard) through ``SSDChunks``: a CUDA mesh launches the kernel there or
raises, a CPU mesh runs the plain version.
"""

from __future__ import annotations

import torch

from ...obs import span
from .. import native, sharded
from .ref import ssd_chunks_ref

SMEM_BYTES = 232_448  # shared memory an H100 block may use
SM90_HEADS = 2  # heads a block of the tensor-core kernel


def ssd_chunks(x, dac, dt, B, C, *, chunk: int):
    """Intra-chunk outputs and end-of-chunk states; shapes as in
    ``ssd_chunks_ref``."""
    with span("kernel.ssd", n=int(x.numel())):
        if sharded.is_dtensor(x):
            launch = _plain if x.device.type == "cpu" else _launch
            heads, whole = sharded.Role(heads=2), sharded.Role()
            return sharded.local_apply(
                lambda *a: SSDChunks.apply(launch, chunk, *a),
                (x, dac, dt, B, C), (heads, heads, heads, whole, whole),
                (heads, heads))
        if x.device.type == "cpu":
            return ssd_chunks_ref(x, dac, dt, B, C, chunk=chunk)
        return SSDChunks.apply(_launch, chunk, x, dac, dt, B, C)


def _plain(x, dac, dt, B, C, chunk):
    """The plain version as a launcher: a CPU mesh's shards go through
    ``SSDChunks`` as a card's do, so a traced step holds what the card's
    holds (the inputs; the backward recomputes)."""
    return ssd_chunks_ref(x, dac, dt, B, C, chunk=chunk)


class SSDChunks(torch.autograd.Function):
    """A kernel's forward with the plain version's backward.

    ``forward`` calls ``launch(x, dac, dt, B, C, chunk)`` (``_launch``,
    which launches the kernel ``kernel_for`` picks; a test passes the
    plain version); ``backward`` recomputes ``ssd_chunks_ref`` on the
    saved inputs under autograd and returns its vector-Jacobian
    product.  That is the reference's gradient: the JAX package trains
    through ``ssd_chunked_scan`` with ``use_kernel=False``, autodiff of
    its plain path; no Pallas kernel there has a backward."""

    @staticmethod
    def forward(ctx, launch, chunk, x, dac, dt, B, C):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dac, dt, B, C)
        return launch(x, dac, dt, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gstates):
        chunk = ctx.chunk
        return (None, None) + native.plain_vjp(
            lambda *a: ssd_chunks_ref(*a, chunk=chunk), ctx.saved_tensors,
            (gy, gstates), ctx.needs_input_grad[2:])


def sm90_smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one block of ``ssd_sm90``: B and C, two x
    buffers (rows padded by 16 bytes), dac, dt and the decay weights of
    its heads."""
    return 2 * chunk * (2 * n + 16) + 2 * chunk * (2 * p + 16) \
        + 3 * SM90_HEADS * chunk * 4


def kernel_for(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The kernel a CUDA call launches: ``ssd_sm90`` (mma.sync on bf16
    tiles of 16) for bf16 with p, n and the chunk multiples of 16 whose
    block fits in shared memory, else ``ssd`` (CUDA cores, f32 or
    bf16)."""
    if dtype == torch.bfloat16 and p > 0 and n > 0 and chunk > 0 \
            and not p % 16 and not n % 16 and not chunk % 16 \
            and sm90_smem_bytes(p, n, chunk) <= SMEM_BYTES:
        return "ssd_sm90"
    return "ssd"


def _launch(x, dac, dt, B, C, chunk):
    if kernel_for(x.dtype, x.shape[-1], B.shape[-1], chunk) == "ssd_sm90":
        return _launch_sm90(x, dac, dt, B, C, chunk)
    return _launch_simt(x, dac, dt, B, C, chunk)


def _check(x, dac, dt, B, C, chunk) -> torch.device:
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
    return dev


def _outputs(x, B, chunk, dev):
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    states = torch.empty((b, s // chunk, h, n, p), dtype=torch.float32,
                         device=dev)
    return y, states, [b, s, h, p, n, chunk]


def _launch_sm90(x, dac, dt, B, C, chunk, *, planted_fault: bool = False):
    """The tensor-core kernel; bf16 operands in its domain
    (``kernel_for``), 16-byte aligned for its copies.  ``planted_fault``
    launches a variant that leaves the diagonal u == t out of the mask,
    for checks that must reject it."""
    dev = _check(x, dac, dt, B, C, chunk)
    if kernel_for(x.dtype, x.shape[-1], B.shape[-1], chunk) != "ssd_sm90":
        raise ValueError(f"ssd_sm90: bf16 with p, n, chunk multiples of "
                         f"16 only, got {x.dtype}, {tuple(x.shape)}, n "
                         f"{B.shape[-1]}, chunk {chunk}")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_sm90: x, B, C must be 16-byte aligned")
    y, states, dims = _outputs(x, B, chunk, dev)
    fn = native.entry("ssd_sm90", "ssd_sm90_launch")
    err = fn(native.ptr(x), native.ptr(dac), native.ptr(dt), native.ptr(B),
             native.ptr(C), native.ptr(y), native.ptr(states), *dims,
             int(planted_fault), native.stream(dev))
    native.check("ssd_sm90", err)
    native.count_launch("ssd_sm90")
    return y, states


def _launch_floor(batch: int, s: int, h: int, p: int, n: int, chunk: int,
                  device) -> None:
    """An empty kernel on ``ssd_sm90``'s grid, block and shared memory
    for these shapes: the launch floor beneath its time (not a launch of
    the scan)."""
    dev = torch.device(device)
    fn = native.entry("ssd_sm90", "ssd_sm90_floor_launch")
    native.check("ssd_sm90_floor",
                 fn(batch, s, h, p, n, chunk, native.stream(dev)))


def _launch_simt(x, dac, dt, B, C, chunk):
    """The CUDA-core kernel, f32 or bf16, any p, n and chunk."""
    dev = _check(x, dac, dt, B, C, chunk)
    y, states, dims = _outputs(x, B, chunk, dev)
    fn = native.entry("ssd", "ssd_chunks_launch")
    err = fn(native.ptr(x), native.ptr(dac), native.ptr(dt), native.ptr(B),
             native.ptr(C), native.ptr(y), native.ptr(states), *dims,
             int(x.dtype == torch.bfloat16), native.stream(dev))
    native.check("ssd", err)
    native.count_launch("ssd")
    return y, states


def _dac(dt, A, chunk: int):
    """In-chunk cumulative sums of dt * A: (b, nc, chunk, h) f32."""
    b, s, h = dt.shape
    da = dt.float() * A.float()[None, None, :]
    return torch.cumsum(da.reshape(b, s // chunk, chunk, h), dim=2)


def _inter_chunk(states, dac, C):
    """The inter-chunk recurrence: (y_inter (b, s, h, p), the final state
    (b, h, n, p)), f32, from the chunks' end states (b, nc, h, n, p),
    the in-chunk cumsums dac (b, nc, chunk, h) and C (b, s, n)."""
    b, nc, h, n, p = states.shape
    chunk = dac.shape[2]
    chunk_decay = torch.exp(dac[:, :, -1, :])  # (b, nc, h)
    hprevs = torch.empty_like(states)  # state entering each chunk
    state = torch.zeros((b, h, n, p), dtype=torch.float32,
                        device=states.device)
    for c in range(nc):
        hprevs[:, c] = state
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    # y_inter[t] = exp(dac_t) * (C_t @ h_prev), per head.
    y_inter = torch.einsum("bctn,bchnp->bcthp",
                           C.reshape(b, nc, chunk, n).float(), hprevs)
    y_inter = y_inter * torch.exp(dac)[..., None]
    return y_inter.reshape(b, nc * chunk, h, p), state


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
    if sharded.is_dtensor(dt):
        # The in-chunk cumsum on each rank's (batch, head) shard.
        dac, = sharded.local_apply(
            lambda dt, A: _dac(dt, A, chunk), (dt, A),
            (sharded.Role(heads=2), sharded.Role(batch=None, heads=0)),
            (sharded.Role(heads=3),))
    else:
        dac = _dac(dt, A, chunk)
    y_intra, states = ssd_chunks(x.contiguous(), dac.reshape(b, s, h),
                                 dt.float().contiguous(), B.contiguous(),
                                 C.contiguous(), chunk=chunk)
    if sharded.is_dtensor(states):
        # The recurrence on each rank's (batch, head) shard.
        y_inter, state = sharded.local_apply(
            _inter_chunk, (states, dac, C), (
                sharded.Role(heads=2), sharded.Role(heads=3),
                sharded.Role()),
            (sharded.Role(heads=2), sharded.Role(heads=1)))
    else:
        y_inter, state = _inter_chunk(states, dac, C)
    y = (y_intra + y_inter).to(x.dtype)
    if return_final:
        return y, state
    return y
