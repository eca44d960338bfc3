"""Wrapper of the flash attention kernels (``csrc/flash_attention_sm90.cu``
and ``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_pallas`` and its wrapper's (B, S, H, D) interface.  A
CPU tensor takes the plain version; a CUDA tensor launches one kernel,
one launch over every (batch, head, query tile), or raises.
``kernel_for`` picks that kernel from the dtype and the shape alone,
before the launch: bf16 with D % 8 == 0 goes to the wgmma kernel, the
rest (f32, odd head dims) to the CUDA-core kernel.  Both read the (B,
S, H, D) layout as it lies: nothing is padded or transposed.

On a CUDA tensor the launch goes through ``FlashAttention``, whose
backward is the plain version's vector-Jacobian product, so a loss
built on the kernel's output has the gradient the reference trains
with.

DTensor operands (a model sharded on a mesh) run on every rank's local
shards (``sharded.local_apply``: sequence and head_dim replicated,
batch and heads as sharded, K/V heads selected where the query heads'
shard needs them) through ``FlashAttention``: a CUDA mesh launches the
kernel there or raises, a CPU mesh runs the plain version.
"""

from __future__ import annotations

import torch

from ...obs import span
from .. import native, sharded
from .ref import attention_ref

MAX_HEAD_DIM = 256
# The backward recomputes the plain version a slice of KV heads at a
# time, its f32 scores at most this large: at 1 x 4096 with 32 heads the
# whole (B, H, Sq, Skv) is 2 GB a tensor, and autograd keeps several.
VJP_SCORE_BYTES = 1 << 29


def flash_attention(q, k, v, *, scale=None, causal: bool = True,
                    window: int | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's
    type."""
    with span("kernel.flash_attention", n=int(q.numel())):
        if sharded.is_dtensor(q):
            launch = _plain if q.device.type == "cpu" else _launch
            heads = sharded.Role(heads=2)
            kv = sharded.Role(heads=2, group=q.shape[2] // k.shape[2])
            return sharded.local_apply(
                lambda *a: FlashAttention.apply(launch, scale, causal,
                                                window, *a),
                (q, k, v), (heads, kv, kv), (heads,))[0]
        if q.device.type == "cpu":
            return attention_ref(q, k, v, scale=scale, causal=causal,
                                 window=window)
        return FlashAttention.apply(_launch, scale, causal, window, q, k, v)


def _plain(q, k, v, scale, causal, window):
    """The plain version as a launcher: a CPU mesh's shards go through
    ``FlashAttention`` as a card's do, so a traced step holds what the
    card's holds (the inputs; the backward recomputes)."""
    return attention_ref(q, k, v, scale=scale, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """A kernel's forward with the plain version's backward.

    ``forward`` calls ``launch(q, k, v, scale, causal, window)``
    (``_launch``, which launches the kernel ``kernel_for`` picks; a test
    passes the plain version); ``backward`` recomputes ``attention_ref``
    on the saved inputs under autograd and returns its vector-Jacobian
    product, a slice of KV heads (with their query heads) at a time:
    heads are independent, so the slices' products are the whole one's.
    That is the reference's gradient: the JAX package trains through
    the plain ``masked_attention``; no Pallas kernel there has a
    backward."""

    @staticmethod
    def forward(ctx, launch, scale, causal, window, q, k, v):
        ctx.opts = dict(scale=scale, causal=causal, window=window)
        ctx.save_for_backward(q, k, v)
        return launch(q, k, v, scale, causal, window)

    @staticmethod
    def backward(ctx, go):
        q, k, v = ctx.saved_tensors
        b, sq, hq, _ = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        group = hq // hkv
        per = max(1, VJP_SCORE_BYTES // (4 * b * group * sq * skv))
        needs = ctx.needs_input_grad[4:]
        parts = []
        for j in range(0, hkv, per):
            hs = slice(j * group, (j + per) * group)
            parts.append(native.plain_vjp(
                lambda *a: attention_ref(*a, **ctx.opts),
                (q[:, :, hs], k[:, :, j:j + per], v[:, :, j:j + per]),
                (go[:, :, hs],), needs))
        grads = tuple(torch.cat(g, dim=2) if n else None
                      for g, n in zip(zip(*parts), needs))
        return (None, None, None, None) + grads


def kernel_for(dtype: torch.dtype, head_dim: int, hq: int, hkv: int) -> str:
    """The kernel a CUDA call launches: ``flash_attention_sm90`` (TMA and
    wgmma, bf16 in boxes of 64 columns, so every global stride must be a
    multiple of 16 bytes) for bf16 with D % 8 == 0, D <= 256 and
    Hq % Hkv == 0, else ``flash_attention`` (CUDA cores, f32 or bf16)."""
    if dtype == torch.bfloat16 and head_dim % 8 == 0 \
            and 0 < head_dim <= MAX_HEAD_DIM and hkv > 0 and hq % hkv == 0:
        return "flash_attention_sm90"
    return "flash_attention"


def _launch(q, k, v, scale, causal, window):
    if kernel_for(q.dtype, q.shape[-1], q.shape[-2], k.shape[-2]) \
            == "flash_attention_sm90":
        return _launch_sm90(q, k, v, scale, causal, window)
    return _launch_simt(q, k, v, scale, causal, window)


def _check(q, k, v) -> torch.device:
    dev = native.require_cuda("flash_attention", q, k, v,
                              dtypes=native.FLOATS)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v in one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, _, hq, d = q.shape
    _, _, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    return dev


def _args(q, k, v, scale, causal, window):
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    return o, [native.ptr(q), native.ptr(k), native.ptr(v), native.ptr(o), b,
               sq, skv, hq, hkv, d, float(scale), int(causal),
               int(window is not None), int(window or 0)]


def _launch_sm90(q, k, v, scale, causal, window):
    """The wgmma kernel; bf16 operands in its domain (``kernel_for``),
    16-byte aligned for the tensor maps."""
    dev = _check(q, k, v)
    if kernel_for(q.dtype, q.shape[3], q.shape[2], k.shape[2]) \
            != "flash_attention_sm90":
        raise ValueError(f"flash_attention_sm90: bf16 with D % 8 == 0 "
                         f"only, got {q.dtype}, {tuple(q.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_sm90: operands must be 16-byte "
                         "aligned")
    o, args = _args(q, k, v, scale, causal, window)
    fn = native.entry("flash_attention_sm90", "flash_attention_sm90_launch")
    native.check("flash_attention_sm90", fn(*args, native.stream(dev)))
    native.count_launch("flash_attention_sm90")
    return o


def _launch_floor(b: int, sq: int, hq: int, d: int, device) -> None:
    """An empty kernel on ``flash_attention_sm90``'s grid, block and
    shared memory for (b, sq, hq, d) queries: the launch floor beneath
    its time (not a launch of the attention)."""
    dev = torch.device(device)
    fn = native.entry("flash_attention_sm90",
                      "flash_attention_sm90_floor_launch")
    native.check("flash_attention_sm90_floor",
                 fn(b, sq, hq, d, native.stream(dev)))


def _launch_simt(q, k, v, scale, causal, window):
    """The CUDA-core kernel, f32 or bf16, any D up to 256."""
    dev = _check(q, k, v)
    o, args = _args(q, k, v, scale, causal, window)
    fn = native.entry("flash_attention", "flash_attention_launch")
    native.check("flash_attention", fn(*args, int(q.dtype == torch.bfloat16),
                                       native.stream(dev)))
    native.count_launch("flash_attention")
    return o
