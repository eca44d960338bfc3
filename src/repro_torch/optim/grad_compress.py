"""Int8 gradient compression with error feedback for cross-pod reduction
(a port of ``repro.optim.grad_compress``).

The pod-to-pod axis is the slow hop at 1000+ node scale; reducing
bf16/f32 gradients across it wastes 2-4x bandwidth.  The standard
recipe: per-block scale -> int8 quantize -> all-reduce -> dequantize,
with the quantization residual fed back into the next step (error
feedback keeps SGD convergence; Karimireddy et al. 2019).

As in the reference, the wire is modelled, not built: ``compressed_psum``
all-reduces the dequantized f32 values over the process group and
divides by its size, so a run shows the compression's numerical effect
and not its bytes.  ``make_compressed_crosspod_reduce`` averages over a
mesh's 'pod' axis only (intra-pod reductions stay exact).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def _scalar(v: float, like) -> torch.Tensor:
    """``v`` as a 0-dim tensor on ``like``'s device: CUDA divides by a
    Python number as a multiply by its reciprocal, which can miss the
    quotient's last bit; by a tensor it divides exactly, as the CPU
    and the reference do."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _quantize(x32, block=BLOCK):
    flat = x32.reshape(-1)
    pad = -flat.shape[0] % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / _scalar(127.0, x32)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequantize(q, scale, pad, shape):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def quantize_roundtrip(x):
    """Quantize + dequantize (the wire transform); returns (y, residual)
    in f32.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    x32 = x.float()
    q, scale, pad = _quantize(x32)
    y = _dequantize(q, scale, pad, x32.shape)
    return y, x32 - y


def compressed_psum(grads, errors, group=None):
    """Mean over ``group`` (a process group; None: the default one) with
    the int8 wire transform and error feedback.  ``grads`` / ``errors``:
    lists of tensors, one error a gradient.  Returns (reduced_grads,
    new_errors)."""
    n = dist.get_world_size(group)

    def one(g, e):
        y, resid = quantize_roundtrip(g.float() + e)
        dist.all_reduce(y, group=group)
        return y / _scalar(n, y), resid

    out = [one(g, e) for g, e in zip(grads, errors)]
    return [o[0] for o in out], [o[1] for o in out]


def make_compressed_crosspod_reduce(mesh, param_specs_tree=None):
    """Returns reduce_fn(grads, errors) -> (grads, errors) that averages
    gradients (each rank's whole local tensors) across the mesh's 'pod'
    axis in int8 with error feedback, leaving intra-pod axes untouched
    (they reduce exactly in the backward); None without a 'pod' axis."""
    if "pod" not in mesh.mesh_dim_names:
        return None
    group = mesh.get_group("pod")

    def reduce_fn(grads, errors):
        return compressed_psum(grads, errors, group)

    return reduce_fn
