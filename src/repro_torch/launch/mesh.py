"""Production mesh factories and the card's roofline constants (a port of
``repro.launch.mesh``).

Everything here is a function: importing this module touches no
process group.  A mesh needs ``torch.distributed`` initialised first,
with as many ranks as the mesh has devices: real ranks (NCCL on cards,
gloo on the CPU), or the fake process group the dry-run traces over.

Single pod = 16 x 16 = 256 devices, axes ('data', 'model'); multi-pod =
2 x 16 x 16 = 512 devices with a leading 'pod' axis (data-parallel
across pods, model/data parallel within a pod).  These are the
reference's shapes and names: the rule resolution (``MODEL_PAR = 16``)
and every dry-run cell are tied to them.

The reference's ``ensure_host_devices`` / ``forced_host_device_count``
set how many host devices XLA creates; PyTorch has no such count, and a
process group's ``world_size`` takes their place.  ``shard_devices``
lives in ``repro_torch.device``.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh_compat(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of ``shape`` with the axis names ``axes`` over the
    default process group's ranks."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of a production mesh."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod)
    return make_mesh_compat(shape, axes, device_type)


# H100 SXM hardware constants for the roofline model (per card), from
# NVIDIA's H100 data sheet (SXM part, dense, at the 700 W limit).
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores, no sparsity
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s a direction a GPU, NVLink 4 (900 GB/s both ways)
HBM_BYTES = 80e9  # device memory
