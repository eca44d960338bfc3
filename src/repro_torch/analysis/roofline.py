"""Roofline analysis of a traced dry-run step (a port of
``repro.analysis.roofline``).

Three terms per (arch x shape x mesh), in seconds, with the H100 SXM
data sheet's constants (``launch.mesh``):

  compute    = hlo_flops  / (chips * 989e12)
  memory     = hlo_bytes  / (chips * 3.35e12)
  collective = coll_bytes / (chips * 450e9)

The counts come from ``StepCounter``, a dispatch mode under which the
dry-run traces one step on rank 0 of a fake process group.  It sees the
aten ops each rank runs on its local shards (below DTensor), so every
count is rank 0's, times ``chips``: the reference's global quantities
(XLA's per-device cost analysis times chips), replicated work counted
on every device as XLA counts it.

  hlo_flops   the FLOPs of every local op with a formula in
              ``torch.utils.flop_counter`` (matmuls, attention,
              convolutions), times chips;
  hlo_bytes   the sum over the local aten ops that are not views of
              their input and output bytes (what XLA calls "bytes
              accessed"), times chips;
  coll_bytes  the operand bytes of every ``_c10d_functional`` collective
              the trace runs on rank 0, times chips, by op under the
              reference's names (``all-gather``, ``all-reduce``,
              ``reduce-scatter``, ``all-to-all``) in ``coll_by_op``.

``StepCounter.peak`` (the dry-run's ``temp_bytes``) is the peak of the
bytes of the storages the step's ops allocate and keep alive: an output
that aliases an input (a view, an in-place or ``out=`` op, a
collective's ``wait_tensor``) allocates nothing.  Metadata queries
(``prim::device``) and ``wait_tensor`` access no bytes.

The reference parses XLA's HLO text for collectives and multiplies those
inside while-loop bodies by the loops' trip counts.  No torch program
emits HLO, and the port's step runs every layer in Python, so the trace
already counts every layer's collectives: the counter replaces the
parser.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts a traced step's local work: FLOPs, bytes accessed,
    collective operand bytes (by op) and the peak of the bytes that its
    outputs keep alive.  Ops on DTensors are left to DTensor, which
    runs them here again on local shards; the global-shape op DTensor
    runs to infer an output's shape is not counted (the counter pauses
    inside ``ShardingPropagator._propagate_tensor_meta_non_cached``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._formulas = FlopCounterMode().flop_registry
        self._paused = 0

    def __enter__(self):
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        self._prop = prop

        def paused(sp, *a, **k):
            self._paused += 1
            try:
                return prop(sp, *a, **k)
            finally:
                self._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func.overloadpacket
        name = getattr(packet, "__name__", str(packet))
        if func.namespace == "prim" or name == "wait_tensor":
            return out
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            n = sum(_nbytes(t) for t in _tensors(args))
            op = _COLLECTIVES[name]
            self.coll[op] = self.coll.get(op, 0) + n
        formula = self._formulas.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(out))
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in _tensors(out):
                self._track(t)
        return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_by_op: dict = field(default_factory=dict)
    model_flops: float = 0.0
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = NVLINK_BW
    memory_per_device: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.ici_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """compute term / max term: 1.0 == compute-bound at the roofline."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (remat/redundancy waste detector)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "coll_bytes": self.coll_bytes,
            "coll_by_op": self.coll_by_op, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
            "memory_per_device": self.memory_per_device,
        }


def analyze_counts(counter: StepCounter, *, arch: str, shape: str,
                   mesh_name: str, chips: int, model_flops: float,
                   memory: dict | None = None) -> RooflineReport:
    """A report from rank 0's counts (global: times ``chips``)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(counter.flops) * chips,
        hlo_bytes=float(counter.bytes) * chips,
        coll_bytes=float(sum(counter.coll.values())) * chips,
        coll_by_op={k: v * chips for k, v in sorted(counter.coll.items())},
        model_flops=model_flops, memory_per_device=memory or {})
