"""Per-shard batched execution with the CUDA filter stage.

``ShardExecutor`` owns one ``LSMTree`` and drives its canonical batched
read path (``LSMTree.get_batch``) with hooks swapped in:

  cascade_fn   THE preferred read path: one fused launch of the
               ``repro_torch.kernels.cascade`` kernel answers every
               level's Bloom + fence questions and the GLORAN per-level
               interval verdicts from persistent device state (the
               shard's ``DeviceFilterRegistry`` — uploaded once per
               SSTable / index epoch, invalidated on compaction).  Gated
               by ``kernel_min_batch``, u32 eligibility and the pack
               budgets; when it declines, the per-level hooks below
               serve the lookup instead, with identical results and I/O
               charges,
  bloom_fn     SSTable filter probes through the ``kernels.bloom``
               kernel (bit-exact with ``BloomBits.might_contain``) once
               the sub-batch and filter are big enough to pay for a
               launch,
  cache        data-block reads charged through the shard's read-through
               ``BlockCache`` so hot blocks stop costing I/O,
  validity_fn  GLORAN validity probing where each LSM-DRtree level is
               queried with one ``interval_query`` launch instead of a
               per-key ``covers`` descent — the disjoint level arrays
               are clamped into u32 working space (exact for u32-range
               queries).

Compactions order their two-run merges through the ``kernels.merge``
merge-rank kernel (``compaction_rank_fn``), bit-exact with the host
searchsorted pair.

The control flow stays single-sourced in ``LSMTree`` / ``GloranIndex`` /
``LSMDRTree``; hooks only replace HOW a verdict is computed, never what
is charged for it — except the block cache, whose whole point is
skipping charges for resident blocks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..core.eve import fold64to32
from ..device import resolve_device
from ..kernels.bloom.ops import bloom_probe
from ..kernels.cascade.ops import cascade_lookup
from ..kernels.interval.ops import interval_query
from ..kernels.merge.ops import merge_ranks
from ..kernels.u32 import to_device, to_numpy
from ..lsm.scheduler import level_rt_density
from ..lsm.tree import CascadeVerdict, LSMTree
from ..obs import span
from .cache import BlockCache
from .plan import KIND_NAMES, OP_DELETE, OP_GET, OP_PUT, ShardPlan
from .registry import DeviceFilterRegistry, _U32_LIMIT
from .stats import KernelCounters

_DEFERRED = {
    "wal_dir": "Queue A item 8 (durable/)",
    "procs": "Queue A item 10 (engine/procpool.py)",
    "scheduler": "Queue A item 7 (background compaction wiring)",
    "tombstone_trigger": "Queue A item 7 (background compaction wiring)",
}


@dataclass
class EngineConfig:
    """Knobs of the batched execution layer (not the LSM itself)."""

    device: str = "cuda"  # torch device of every shard's state + kernels
    partition: str = "hash"  # "hash" | "range" key partitioning
    pipeline: bool = True  # concurrent shard plans
    cache_blocks: int = 0  # per-shard block cache capacity; 0 = off
    use_bloom_kernel: bool = True
    use_interval_kernel: bool = True
    use_merge_kernel: bool = True
    use_cascade_kernel: bool = True  # fused all-levels lookup cascade
    kernel_min_batch: int = 256  # sub-batch size worth a kernel launch
    kernel_min_areas: int = 64  # DR-tree level size worth a launch
    kernel_min_filter: int = 512  # SSTable entries worth a launch
    kernel_min_merge: int = 1024  # total keys in a 2-way merge round
    # Not in this package yet; setting one raises NotImplementedError
    # naming the ROADMAP item that ports it.
    wal_dir: str | None = None
    procs: int | None = None
    scheduler: bool | None = None
    tombstone_trigger: float | None = None

    def __post_init__(self) -> None:
        for name, item in _DEFERRED.items():
            if getattr(self, name) not in (None, 0, False):
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported to repro_torch "
                    f"yet: ROADMAP {item}")
        resolve_device(self.device)  # raises where CUDA is absent


class ShardExecutor:
    def __init__(self, tree: LSMTree, config: EngineConfig, device):
        self.tree = tree
        self.config = config
        self.device = device
        self.cache = BlockCache(self.config.cache_blocks)
        self.kernels = KernelCounters()
        # Device-resident packed filter state for the fused cascade AND
        # the per-level kernel route (per-SSTable pieces + GLORAN
        # interval views, structurally invalidated).
        self.registry = DeviceFilterRegistry(device, self.kernels)
        # Compactions route their two-run merge through the gated
        # merge-rank kernel closure.
        tree.compaction_rank_fn = self._rank_fn()

    # ----------------------------------------------------------- writes
    def put_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Insert a batch of (key, val) pairs into the shard's tree."""
        self.tree.put_batch(keys, vals)

    def delete_batch(self, keys: np.ndarray) -> None:
        """Point-delete a batch of keys (one tombstone each)."""
        self.tree.delete_batch(keys)

    def range_delete_arrays(self, los: np.ndarray, his: np.ndarray) -> None:
        """Columnar batch range delete: the plan step's clipped bound
        arrays go straight into the tree (no tuple round trip)."""
        self.tree.range_delete_arrays(los, his)

    def flush(self) -> None:
        """Flush the shard's memtable (and LRR buffer) to level 0."""
        self.tree.flush()

    # ------------------------------------------------ uniform surface
    @property
    def io_reads(self) -> int:
        return self.tree.io.reads

    @property
    def io_writes(self) -> int:
        return self.tree.io.writes

    @property
    def num_entries(self) -> int:
        return self.tree.num_entries

    def cache_snapshot(self) -> dict:
        return self.cache.snapshot()

    def stats_full(self) -> dict:
        """Every per-shard ledger ``engine.stats()`` rolls up, in one
        JSON-able document."""
        tree = self.tree
        return {
            "io": tree.io.snapshot(),
            "entries": int(tree.num_entries),
            "kernels": self.kernels.snapshot(),
            "cache": self.cache.snapshot(),
            "staging": (tree.gloran.buffer_snapshot()
                        if tree.gloran is not None else None),
            "lsm": {
                "compaction_bytes": {int(i): int(b) for i, b in
                                     tree.compaction_bytes.items()},
                "rt_compaction_bytes": {int(i): int(b) for i, b in
                                        tree.rt_compaction_bytes.items()},
                "rt_density": {i: round(level_rt_density(tree, i), 4)
                               for i in range(len(tree.levels))},
                "num_levels": len(tree.levels),
            },
        }

    # ------------------------------------------------------- typed plans
    def run_plan(self, sp: ShardPlan) -> tuple[list, float]:
        """Execute one compiled ``ShardPlan`` in request order.

        Each ``PlanStep`` is one vectorized sub-batch on this shard's
        batched paths.  Returns ``(payloads, wall_seconds)`` where
        payloads carry the get steps' ``(idx, found, vals)`` for
        the engine's deterministic merge-back; ``wall_seconds`` is this
        shard's busy time.  Thread-safe across shards: every touched
        structure (tree, cache, counters, I/O ledger) is shard-local.
        """
        t0 = time.perf_counter()
        payloads: list = []
        with span("shard.plan", shard=sp.shard, batch=sp.seq,
                  steps=len(sp.steps), n_ops=sp.n_ops,
                  device=str(self.device)):
            for step in sp.steps:
                with span("shard." + KIND_NAMES[step.kind], n=len(step),
                          shard=sp.shard, batch=sp.seq):
                    if step.kind == OP_PUT:
                        self.put_batch(step.keys, step.vals)
                    elif step.kind == OP_DELETE:
                        self.delete_batch(step.keys)
                    elif step.kind == OP_GET:
                        found, vals = self.get_batch(step.keys)
                        payloads.append((step.idx, found, vals))
                    else:  # OP_RANGE_DELETE (bounds clipped per shard)
                        self.range_delete_arrays(step.los, step.his)
        return payloads, time.perf_counter() - t0

    # ------------------------------------------------------------ reads
    def _validity_fn(self):
        """The GLORAN validity hook: batched ``is_deleted`` verdicts with
        per-level probes routed through the interval kernel (when gating
        admits a launch).  None for non-GLORAN strategies."""
        t = self.tree
        if t.strategy == "gloran" and t.gloran is not None:
            return lambda k, s: t.gloran.is_deleted_batch(
                k, s, query_fn=self._query_drtree_level)
        return None

    def get_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookups; (found, vals), order = request order.

        The fused cascade hook answers the whole filter stack in one
        launch when its gates admit the batch; the per-level bloom /
        interval hooks serve the same call when it declines."""
        self.cache.op_class = "get"
        return self.tree.get_batch(
            np.asarray(keys, dtype=np.uint64),
            cache=self.cache if self.cache.enabled else None,
            bloom_fn=self._bloom_maybe,
            validity_fn=self._validity_fn(),
            cascade_fn=self._cascade)

    # --------------------------------------------------- cascade kernel
    def _cascade(self, keys: np.ndarray, resolved: np.ndarray,
                 seqs: np.ndarray) -> CascadeVerdict | None:
        """One fused launch for a lookup batch, or None to decline.

        Gates: the batch must be worth a launch (``kernel_min_batch``),
        the tree's packed view must exist (non-empty levels, u32-exact
        keys/seqs, within the pack budgets — see
        ``DeviceFilterRegistry``), and the query keys plus any
        memtable-resolved seqs must fit u32 working space.  A declined
        launch goes to the per-level route with identical results.
        """
        cfg = self.config
        if not cfg.use_cascade_kernel or len(keys) < cfg.kernel_min_batch:
            return None
        view = self.registry.view(self.tree)
        if view is None:
            return None
        if int(keys.max()) >= _U32_LIMIT:
            return None
        if resolved.any() and int(seqs[resolved].max()) >= _U32_LIMIT:
            return None
        maybe, hit, gl_cov, pos = cascade_lookup(
            keys.astype(np.uint32), fold64to32(keys),
            seqs.astype(np.uint32), resolved, view.state)
        self.kernels.cascade_calls += 1
        self.kernels.cascade_queries += len(keys)
        return CascadeVerdict(slots=view.slots, maybe=maybe, hit=hit,
                              pos=pos,
                              gl_cov=gl_cov if view.has_gloran else None)

    # ----------------------------------------------------- merge kernel
    def _rank_fn(self):
        """The compaction merge hook: two-way merge-round output
        positions through the merge-rank kernel when the round is big
        enough to pay for a launch and both runs fit u32 working space;
        declines (None -> host searchsorted) otherwise."""
        cfg = self.config
        if not cfg.use_merge_kernel:
            return None

        def rank(ka: np.ndarray, kb: np.ndarray):
            n = len(ka) + len(kb)
            if (n < cfg.kernel_min_merge or not len(ka) or not len(kb)
                    or int(ka[-1]) >= _U32_LIMIT
                    or int(kb[-1]) >= _U32_LIMIT):
                return None
            pa, pb = merge_ranks(ka.astype(np.uint32),
                                 kb.astype(np.uint32), self.device)
            self.kernels.merge_calls += 1
            self.kernels.merge_keys += n
            return pa, pb

        return rank

    # --------------------------------------------------- filter kernels
    def _bloom_maybe(self, lvl, keys: np.ndarray) -> np.ndarray:
        """SSTable filter verdicts; kernel-launched when worth it.

        Filter words go to the kernel as the registry's device-resident
        copy (uploaded once per run uid), so the per-level route stops
        re-uploading the filter on every probe."""
        cfg = self.config
        bb = lvl.bloom
        if (cfg.use_bloom_kernel and len(keys) >= cfg.kernel_min_batch
                and len(lvl) >= cfg.kernel_min_filter):
            out = bloom_probe(to_device(fold64to32(keys), self.device),
                              self.registry.bloom_words(lvl),
                              m_bits=bb.m_bits, seeds=bb.seeds)
            self.kernels.bloom_calls += 1
            self.kernels.bloom_queries += len(keys)
            return to_numpy(out, np.int32).astype(bool)
        return bb.might_contain(keys)

    def _query_drtree_level(self, lvl, keys: np.ndarray, seqs: np.ndarray,
                            io) -> np.ndarray:
        """Point-stab one DR-tree level; kernel-launched when worth it."""
        cfg = self.config
        if (cfg.use_interval_kernel
                and len(lvl) >= cfg.kernel_min_areas
                and len(keys) >= cfg.kernel_min_batch
                and int(keys.max()) < _U32_LIMIT
                and int(seqs.max()) < _U32_LIMIT):
            return self._interval_kernel_query(lvl, keys, seqs, io)
        return lvl.query_batch(keys, seqs, io=io)

    def _interval_kernel_query(self, lvl, keys: np.ndarray,
                               seqs: np.ndarray, io) -> np.ndarray:
        """One launch over a disjoint level; same I/O as a probe."""
        lo32, hi32, smin32, smax32 = self._level_u32(lvl)
        io.read_blocks(lvl.probe_cost() * len(keys), tag="drtree_probe")
        out = interval_query(to_device(keys, self.device),
                             to_device(seqs, self.device),
                             lo32, hi32, smin32, smax32)
        self.kernels.interval_calls += 1
        self.kernels.interval_queries += len(keys)
        return to_numpy(out, np.int32).astype(bool)

    def _level_u32(self, lvl):
        """Clamped, padded u32 view of an immutable DR-tree level —
        the registry's device-resident piece (``clamp_level_u32``, the
        single source of the u32 transform), shared with the cascade's
        packed GLORAN view: one upload and one device copy serve both
        kernel paths."""
        live = [l for l in getattr(self.tree.gloran.index, "levels", [])
                if l is not None]
        return self.registry.gl_columns(lvl, live)
