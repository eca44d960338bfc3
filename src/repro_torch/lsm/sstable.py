"""Sorted runs ("SSTables") with blocks, fence pointers and Bloom filters.

A run is a struct-of-arrays (keys, seqs, types, vals) sorted by key with
unique keys (leveling keeps one version per key per level; recency across
levels resolves versions).  Fence pointers (first key of each B-byte block)
live in memory; each point lookup that passes the Bloom filter costs one
block I/O, matching §2's cost model.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from ..core.areas import AreaSet
from ..core.disjointize import disjointize
from ..core.eve import BloomBits
from ..core.iostats import IOStats
from .format import LSMConfig, PUT, TOMBSTONE


_RUN_UID = itertools.count(1)


class SSTable:
    def __init__(self, keys: np.ndarray, seqs: np.ndarray, types: np.ndarray,
                 vals: np.ndarray, config: LSMConfig, seed: int = 0):
        assert len(keys) == len(seqs) == len(types) == len(vals)
        assert np.all(keys[:-1] < keys[1:]), "run must be sorted, unique"
        # Process-unique run id: block caches key cached blocks on
        # (uid, block), so entries of compacted-away runs age out safely.
        self.uid = next(_RUN_UID)
        self.keys = keys.astype(np.uint64, copy=False)
        self.seqs = seqs.astype(np.uint64, copy=False)
        self.types = types.astype(np.uint8, copy=False)
        self.vals = vals.astype(np.uint64, copy=False)
        self.config = config
        # Recorded so snapshots can rebuild this exact run (arrays +
        # seed fully determine the filter) on restore.
        self.seed = int(seed)
        n = len(keys)
        self.bloom = BloomBits(max(64, n * config.bloom_bits_per_key),
                               config.bloom_hashes, seed=seed or 17)
        if n:
            self.bloom.insert(self.keys)
        self.min_seq = int(self.seqs.min()) if n else 0
        self.max_seq = int(self.seqs.max()) if n else 0

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def nbytes(self) -> int:
        return len(self.keys) * self.config.entry_size

    @property
    def max_key(self) -> int:
        """Largest key in the run (0 when empty) — the u32-eligibility
        gate for device-resident packed views of this run."""
        return int(self.keys[-1]) if len(self.keys) else 0

    def data_blocks(self) -> int:
        return math.ceil(len(self.keys) / self.config.entries_per_block)

    # ------------------------------------------------------------- lookups
    def get(self, key: int, io: IOStats | None = None):
        """Returns (found, seq, type, val). Charges 1 I/O on Bloom pass."""
        key = np.uint64(key)
        if len(self.keys) == 0:
            return (False, 0, PUT, 0)
        if not bool(self.bloom.might_contain(key)[0]):
            return (False, 0, PUT, 0)
        if io is not None:
            io.read_blocks(1, tag="data_block")  # fence pointer -> 1 block
        i = int(np.searchsorted(self.keys, key))
        if i < len(self.keys) and self.keys[i] == key:
            return (True, int(self.seqs[i]), self.types[i], int(self.vals[i]))
        return (False, 0, PUT, 0)

    def get_batch(self, keys: np.ndarray, io: IOStats | None = None, *,
                  cache=None, maybe: np.ndarray | None = None):
        """Vectorized point lookups.

        Returns (found, seqs, types, vals); charges one block I/O per key
        that passes the Bloom filter (fence pointers are in memory).
        ``maybe`` optionally supplies a precomputed filter verdict (e.g.
        from the CUDA bloom kernel — bit-exact with the host filter);
        ``cache`` is an optional read-through block cache: block reads it
        already holds are not charged."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        found = np.zeros(n, dtype=bool)
        seqs = np.zeros(n, dtype=np.uint64)
        types = np.zeros(n, dtype=np.uint8)
        vals = np.zeros(n, dtype=np.uint64)
        if len(self.keys) == 0 or n == 0:
            return found, seqs, types, vals
        if maybe is None:
            maybe = self.bloom.might_contain(keys)
        idx = np.searchsorted(self.keys, keys[maybe])
        idxc = np.minimum(idx, len(self.keys) - 1)
        self.charge_probe(idxc, io, cache=cache)
        hit = self.keys[idxc] == keys[maybe]
        sub = np.flatnonzero(maybe)[hit]
        found[sub] = True
        seqs[sub] = self.seqs[idxc[hit]]
        types[sub] = self.types[idxc[hit]]
        vals[sub] = self.vals[idxc[hit]]
        return found, seqs, types, vals

    def charge_probe(self, pos: np.ndarray, io: IOStats | None = None, *,
                     cache=None) -> None:
        """Charge the data-block reads of filter-passing point probes.

        ``pos`` holds the candidate entry index of every probe that
        passed this run's Bloom filter (the fence-pointer search result,
        e.g. the fused cascade kernel's per-level output) — exactly the
        indices ``get_batch`` derives before charging, so the charges
        are identical: one block per probe, or only cache-missed blocks
        when a read-through ``cache`` absorbs them.
        """
        if io is None or len(pos) == 0:
            return
        if cache is not None:
            blocks = pos // self.config.entries_per_block
            hits = cache.probe_many(self.uid, blocks)
            io.read_blocks(int((~hits).sum()), tag="data_block")
        else:
            io.read_blocks(len(pos), tag="data_block")

    def rows_at(self, pos: np.ndarray):
        """Gather (seqs, types, vals) at known entry positions — the
        data-block payload step of a mask-driven lookup, after
        ``charge_probe`` paid for the reads."""
        return self.seqs[pos], self.types[pos], self.vals[pos]

    def range_slice(self, lo: int, hi: int, io: IOStats | None = None):
        """Entries with lo <= key < hi; charges sequential block reads."""
        lo_i = int(np.searchsorted(self.keys, np.uint64(lo)))
        hi_i = int(np.searchsorted(self.keys, np.uint64(hi)))
        cnt = hi_i - lo_i
        if io is not None and cnt > 0:
            io.read_blocks(
                1 + (cnt * self.config.entry_size) // self.config.block_size,
                tag="range_scan")
        sl = slice(lo_i, hi_i)
        return (self.keys[sl], self.seqs[sl], self.types[sl], self.vals[sl])

    def range_slice_many(self, los: np.ndarray, his: np.ndarray,
                         io: IOStats | None = None, *,
                         cache=None) -> list[tuple]:
        """One ``range_slice`` per [lo, hi) pair, with the slice bounds
        and the sequential-read charges computed vectorized across the
        whole batch (charges are identical to per-call ``range_slice``).

        ``cache`` is an optional read-through block cache: instead of the
        flat sequential-read formula, each scan charges exactly the data
        blocks its slice touches that the cache does not already hold —
        so repeated scans of hot slabs stop paying I/O, same as point
        lookups (scan-resident blocks are admitted read-through)."""
        lo_i = np.searchsorted(self.keys, np.asarray(los, np.uint64))
        hi_i = np.searchsorted(self.keys, np.asarray(his, np.uint64))
        cnts = hi_i - lo_i
        if io is not None and cnts.any():
            if cache is not None:
                epb = self.config.entries_per_block
                misses = 0
                for a, b in zip(lo_i.tolist(), hi_i.tolist()):
                    if b <= a:
                        continue
                    blocks = np.arange(a // epb, (b - 1) // epb + 1)
                    hits = cache.probe_many(self.uid, blocks)
                    misses += int((~hits).sum())
                io.read_blocks(misses, tag="range_scan")
            else:
                nz = cnts[cnts > 0]
                io.read_blocks(
                    int((1 + (nz * self.config.entry_size) //
                         self.config.block_size).sum()), tag="range_scan")
        return [(self.keys[a:b], self.seqs[a:b], self.types[a:b],
                 self.vals[a:b]) for a, b in zip(lo_i.tolist(),
                                                 hi_i.tolist())]


class RangeTombstoneBlock:
    """Per-level range-tombstone block (the LRR / RocksDB design, §3).

    Tombstones (start, end, seq) are sorted by start key.  A probe for key v
    must retrieve every tombstone whose start <= v (variable range lengths
    prevent pruning): 1 I/O for the first page plus sequential reads —
    exactly Eq. (1)'s ``1 + cnt * 2k / B`` term.
    """

    def __init__(self, starts, ends, seqs, config: LSMConfig):
        order = np.argsort(starts, kind="stable")
        self.starts = np.asarray(starts, dtype=np.uint64)[order]
        self.ends = np.asarray(ends, dtype=np.uint64)[order]
        self.seqs = np.asarray(seqs, dtype=np.uint64)[order]
        self.config = config
        self._stab: tuple | None = None  # lazy disjoint step function

    @staticmethod
    def empty(config: LSMConfig) -> "RangeTombstoneBlock":
        z = np.zeros(0, dtype=np.uint64)
        return RangeTombstoneBlock(z, z.copy(), z.copy(), config)

    def __len__(self) -> int:
        return len(self.starts)

    @property
    def nbytes(self) -> int:
        return len(self.starts) * self.config.range_tombstone_size

    def _step_fn(self) -> tuple:
        """Disjoint max-seq step function over the tombstones (lazy).

        Reuses the paper's disjointization (§4.2, ``core.disjointize``):
        tombstone (start, end, seq) is the effective area [start, end) x
        [0, seq), and disjointizing the set yields key-disjoint segments
        whose ``smax`` is exactly the max covering seq — so each probe is
        one ``searchsorted`` over segment starts instead of an
        O(keys x tombstones) cover mask.  Blocks are immutable (merges
        build new ones), so the function is computed once per block.
        """
        if self._stab is None:
            s = disjointize(AreaSet(self.starts, self.ends,
                                    np.zeros(len(self.starts), np.uint64),
                                    self.seqs))
            self._stab = (s.lo, s.hi, s.smax)
        return self._stab

    def probe(self, key: int, io: IOStats | None = None) -> int:
        """Max tombstone seq covering ``key`` (0 if none). Charges the
        paper's probe cost."""
        if len(self.starts) == 0:
            return 0
        return int(self.probe_batch(np.asarray([key], np.uint64),
                                    io=io)[0])

    def probe_batch(self, keys: np.ndarray,
                    io: IOStats | None = None) -> np.ndarray:
        """Vectorized probe: max covering seq per key.

        I/O charges are the per-key retrieval cost of Eq. (1) — every
        tombstone with start <= key streams in — while the verdict comes
        from the disjoint step function (O(log tombstones) per key).
        """
        keys = np.asarray(keys, dtype=np.uint64)
        if len(self.starts) == 0:
            if io is not None and len(keys):
                io.read_blocks(len(keys), tag="rt_block")
            return np.zeros(len(keys), dtype=np.uint64)
        if io is not None:
            cnts = np.searchsorted(self.starts, keys, side="right")
            ios = 1 + (cnts * self.config.range_tombstone_size) // \
                self.config.block_size
            io.read_blocks(int(ios.sum()), tag="rt_block")
        lo, hi, smax = self._step_fn()
        i = np.searchsorted(lo, keys, side="right").astype(np.int64) - 1
        ic = np.maximum(i, 0)
        cov = (i >= 0) & (keys < hi[ic])
        return np.where(cov, smax[ic], np.uint64(0)).astype(np.uint64)

    def merge(self, other: "RangeTombstoneBlock") -> "RangeTombstoneBlock":
        return RangeTombstoneBlock(
            np.concatenate([self.starts, other.starts]),
            np.concatenate([self.ends, other.ends]),
            np.concatenate([self.seqs, other.seqs]), self.config)

    def max_covering_batch(self, keys: np.ndarray) -> np.ndarray:
        return self.probe_batch(keys, io=None)


def build_sstable(keys, seqs, types, vals, config: LSMConfig,
                  io: IOStats | None = None, seed: int = 0,
                  presorted: bool = False) -> SSTable:
    """Sort + dedup (keep the newest version per key) and charge the
    sequential write I/O of the run.

    ``presorted=True`` skips the lexsort for input that is already
    key-sorted with duplicate keys adjacent (a memtable's cached
    columnar snapshot, or a two-run sorted-view merge): dedup resolves
    each adjacent group to its max-seq entry, which — sequence numbers
    being unique — selects exactly the rows the lexsort path keeps, so
    the built run (bloom bits included: same key set, same seed) is
    byte-identical either way.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    seqs = np.asarray(seqs, dtype=np.uint64)
    types = np.asarray(types, dtype=np.uint8)
    vals = np.asarray(vals, dtype=np.uint64)
    if presorted:
        n = len(keys)
        if n:
            new_grp = np.empty(n, dtype=bool)
            new_grp[0] = True
            np.not_equal(keys[1:], keys[:-1], out=new_grp[1:])
            if not new_grp.all():  # duplicate keys across merged runs
                starts = np.flatnonzero(new_grp)
                grp_max = np.maximum.reduceat(seqs, starts)
                gid = np.cumsum(new_grp) - 1
                keep = seqs == grp_max[gid]
                keys, seqs, types, vals = (keys[keep], seqs[keep],
                                           types[keep], vals[keep])
    else:
        # Sort by (key, seq); the last duplicate of each key is the
        # newest.
        order = np.lexsort((seqs, keys))
        keys, seqs, types, vals = (keys[order], seqs[order], types[order],
                                   vals[order])
        last = np.ones(len(keys), dtype=bool)
        last[:-1] = keys[1:] != keys[:-1]
        keys, seqs, types, vals = (keys[last], seqs[last], types[last],
                                   vals[last])
    t = SSTable(keys, seqs, types, vals, config, seed=seed)
    if io is not None:
        io.write_sequential(t.nbytes, tag="flush_or_compact")
    return t
