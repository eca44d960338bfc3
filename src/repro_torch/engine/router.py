"""Shard routing: partition op batches across shards, merge in order.

Two partition schemes:

  hash    shard = mix64(key) % N.  Point ops spread uniformly; a range
          delete broadcasts to every shard (its keys are scattered).
  range   the key universe is cut into N equal slabs; point ops go to
          their slab, range ops touch only overlapping slabs (clipped,
          so each shard's global index never learns about foreign keys).

Every key deterministically owns exactly one shard, so per-shard sequence
numbers are enough for correctness: visibility (newest-wins, range-delete
kills strictly older) only ever compares entries of the SAME key, and a
key's whole history lives on one shard in arrival order.

``split`` returns per-shard index arrays; callers scatter per-shard
results through those indices to restore request order exactly.
"""

from __future__ import annotations

import numpy as np

_MIX_MUL = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (same mixing family as repro.core.eve)."""
    x = np.asarray(x, dtype=np.uint64) * _MIX_MUL
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(29)
    return x


class ShardRouter:
    def __init__(self, num_shards: int, partition: str = "hash",
                 universe: int = 1 << 63):
        assert num_shards >= 1
        assert partition in ("hash", "range"), partition
        self.num_shards = num_shards
        self.partition = partition
        self.universe = int(universe)
        # Slab width for range partitioning (ceil so N slabs cover U).
        self._width = -(-self.universe // num_shards)

    # ------------------------------------------------------------ points
    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Owning shard of each key; (n,) int64."""
        keys = np.asarray(keys, dtype=np.uint64)
        if self.num_shards == 1:
            return np.zeros(len(keys), dtype=np.int64)
        if self.partition == "hash":
            return (_mix64(keys) % np.uint64(self.num_shards)).astype(
                np.int64)
        return np.minimum(keys // np.uint64(self._width),
                          self.num_shards - 1).astype(np.int64)

    def shard_of_scalar(self, key: int) -> int:
        return int(self.shard_of(np.asarray([key], dtype=np.uint64))[0])

    def split(self, keys: np.ndarray) -> list[np.ndarray]:
        """Index arrays per shard: keys[idx[s]] is shard s's sub-batch.

        Indices are ascending within each shard (stable), so per-shard
        sub-batches preserve the request's relative order; scattering
        results back through idx[s] restores full request order.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        if self.num_shards == 1:
            return [np.arange(len(keys))]
        sid = self.shard_of(keys)
        order = np.argsort(sid, kind="stable")
        counts = np.bincount(sid, minlength=self.num_shards)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        return [order[bounds[s]:bounds[s + 1]]
                for s in range(self.num_shards)]

    # ------------------------------------------------------------ ranges
    def clip_ranges(self, los, his) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
        """Vectorized shard visits for a batch of [lo, hi) range ops.

        Returns ``(rids, shards, clos, chis)`` parallel arrays, one row
        per (range, shard) visit, ordered by rid then shard: range op
        ``rids[i]`` must visit ``shards[i]`` with the clipped sub-range
        [``clos[i]``, ``chis[i]``).  Under hash partitioning every range
        broadcasts unclipped (its keys are scattered); under range
        partitioning each range visits only the slabs it overlaps, and
        the last slab is unbounded above (``shard_of`` clamps every key
        >= universe into it, so range ops must reach them too).
        """
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        nr = len(los)
        assert len(his) == nr
        if nr and not (los < his).all():
            bad = int(np.flatnonzero(los >= his)[0])
            raise ValueError(f"empty range [{los[bad]}, {his[bad]})")
        ns = self.num_shards
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.uint64), np.zeros(0, np.uint64))
        if nr == 0:
            return empty
        if self.partition == "hash" or ns == 1:
            return (np.repeat(np.arange(nr, dtype=np.int64), ns),
                    np.tile(np.arange(ns, dtype=np.int64), nr),
                    np.repeat(los, ns), np.repeat(his, ns))
        w = np.uint64(self._width)
        first = np.minimum(los // w, np.uint64(ns - 1)).astype(np.int64)
        last = np.minimum((his - np.uint64(1)) // w,
                          np.uint64(ns - 1)).astype(np.int64)
        counts = last - first + 1
        total = int(counts.sum())
        rids = np.repeat(np.arange(nr, dtype=np.int64), counts)
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        shards = first[rids] + (np.arange(total, dtype=np.int64)
                                - np.repeat(offs, counts))
        slab_lo = shards.astype(np.uint64) * w
        slab_hi = np.where(shards < ns - 1,
                           (shards.astype(np.uint64) + np.uint64(1)) * w,
                           his[rids])
        clos = np.maximum(los[rids], slab_lo)
        chis = np.minimum(his[rids], slab_hi)
        keep = clos < chis
        if keep.all():
            return rids, shards, clos, chis
        return rids[keep], shards[keep], clos[keep], chis[keep]

    def shards_for_range(self, lo: int, hi: int) -> list[tuple[int, int,
                                                               int]]:
        """(shard, lo', hi') per shard a range op must visit."""
        _, shards, clos, chis = self.clip_ranges([lo], [hi])
        return [(int(s), int(a), int(b))
                for s, a, b in zip(shards, clos, chis)]

    def split_ranges(self, ranges) -> list[list[tuple[int, int, int]]]:
        """Per-shard worklists for a batch of range ops.

        Returns one list per shard of ``(rid, lo', hi')`` visits, where
        ``rid`` indexes the request batch and [lo', hi') is the clipped
        sub-range that shard must serve.  Within a shard, visits keep
        request order (rid ascending), so batched range ops interleave
        correctly with the shard's other work; callers reassemble
        per-request results by rid.  Range partitioning visits only
        overlapping slabs; hash partitioning broadcasts (see
        ``shards_for_range``).
        """
        ranges = list(ranges)
        out: list[list[tuple[int, int, int]]] = [
            [] for _ in range(self.num_shards)]
        rids, shards, clos, chis = self.clip_ranges(
            [r[0] for r in ranges], [r[1] for r in ranges])
        for rid, s, lo, hi in zip(rids.tolist(), shards.tolist(),
                                  clos.tolist(), chis.tolist()):
            out[s].append((rid, lo, hi))
        return out
