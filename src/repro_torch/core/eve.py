"""Entry Validity Estimator (EVE) and Range-Aware Estimator (RAE), §4.3.

RAE = a Bloom filter over a *virtual bit array*: a linear scaling function
maps the key universe [0, U) onto ``m_virt`` positions; a deleted key range
[a, b) occupies the position segment [p(a), p(b)] and only those positions
are inserted into the Bloom filter.  A negative probe of the position of a
looked-up key proves the key is covered by NO range delete (no false
negatives), letting point lookups skip the global index entirely.

EVE chains RAEs with doubling capacities; each RAE records the min/max
deletion sequence numbers it holds, so a probe for an entry with sequence
``s`` walks newest -> oldest and stops once ``rae.max_seq <= s`` (records
there can only kill strictly older entries).  GC drops RAEs entirely below
the bottom-compaction watermark.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_MIX64_1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX64_2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= _MIX64_1
    x ^= x >> np.uint64(27)
    x *= _MIX64_2
    x ^= x >> np.uint64(31)
    return x


def fold64to32(x: np.ndarray) -> np.ndarray:
    """Fold uint64 items to uint32 (xor-fold after a 64-bit mix)."""
    h = _splitmix64(np.asarray(x, dtype=np.uint64))
    return (h ^ (h >> np.uint64(32))).astype(np.uint32)


def mix32(x: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """murmur3-style 32-bit finalizer; identical math in numpy, torch and
    CUDA so host filters and the `bloom_probe` kernel agree
    bit-exactly (the kernels work in 32-bit integers)."""
    x = np.asarray(x, dtype=np.uint32).copy()
    x ^= np.asarray(seed, dtype=np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


class BloomBits:
    """Plain Bloom filter over uint64 items, vectorized with numpy.

    Bit positions come from 32-bit mixing (``fold64to32`` + ``mix32``);
    the batched probe path has a CUDA kernel counterpart in
    ``repro_torch.kernels.bloom`` that reproduces this math bit-exactly."""

    def __init__(self, m_bits: int, n_hashes: int, seed: int = 0x5EED):
        self.m_bits = max(64, int(m_bits))
        self.n_hashes = int(n_hashes)
        self.words = np.zeros((self.m_bits + 31) // 32, dtype=np.uint32)
        self.seeds = mix32(
            np.arange(1, self.n_hashes + 1, dtype=np.uint32),
            np.uint32(seed & 0xFFFFFFFF))

    def _positions(self, items: np.ndarray) -> np.ndarray:
        # (n_items, n_hashes) bit positions.
        x32 = fold64to32(np.asarray(items, dtype=np.uint64))
        h = mix32(np.broadcast_to(x32[:, None],
                                  (len(x32), self.n_hashes)).copy(),
                  self.seeds[None, :])
        return h % np.uint32(self.m_bits)

    def insert(self, items: np.ndarray) -> None:
        pos = self._positions(np.atleast_1d(items)).ravel()
        np.bitwise_or.at(self.words, (pos >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (pos & np.uint32(31)))

    def might_contain(self, items: np.ndarray) -> np.ndarray:
        items = np.atleast_1d(items)
        pos = self._positions(items)
        w = self.words[(pos >> np.uint32(5)).astype(np.int64)]
        bit = (w >> (pos & np.uint32(31))) & np.uint32(1)
        return np.all(bit.astype(bool), axis=1)

    @property
    def nbytes(self) -> int:
        return self.words.nbytes


@dataclass
class RAEConfig:
    capacity: int = 800_000  # range records per RAE (paper default 0.8M)
    bits_per_record: int = 10
    n_hashes: int = 6  # ~= 0.69 * bits_per_record, capped
    key_universe: int = 1 << 63
    virt_scale: int = 4  # m_virt = capacity * virt_scale


class RAE:
    """One range-aware estimator in the EVE chain."""

    def __init__(self, config: RAEConfig, seed: int = 1):
        self.config = config
        self.m_virt = max(64, config.capacity * config.virt_scale)
        self.bloom = BloomBits(config.capacity * config.bits_per_record,
                               config.n_hashes, seed=seed)
        self.count = 0
        self.min_seq = None
        self.max_seq = 0

    def _pos(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        # p = floor(key * m_virt / U), computed in float-free integer math.
        shift = int(self.config.key_universe // self.m_virt) or 1
        return keys // np.uint64(shift)

    def insert_range(self, lo: int, hi: int, seq: int) -> None:
        """Mark the virtual-bit segment of deleted keys [lo, hi)."""
        self.insert_range_batch([lo], [hi], [seq])

    def insert_range_batch(self, los, his, seqs) -> None:
        """Batched ``insert_range``: one filter insert for the whole
        batch (identical bits — inserts are idempotent ORs)."""
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        if len(los) == 0:
            return
        p_lo = self._pos(los)
        p_hi = self._pos(np.maximum(los, his - np.uint64(1)))
        self.bloom.insert(np.concatenate(
            [np.arange(int(a), int(b) + 1, dtype=np.uint64)
             for a, b in zip(p_lo.tolist(), p_hi.tolist())]))
        self.count += len(los)
        self.max_seq = max(self.max_seq, int(seqs.max()))
        lo_seq = int(seqs.min())
        self.min_seq = lo_seq if self.min_seq is None else min(
            self.min_seq, lo_seq)

    def might_cover(self, keys: np.ndarray) -> np.ndarray:
        return self.bloom.might_contain(self._pos(np.atleast_1d(keys)))

    @property
    def full(self) -> bool:
        return self.count >= self.config.capacity

    @property
    def nbytes(self) -> int:
        return self.bloom.nbytes


class EVE:
    """Chained, doubling sequence of RAEs (Fig. 8)."""

    def __init__(self, config: RAEConfig | None = None):
        self.config = config or RAEConfig()
        self._next_seed = 1
        self.chain: list[RAE] = [self._new_rae(self.config.capacity)]

    def _new_rae(self, capacity: int) -> RAE:
        cfg = RAEConfig(capacity=capacity,
                        bits_per_record=self.config.bits_per_record,
                        n_hashes=self.config.n_hashes,
                        key_universe=self.config.key_universe,
                        virt_scale=self.config.virt_scale)
        self._next_seed += 1
        return RAE(cfg, seed=self._next_seed)

    @property
    def active(self) -> RAE:
        return self.chain[-1]

    def insert_range(self, lo: int, hi: int, seq: int) -> None:
        if self.active.full:
            self.chain.append(self._new_rae(self.active.config.capacity * 2))
        self.active.insert_range(lo, hi, seq)

    def insert_range_batch(self, los, his, seqs) -> None:
        """Batched inserts with the same chaining points as sequential
        ``insert_range`` calls: each chunk fills the active RAE to its
        capacity, then the chain doubles."""
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        i, n = 0, len(los)
        while i < n:
            if self.active.full:
                self.chain.append(
                    self._new_rae(self.active.config.capacity * 2))
            take = min(n - i,
                       self.active.config.capacity - self.active.count)
            self.active.insert_range_batch(los[i:i + take],
                                           his[i:i + take],
                                           seqs[i:i + take])
            i += take

    def maybe_deleted(self, key: int, entry_seq: int) -> bool:
        """False => the entry is PROVEN valid (skip the global index)."""
        for rae in reversed(self.chain):
            if rae.count and rae.max_seq <= entry_seq:
                break  # older RAEs can only kill strictly older entries
            if rae.count and bool(rae.might_cover(np.uint64(key))[0]):
                return True
        return False

    def maybe_deleted_batch(self, keys: np.ndarray,
                            entry_seqs: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        entry_seqs = np.asarray(entry_seqs, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=bool)
        for rae in reversed(self.chain):
            if rae.count == 0:
                continue
            relevant = ~out & (entry_seqs < np.uint64(rae.max_seq))
            if not relevant.any():
                continue
            out[relevant] = rae.might_cover(keys[relevant])
        return out

    def gc(self, watermark: int) -> None:
        """Drop RAEs that only hold records below the watermark (§4.4)."""
        keep = [r for r in self.chain[:-1]
                if r.count and r.max_seq > watermark]
        self.chain = keep + [self.chain[-1]]

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.chain)
