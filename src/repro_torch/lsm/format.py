"""On-disk format model and configuration for the LSM-tree substrate.

Follows the paper's cost model (Table 1): memory buffer of F entries, size
ratio T, key size k, entry size e, block size B, Bloom filters with
``bits_per_key`` bits/entry (10 by default, RocksDB's default), leveling
compaction.  Keys are uint64; values are modeled as ``value_size`` opaque
bytes and carried as a uint64 payload for correctness checking.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PUT = np.uint8(0)
TOMBSTONE = np.uint8(1)


@dataclass
class LSMConfig:
    buffer_capacity: int = 4096  # F, entries
    size_ratio: int = 10  # T
    key_size: int = 256  # k bytes (paper default)
    value_size: int = 768  # bytes (paper default)
    block_size: int = 4096  # B bytes
    bloom_bits_per_key: int = 10
    bloom_hashes: int = 6
    key_universe: int = 1 << 63  # U

    @property
    def entry_size(self) -> int:  # e
        return self.key_size + self.value_size

    @property
    def entries_per_block(self) -> int:
        return max(1, self.block_size // self.entry_size)

    @property
    def range_tombstone_size(self) -> int:
        # A range tombstone encodes start and end keys: 2k (paper §3).
        return 2 * self.key_size

    def level_capacity(self, i: int) -> int:
        """Capacity in entries of on-disk level i (0-based: L1 == i=0)."""
        return self.buffer_capacity * self.size_ratio ** (i + 1)
