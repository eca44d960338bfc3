"""Versioned dataset store on the GLORAN LSM-tree — the paper's own
motivating example ("discarding outdated dataset versions in machine
learning pipelines", §1).

Keys encode (version << 40 | sample_id); publishing a new version writes
its samples; ``purge_version`` is ONE range delete — O(log) instead of
millions of point tombstones — and readers' point lookups stay fast
because GLORAN keeps range records out of the lookup path (Table 2).

A copy of ``repro.data.versioned_store`` over the port's ``lsm``.
"""

from __future__ import annotations

import numpy as np

from ..core.gloran import GloranConfig
from ..lsm import LSMConfig, LSMTree

VERSION_SHIFT = 40


class VersionedSampleStore:
    def __init__(self, strategy: str = "gloran",
                 lsm_config: LSMConfig | None = None,
                 gloran_config: GloranConfig | None = None):
        self.tree = LSMTree(lsm_config or LSMConfig(buffer_capacity=4096),
                            strategy=strategy, gloran_config=gloran_config)
        self.live_versions: set[int] = set()
        self._max_sample: dict[int, int] = {}

    @staticmethod
    def key(version: int, sample_id: int) -> int:
        assert sample_id < (1 << VERSION_SHIFT)
        return (version << VERSION_SHIFT) | sample_id

    def publish(self, version: int, sample_ids: np.ndarray,
                payloads: np.ndarray) -> None:
        keys = (np.uint64(version) << np.uint64(VERSION_SHIFT)) | \
            np.asarray(sample_ids, dtype=np.uint64)
        self.tree.put_batch(keys, np.asarray(payloads, dtype=np.uint64))
        self.live_versions.add(version)
        hi = int(np.asarray(sample_ids).max())
        self._max_sample[version] = max(self._max_sample.get(version, 0),
                                        hi)

    def purge_version(self, version: int) -> None:
        """One range delete retires the whole version.

        The range is bounded by the version's max sample id so that
        point-delete baselines (Decomp/Lookup&D) stay tractable — they
        must touch every key in the range, which is the paper's point."""
        lo = version << VERSION_SHIFT
        hi = lo + self._max_sample.get(version, 0) + 1
        self.tree.range_delete(lo, hi)
        self.live_versions.discard(version)

    def get(self, version: int, sample_id: int):
        return self.tree.get(self.key(version, sample_id))

    def get_batch(self, version: int, sample_ids: np.ndarray):
        keys = (np.uint64(version) << np.uint64(VERSION_SHIFT)) | \
            np.asarray(sample_ids, dtype=np.uint64)
        return self.tree.get_batch(keys)

    def scan_version(self, version: int):
        lo = version << VERSION_SHIFT
        return self.tree.range_scan(lo, lo + (1 << VERSION_SHIFT))
