"""Peaks of the chip and the bytes each store kernel's launch needs.

A kernel's roofline share is the least time its launches' bytes need at
the chip's memory rate, over the device time the profiler gave those
launches.  The bytes are counted from each launch's inputs (query
count, level sizes, Bloom filters), never from how the kernel is
written, so a later kernel that does the same work is read against the
same count.  The arithmetic is a copy of ``chip_smoke.py``'s
``search_sectors``, ``bloom_probe_counts`` and ``cascade_bytes``; the
hashes are copies of
``repro_torch.core.eve``'s ``fold64to32`` and ``mix32``.
"""

from __future__ import annotations

import numpy as np

# Published memory rate of each chip a cell may run on (data sheets).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
SECTOR = 32  # bytes of one DRAM sector

_MIX64_1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX64_2 = np.uint64(0x94D049BB133111EB)


def hbm_bytes_per_s(kind: str) -> float:
    """The published memory rate of the chip named ``kind``; raises for
    a chip the table does not hold, so no share is read against a
    guess."""
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise KeyError(f"no published memory rate for {kind!r}") from None


def fold64to32(x: np.ndarray) -> np.ndarray:
    """The 32-bit hash a Bloom probe takes of a 64-bit key."""
    x = np.asarray(x, dtype=np.uint64).copy()
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= _MIX64_1
    x ^= x >> np.uint64(27)
    x *= _MIX64_2
    x ^= x >> np.uint64(31)
    return (x ^ (x >> np.uint64(32))).astype(np.uint32)


def mix32(x: np.ndarray, seed) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32).copy()
    x ^= np.asarray(seed, dtype=np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def search_sectors(cnt: int, n: int) -> int:
    """Distinct 32-byte sectors n binary searches over cnt sorted u32
    touch below the levels they share: about log2(cnt / n) each, the
    last three halvings falling in one sector."""
    return n * max(1, int(np.ceil(np.log2(max(cnt, 2) / max(n, 1)))) - 2)


def bloom_probe_counts(hash32, words, m_bits, seeds) -> int:
    """Word reads a Bloom probe that stops at its first unset bit makes
    over these queries."""
    n = len(hash32)
    alive = np.ones(n, bool)
    reads = 0
    for s in seeds:
        reads += int(alive.sum())
        p = mix32(hash32, s) % np.uint32(m_bits)
        bit = (words[(p >> np.uint32(5)).astype(np.int64)]
               >> (p & np.uint32(31))) & np.uint32(1)
        alive &= bit == 1
    return reads


def cascade_bytes(keys: np.ndarray, blooms: list, key_cnt: list,
                  gl_cnt: list) -> int:
    """One fused lookup-cascade launch: the queries read and the outputs
    written once, and the distinct sectors of the fence and GLORAN
    searches, the Bloom probes, the hit and the area loads.  ``blooms``
    are the packed levels' filters as (words, m_bits, seeds),
    ``key_cnt`` their entries, ``gl_cnt`` the GLORAN levels' areas."""
    n = len(keys)
    qh = fold64to32(keys)
    probes = sum(bloom_probe_counts(qh, w, m, s) for w, m, s in blooms)
    sectors = (probes + sum(min(search_sectors(c, n) + n, c // 8 + 1)
                            for c in key_cnt)
               + sum(min(search_sectors(c, n), c // 8 + 1) + 3 * n
                     for c in gl_cnt))
    return 16 * n + (12 + 4 * len(key_cnt)) * n + SECTOR * sectors
