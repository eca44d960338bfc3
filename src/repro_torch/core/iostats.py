"""I/O cost accounting.

The paper (like Monkey/Dostoevsky/Lethe) evaluates every operation as a count
of disk-block I/Os with block size ``B``.  The store models its disk rather
than using one, so the framework carries an explicit I/O ledger: every structure that
"lives on disk" charges reads/writes here.  Benchmarks report these counts —
they are the paper's own metric — alongside wall time.

Sequential access over ``nbytes`` is charged ``ceil(nbytes / B)`` I/Os;
random block access is charged 1 I/O per block touched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class IOStats:
    """Mutable ledger of simulated block I/Os, split by cause."""

    block_size: int = 4096
    reads: int = 0
    writes: int = 0
    by_tag: dict = field(default_factory=dict)
    # Opt-in charging lock (``enable_locking``): plain ``+=`` is enough
    # on the per-shard FIFO, but with a background compaction scheduler
    # attached an engine-level drain point may charge from a caller
    # thread while the shard worker idles between plans — the lock
    # makes those interleavings count-exact.  None (the default) keeps
    # the hot path branch-cheap.
    _lock: object = field(default=None, repr=False, compare=False)

    def enable_locking(self) -> None:
        if self._lock is None:
            import threading
            self._lock = threading.Lock()

    def read_blocks(self, n: int, tag: str = "") -> None:
        # A zero charge is a no-op: it must not materialize a tag entry,
        # so ledgers stay comparable between paths that skip zero-work
        # stages entirely and paths that charge them as 0.
        n = int(n)
        if n == 0:
            return
        if self._lock is not None:
            with self._lock:
                self.reads += n
                if tag:
                    self.by_tag[tag] = self.by_tag.get(tag, 0) + n
            return
        self.reads += n
        if tag:
            self.by_tag[tag] = self.by_tag.get(tag, 0) + n

    def write_blocks(self, n: int, tag: str = "") -> None:
        n = int(n)
        if n == 0:
            return
        if self._lock is not None:
            with self._lock:
                self.writes += n
                if tag:
                    self.by_tag[tag] = self.by_tag.get(tag, 0) + n
            return
        self.writes += n
        if tag:
            self.by_tag[tag] = self.by_tag.get(tag, 0) + n

    def read_sequential(self, nbytes: int, tag: str = "") -> None:
        if nbytes > 0:
            self.read_blocks(math.ceil(nbytes / self.block_size), tag)

    def write_sequential(self, nbytes: int, tag: str = "") -> None:
        if nbytes > 0:
            self.write_blocks(math.ceil(nbytes / self.block_size), tag)

    @property
    def total(self) -> int:
        return self.reads + self.writes

    def snapshot(self) -> dict:
        return {
            "reads": self.reads,
            "writes": self.writes,
            "total": self.total,
            "by_tag": dict(self.by_tag),
        }

    def reset(self) -> None:
        self.reads = 0
        self.writes = 0
        self.by_tag.clear()


class ScopedIO:
    """Context manager measuring the I/O delta of a code region."""

    def __init__(self, stats: IOStats):
        self.stats = stats
        self.reads = 0
        self.writes = 0

    def __enter__(self) -> "ScopedIO":
        self._r0, self._w0 = self.stats.reads, self.stats.writes
        return self

    def __exit__(self, *exc) -> None:
        self.reads = self.stats.reads - self._r0
        self.writes = self.stats.writes - self._w0

    @property
    def total(self) -> int:
        return self.reads + self.writes
