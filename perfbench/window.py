"""What a traced window recorded, as the per-layer readers see it.

A reader (``perfbench/layers/<metric>.py``) is a function ``read(w)`` of
a ``Window`` that returns the metric's value, or None where the window
holds nothing to read (no batch of that kind, no launch of that kernel,
no device trace).  Times are ``time.perf_counter`` seconds: the
program's spans are on that clock, and the device's operations are
moved onto it by the trace.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    seconds: float              # length of the window
    requests: list              # (kind, t0, t1, ops) per request, in order
    spans: list                 # the program's spans: dicts of name, t0,
                                # t1, tid, attrs
    stats0: dict                # engine.stats() at the window's start
    stats1: dict                # ... and at its end
    device_ops: list | None     # (name, start, end) of every device op
    kind: str                   # the chip's name (for its peaks)
    cascade_bytes: list = field(default_factory=list)  # per launch
    busy_s: float | None = None  # device busy seconds of the window

    # ---------------------------------------------------------- counters
    def delta(self, *path) -> float:
        """A cumulative counter of ``engine.stats()`` over the window
        (0 where the counter is absent on both sides)."""
        def get(d):
            for p in path:
                if not isinstance(d, dict) or p not in d:
                    return 0
                d = d[p]
            return d
        return float(get(self.stats1)) - float(get(self.stats0))

    def ops(self, kind: str) -> int:
        return sum(r[3] for r in self.requests if r[0] == kind)

    # ------------------------------------------------------------- spans
    def named(self, name: str) -> list:
        return [s for s in self.spans if s["name"] == name]

    def batch_kinds(self) -> dict:
        """Plan sequence number -> the kind of the request that planned
        it, by the request during which its ``plan.compile`` span ran."""
        if "_batch_kinds" in self.__dict__:
            return self.__dict__["_batch_kinds"]
        starts = np.array([r[1] for r in self.requests])
        out = self.__dict__["_batch_kinds"] = {}
        for s in self.named("plan.compile"):
            i = int(np.searchsorted(starts, s["t0"], "right")) - 1
            if i >= 0 and s["t0"] <= self.requests[i][2]:
                out[s["attrs"].get("batch")] = self.requests[i][0]
        return out

    def of_kind(self, name: str, kind: str) -> list:
        """Spans ``name`` of the batches of request kind ``kind``."""
        kinds = self.batch_kinds()
        return [s for s in self.named(name)
                if kinds.get(s["attrs"].get("batch")) == kind]

    def _children(self, tid, prefix: str):
        """(t0, t1) arrays, by start, of the spans on thread ``tid``
        whose names start with ``prefix``."""
        cache = self.__dict__.setdefault("_kids", {})
        if (tid, prefix) not in cache:
            iv = sorted((s["t0"], s["t1"]) for s in self.spans
                        if s["tid"] == tid and s["name"].startswith(prefix))
            cache[(tid, prefix)] = (np.array([a for a, _ in iv]),
                                    np.array([b for _, b in iv]))
        return cache[(tid, prefix)]

    def self_seconds(self, span: dict, prefix: str) -> float:
        """A span's length less the part its child spans whose names
        start with ``prefix`` cover, on the same thread."""
        t0, t1 = span["t0"], span["t1"]
        a0, b0 = self._children(span["tid"], prefix)
        lo, hi = np.searchsorted(a0, t0, "left"), np.searchsorted(a0, t1)
        covered, end = 0.0, t0
        for a, b in zip(a0[lo:hi], b0[lo:hi]):
            a, b = max(a, end), min(b, t1)
            if b > a:
                covered += b - a
                end = b
        return (t1 - t0) - covered

    def slowest_per_batch(self, name: str, kind: str,
                          minus: str | None = None) -> list:
        """For each batch of request kind ``kind``, the longest span
        ``name`` over its shards (less child spans starting with
        ``minus``), in seconds."""
        by_batch: dict = {}
        for s in self.of_kind(name, kind):
            v = self.self_seconds(s, minus) if minus else s["t1"] - s["t0"]
            b = s["attrs"].get("batch")
            by_batch[b] = max(by_batch.get(b, 0.0), v)
        return list(by_batch.values())

    # ------------------------------------------------------------ device
    def kernel_seconds(self, kernel: str) -> tuple[float, int]:
        """Device seconds and launches of ``kernel`` (device ops whose
        name holds ``<kernel>_kernel``)."""
        tag = f"{kernel}_kernel"
        hits = [e - s for n, s, e in (self.device_ops or []) if tag in n]
        return float(sum(hits)), len(hits)


def mean_ms(values: list) -> float | None:
    return 1e3 * float(np.mean(values)) if values else None
