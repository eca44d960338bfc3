"""The plain reference: a NumPy model of a key-value op stream.

Semantics, as the store's configuration states them: every write op
takes the next position in the order the store received it, batch by
batch and within a batch by position (a write batch is its puts, then
its range deletes).  A read sees every write op before its read point.
A key is live at a read point if its last put before that point came
after every range delete [lo, hi) covering it before that point; it
then holds that put's value.  A scan of [lo, hi) returns the live keys
in it, sorted, with their values.

The model imports nothing of the program under test: it replays the
whole stream (preload, warm-up and window) from the generated inputs
alone.
"""

from __future__ import annotations

import numpy as np

_POS_BITS = 32


class StreamModel:
    """Log write batches as they are acknowledged, then answer reads at
    any read point once the log is frozen."""

    def __init__(self):
        self._puts: list[tuple] = []  # (keys, vals, first position)
        self._rds: list[tuple] = []   # (lo, hi, first position)
        self.pos = 0                  # write ops logged so far
        self.starts: list[int] = []   # first position of each batch
        self._sorted = None

    def write(self, put_keys, put_vals, lo, hi) -> None:
        """One write batch: its puts, then its range deletes."""
        k = np.asarray(put_keys, np.uint64)
        v = np.asarray(put_vals, np.uint64)
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        if len(k):
            self._puts.append((k, v, self.pos))
        if len(lo):
            self._rds.append((lo, hi, self.pos + len(k)))
        if len(k) or len(lo):
            self.starts.append(self.pos)
        self.pos += len(k) + len(lo)
        self._sorted = None

    # ------------------------------------------------------------ index
    def _index(self):
        if self._sorted is not None:
            return self._sorted
        if self.pos >= 1 << _POS_BITS:
            raise ValueError(f"{self.pos} write ops: positions exceed "
                             f"{_POS_BITS} bits")

        def cat(parts, j):
            return (np.concatenate([p[j] for p in parts]) if parts
                    else np.zeros(0, np.uint64))

        keys, vals = cat(self._puts, 0), cat(self._puts, 1)
        ppos = (np.concatenate([p + np.arange(len(k), dtype=np.uint64)
                                for k, _, p in self._puts])
                if self._puts else np.zeros(0, np.uint64))
        if len(keys) and int(keys.max()) >= 1 << (64 - _POS_BITS):
            raise ValueError("keys exceed the model's 32-bit key field")
        comp = (keys << np.uint64(_POS_BITS)) | ppos
        o = np.argsort(comp, kind="stable")
        lo, hi = cat(self._rds, 0), cat(self._rds, 1)
        rpos = (np.concatenate([p + np.arange(len(l), dtype=np.uint64)
                                for l, _, p in self._rds])
                if self._rds else np.zeros(0, np.uint64))
        r = np.argsort(lo, kind="stable")
        self._sorted = {
            "comp": comp[o], "keys": keys[o], "vals": vals[o],
            "pos": ppos[o].astype(np.int64),
            "lo": lo[r], "hi": hi[r], "rpos": rpos[r].astype(np.int64),
            "maxlen": int((hi - lo).max()) if len(lo) else 0,
            "distinct": np.unique(keys),
        }
        return self._sorted

    # ------------------------------------------------------------ reads
    def lookup(self, q, at) -> tuple[np.ndarray, np.ndarray]:
        """(found, values) of keys ``q`` at read point(s) ``at`` (one
        int, or one per key); values of keys not found are 0."""
        s = self._index()
        q = np.asarray(q, np.uint64)
        at = np.broadcast_to(np.asarray(at, np.int64), q.shape)
        n = len(q)
        if not len(s["keys"]):
            return np.zeros(n, bool), np.zeros(n, np.uint64)
        # The last put of each key before its read point (the queries
        # searched in sorted order, for locality).
        qc = (q << np.uint64(_POS_BITS)) | at.astype(np.uint64)
        o = np.argsort(qc)
        j = np.empty(n, np.int64)
        j[o] = np.searchsorted(s["comp"], qc[o], side="left") - 1
        jc = np.maximum(j, 0)
        has_put = (j >= 0) & (s["keys"][jc] == q)
        put_pos = np.where(has_put, s["pos"][jc], -1)
        # The last range delete covering each key before its read point.
        last_rd = np.full(n, -1, np.int64)
        if len(s["lo"]):
            start = np.maximum(q.astype(np.int64) - (s["maxlen"] - 1), 0)
            a = np.empty(n, np.int64)
            b = np.empty(n, np.int64)
            a[o] = np.searchsorted(s["lo"], start[o].astype(np.uint64),
                                   "left")
            b[o] = np.searchsorted(s["lo"], q[o], "right")
            cnt = b - a
            qi = np.repeat(np.arange(n), cnt)
            off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt,
                                                        cnt)
            c = a[qi] + off
            ok = (s["hi"][c] > q[qi]) & (s["rpos"][c] < at[qi])
            np.maximum.at(last_rd, qi[ok], s["rpos"][c][ok])
        found = has_put & (put_pos > last_rd)
        vals = np.where(found, s["vals"][jc], np.uint64(0))
        return found, vals

    def scan(self, lo, hi, at) -> list[tuple[np.ndarray, np.ndarray]]:
        """Sorted (keys, values) of the live keys in each [lo, hi) at
        read point ``at``."""
        s = self._index()
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        d = s["distinct"]
        i0 = np.searchsorted(d, lo, "left")
        i1 = np.searchsorted(d, hi, "left")
        cnt = np.maximum(i1 - i0, 0)
        si = np.repeat(np.arange(len(lo)), cnt)
        off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        cand = d[i0[si] + off]
        found, vals = self.lookup(cand, at)
        bounds = np.r_[0, np.cumsum(cnt)]
        out = []
        for r in range(len(lo)):
            f = found[bounds[r]:bounds[r + 1]]
            out.append((cand[bounds[r]:bounds[r + 1]][f],
                        vals[bounds[r]:bounds[r + 1]][f]))
        return out
