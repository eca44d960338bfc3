"""The comparison that decides ``correct``: every answer the store gave
against the reference model at the same read point."""

from __future__ import annotations

import numpy as np

from .model import StreamModel


def compare_gets(model: StreamModel, records: list) -> tuple[int, int]:
    """(wrong, compared) over get answers, one per key looked up.

    ``records``: (keys, read point, found, values) per get batch.  An
    answer is wrong where found differs, or where a found key's value
    does (the value of a key not found is unspecified)."""
    if not records:
        return 0, 0
    q = np.concatenate([r[0] for r in records])
    at = np.concatenate([np.full(len(r[0]), r[1], np.int64)
                         for r in records])
    found = np.concatenate([np.asarray(r[2], bool) for r in records])
    vals = np.concatenate([np.asarray(r[3], np.uint64) for r in records])
    want_f, want_v = model.lookup(q, at)
    wrong = (found != want_f) | (found & (vals != want_v))
    return int(wrong.sum()), len(q)


def compare_scans(model: StreamModel, records: list) -> tuple[int, int]:
    """(wrong, compared) over scans: a scan is wrong unless its keys and
    values equal the reference's exactly, in order.

    ``records``: (lo, hi, read point, [(keys, values), ...]) per scan
    batch."""
    wrong = compared = 0
    for lo, hi, at, got in records:
        want = model.scan(lo, hi, at)
        if len(got) != len(want):
            wrong += len(want)
            compared += len(want)
            continue
        for (gk, gv), (wk, wv) in zip(got, want):
            compared += 1
            if not (np.array_equal(np.asarray(gk, np.uint64), wk)
                    and np.array_equal(np.asarray(gv, np.uint64), wv)):
                wrong += 1
    return wrong, compared
