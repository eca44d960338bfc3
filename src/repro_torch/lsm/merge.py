"""Vectorized sorted-view merge across sorted runs (REMIX-style).

An LSM range scan produces one sorted slice per run (memtable + one per
level).  Instead of concatenating and re-sorting (O(n log n) with a full
lexsort per scan), the slices are merged as *sorted views*: a tournament
of vectorized two-way merges, where each element's position in the merged
output is computed with one ``searchsorted`` per side — the same
cross-run sorted-view idea REMIX uses to make LSM range queries cheap.

Runs are ``(keys, seqs, types, vals)`` tuples sorted by key.  Keys may
repeat *across* runs (versions of the same key on different levels);
``newest_wins`` then resolves each duplicate group to its max-seq entry,
which is exact because sequence numbers are unique per tree.
"""

from __future__ import annotations

import numpy as np

Run = tuple  # (keys, seqs, types, vals) | (keys, vals) | ... sorted by [0]


def merge_two(a: Run, b: Run, rank_fn=None) -> Run:
    """Merge two key-sorted runs into one, preserving all entries.

    Works for any tuple arity as long as element 0 is the sort key; the
    output position of each entry is its rank in the merged order, so the
    merge is a pure scatter (no comparison loop).  Ties place ``a``'s
    entries first (stable), which callers never rely on — duplicates are
    resolved by ``newest_wins`` on seq, not by run order.

    ``rank_fn(ka, kb) -> (pa, pb) | None`` optionally replaces HOW the
    ranks are computed (``repro_torch.engine`` supplies the CUDA merge-rank
    kernel, which gates itself and declines with None); the scatter —
    and the result — is identical either way.
    """
    ka, kb = a[0], b[0]
    na, nb = len(ka), len(kb)
    if na == 0:
        return b
    if nb == 0:
        return a
    ranks = rank_fn(ka, kb) if rank_fn is not None else None
    if ranks is not None:
        pa, pb = ranks
    else:
        pa = np.arange(na) + np.searchsorted(kb, ka, side="left")
        pb = np.arange(nb) + np.searchsorted(ka, kb, side="right")
    out = []
    for xa, xb in zip(a, b):
        x = np.empty(na + nb, dtype=xa.dtype)
        x[pa] = xa
        x[pb] = xb
        out.append(x)
    return tuple(out)


def empty_run() -> Run:
    """The empty (keys, seqs, types, vals) run."""
    z = np.zeros(0, np.uint64)
    return z, z.copy(), np.zeros(0, np.uint8), z.copy()


def merge_runs(parts: list[Run], empty: Run | None = None,
               rank_fn=None) -> Run:
    """Tournament-merge k key-sorted runs; duplicates stay adjacent.

    ``empty`` is returned when every part is empty (defaults to the
    4-tuple ``empty_run``; pass a matching-arity tuple otherwise).
    ``rank_fn`` is forwarded to every two-way round (see ``merge_two``).
    """
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return empty if empty is not None else empty_run()
    while len(parts) > 1:
        nxt = [merge_two(parts[i], parts[i + 1], rank_fn=rank_fn)
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def newest_wins(keys: np.ndarray, seqs: np.ndarray, typs: np.ndarray,
                vals: np.ndarray) -> Run:
    """Resolve duplicate keys in a key-sorted stream to the max-seq entry.

    Sequence numbers are unique per tree, so exactly one entry survives
    per key regardless of the order duplicates arrived in.
    """
    n = len(keys)
    if n == 0:
        return keys, seqs, typs, vals
    new_grp = np.empty(n, dtype=bool)
    new_grp[0] = True
    np.not_equal(keys[1:], keys[:-1], out=new_grp[1:])
    starts = np.flatnonzero(new_grp)
    grp_max = np.maximum.reduceat(seqs, starts)
    gid = np.cumsum(new_grp) - 1
    keep = seqs == grp_max[gid]
    return keys[keep], seqs[keep], typs[keep], vals[keep]
