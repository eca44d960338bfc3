"""The plain reference against a brute-force replay of every operation
in order, at a tiny size."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.reference import StreamModel, compare_gets, compare_scans

U = 512  # a small universe, so puts, deletes and reads collide


def replay(ops, upto: int) -> dict:
    """Live keys and values after the first ``upto`` write ops, replayed
    one by one into a dict."""
    live: dict = {}
    for op in ops[:upto]:
        if op[0] == "put":
            live[op[1]] = op[2]
        else:
            for k in [k for k in live if op[1] <= k < op[2]]:
                del live[k]
    return live


def stream(seed: int):
    """Write batches (puts, then range deletes) with reads between them:
    duplicate keys in a batch, deletes that kill puts of their own
    batch, puts that revive deleted keys."""
    rng = np.random.default_rng(seed)
    model, ops, reads = StreamModel(), [], []
    for b in range(30):
        n, m = int(rng.integers(0, 40)), int(rng.integers(0, 6))
        k = rng.integers(0, U, n).astype(np.uint64)
        if b % 3 == 2 and ops:  # revive keys deleted earlier
            k[: n // 2] = rng.integers(0, U, n // 2)
        v = rng.integers(1, 1 << 40, n).astype(np.uint64)
        lo = rng.integers(0, U - 8, m).astype(np.uint64)
        if m and n:  # a delete covering a put of this very batch
            lo[0] = max(int(k[-1]) - 3, 0)
        hi = lo + rng.integers(1, 64, m).astype(np.uint64)
        model.write(k, v, lo, hi)
        ops += [("put", int(a), int(c)) for a, c in zip(k, v)]
        ops += [("rd", int(a), int(c)) for a, c in zip(lo, hi)]
        reads.append(len(ops))
    return model, ops, reads


@pytest.mark.parametrize("seed", range(8))
def test_lookup_matches_replay(seed):
    model, ops, reads = stream(seed)
    q = np.arange(U, dtype=np.uint64)
    for at in [0, *reads]:
        live = replay(ops, at)
        found, vals = model.lookup(q, at)
        assert set(q[found].tolist()) == set(live)
        assert all(live[int(k)] == int(v) for k, v in zip(q[found],
                                                           vals[found]))
        assert not vals[~found].any()


@pytest.mark.parametrize("seed", range(8))
def test_scan_matches_replay(seed):
    model, ops, reads = stream(seed)
    rng = np.random.default_rng(100 + seed)
    lo = rng.integers(0, U, 16).astype(np.uint64)
    hi = lo + rng.integers(1, 200, 16).astype(np.uint64)
    for at in reads:
        live = replay(ops, at)
        for (k, v), a, b in zip(model.scan(lo, hi, at), lo, hi):
            want = sorted(x for x in live if a <= x < b)
            assert k.tolist() == want
            assert v.tolist() == [live[x] for x in want]


def test_reads_at_many_points_at_once():
    model, ops, reads = stream(3)
    q = np.tile(np.arange(U, dtype=np.uint64), len(reads))
    at = np.repeat(reads, U)
    found, vals = model.lookup(q, at)
    for i, r in enumerate(reads):
        f1, v1 = model.lookup(np.arange(U, dtype=np.uint64), r)
        assert (found[i * U:(i + 1) * U] == f1).all()
        assert (vals[i * U:(i + 1) * U] == v1).all()


def test_comparison_counts_wrong_answers():
    model, ops, reads = stream(5)
    q = np.arange(U, dtype=np.uint64)
    at = reads[-1]
    found, vals = model.lookup(q, at)
    assert compare_gets(model, [(q, at, found, vals)]) == (0, U)
    bad = vals.copy()
    bad[np.flatnonzero(found)[:3]] += np.uint64(1)
    assert compare_gets(model, [(q, at, found, bad)]) == (3, U)
    lost = found.copy()
    lost[np.flatnonzero(found)[:2]] = False
    assert compare_gets(model, [(q, at, lost, vals)]) == (2, U)
    lo, hi = np.array([0, 100], np.uint64), np.array([300, 400], np.uint64)
    res = model.scan(lo, hi, at)
    assert compare_scans(model, [(lo, hi, at, res)]) == (0, 2)
    cut = [(res[0][0][:-1], res[0][1][:-1]), res[1]]
    assert compare_scans(model, [(lo, hi, at, cut)]) == (1, 2)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    code = ("import sys; import perfbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    mods = set(eval(out.stdout))
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                       "torch"}
