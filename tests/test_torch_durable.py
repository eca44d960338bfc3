"""Durability in the port: ``repro_torch.durable`` on the CPU against the
reference's ``repro.durable``.

The pieces (atomic publication, the WAL's segments and frames, torn
tails, the manifest) are driven through both packages and must leave the
same bytes and read back the same frames; the engine wiring (the dirty
directory refusal, ``close``, the ``wal.*`` / ``recovery.*`` metrics)
must behave as the reference's.  The centerpiece is the crash sweep of
``tests/test_durable.py``: a port store's WAL is cut at a byte offset,
and the port's recovery must equal the reference's recovery of a copy of
the same directory, a store fed exactly the surviving frames, and the
strategy-independent oracle of those frames.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from repro.durable import atomic as jatomic
from repro.durable import wal as jwal
from repro.durable.manifest import LevelManifest as JLevelManifest
from repro_torch.durable import (FRAME_BATCH, LevelManifest, WalReader,
                                 WalWriter, recover, replay_frame,
                                 wal_has_frames)
from repro_torch.durable import atomic as tatomic
from repro_torch.durable import wal as twal
from repro_torch.durable.wal import _seg_path, shard_dir
from repro_torch.engine import EngineConfig
from repro_torch.lsm import STRATEGIES
from torch_durable_cells import (UNIVERSE, apply_workload,
                                 assert_same_store, crash_oracle,
                                 make_engine, mixed_ops, observe,
                                 recover_in, segment_files,
                                 truncate_wal_at)

torch.set_num_threads(1)


def frame_cols(i: int, n: int):
    kinds = np.full(n, i % 3, np.uint8)
    keys = np.arange(n, dtype=np.uint64) + np.uint64(i)
    return kinds, keys, keys * 2, keys * 3, keys * 4


def write_stream(wal_mod, d, n_frames, *, fsync="batch", segment_bytes=512,
                 n=8):
    w = wal_mod.WalWriter(str(d), 0, segment_bytes=segment_bytes,
                          fsync=fsync)
    sizes = [w.append(FRAME_BATCH, i, *frame_cols(i, n))
             for i in range(n_frames)]
    w.close()
    w.close()  # idempotent
    return w, sizes


# --------------------------------------------------------------- atomic
def test_atomic_publication_and_keep_last_k_match_reference(tmp_path):
    trees = {}
    for side, mod in (("port", tatomic), ("ref", jatomic)):
        d = tmp_path / side
        d.mkdir()
        for v in range(1, 6):
            mod.atomic_write_json(str(d / mod.versioned_name("M-", v,
                                                             ".json")),
                                  {"v": v, "x": [1, 2]}, fsync=v % 2 == 0)
        assert mod.list_versions(str(d), "M-", ".json") == [1, 2, 3, 4, 5]
        assert mod.keep_last_k(str(d), "M-", 2, ".json") == [1, 2, 3]
        # tmp siblings and foreign names are ignored
        (d / "M-00000009.json.tmp").write_text("")
        (d / "other.json").write_text("")
        assert mod.list_versions(str(d), "M-", ".json") == [4, 5]
        # A staged directory publishes over an older one; a crashed
        # writer's leftover is cleared.
        for body in ("old", "new"):
            stage = d / "snap-00000001.tmp"
            mod.clear_stale_tmp(str(stage))
            stage.mkdir()
            (stage / "meta.json").write_text(body)
            mod.atomic_publish_dir(str(stage), str(d / "snap-00000001"))
        assert not stage.exists()
        mod.fsync_dir(str(d))
        trees[side] = {p.name: p.read_bytes() for p in sorted(d.iterdir())
                       if p.is_file()}
        trees[side]["snap"] = (d / "snap-00000001" / "meta.json").read_text()
    assert trees["port"] == trees["ref"]
    assert trees["port"]["snap"] == "new"


# ------------------------------------------------------------------ wal
@pytest.mark.parametrize("fsync", ["batch", "rotate", "never"])
def test_wal_roundtrip_and_rotation_match_reference(tmp_path, fsync):
    w, sizes = write_stream(twal, tmp_path / "port", 10, fsync=fsync)
    jw, jsizes = write_stream(jwal, tmp_path / "ref", 10, fsync=fsync)
    assert sizes == jsizes
    assert w.segments_rotated > 0
    assert w.counters() == jw.counters()
    assert segment_files(tmp_path / "port") == segment_files(tmp_path /
                                                             "ref")
    for reader in (WalReader, jwal.WalReader):
        frames = reader(str(tmp_path / "port"), 0).read_frames()
        assert [fr.plan_seq for fr in frames] == list(range(10))
        for i, fr in enumerate(frames):
            for got, want in zip((fr.kinds, fr.keys, fr.vals, fr.los,
                                  fr.his), frame_cols(i, 8)):
                np.testing.assert_array_equal(got, want)
    assert wal_has_frames(str(tmp_path / "port"))
    assert not wal_has_frames(str(tmp_path / "empty"))


def test_wal_reopen_appends_after_tail(tmp_path):
    d = str(tmp_path)
    w = WalWriter(d, 0, fsync="never")
    w.append(FRAME_BATCH, 0, *frame_cols(0, 4))
    w.close()
    w2 = WalWriter(d, 0, fsync="never")
    w2.append(FRAME_BATCH, 1, *frame_cols(1, 2))
    w2.close()
    for reader in (WalReader, jwal.WalReader):
        frames = reader(d, 0).read_frames()
        assert [fr.plan_seq for fr in frames] == [0, 1]
        assert [len(fr) for fr in frames] == [4, 2]


def test_wal_torn_tail_every_offset_matches_reference(tmp_path):
    """Cut the single segment at EVERY byte offset: both readers keep
    exactly the frames whose bytes fully survived, agree on the durable
    offset, and the port's truncation leaves a stream both read whole."""
    d = str(tmp_path)
    w = WalWriter(d, 0, fsync="never")
    ends, at = [], 16  # segment header
    for i in range(4):
        at += w.append(FRAME_BATCH, i, *frame_cols(i, 3))
        ends.append(at)
    w.close()
    path = _seg_path(shard_dir(d, 0), 0)
    blob = open(path, "rb").read()
    assert len(blob) == ends[-1]
    for cut in range(len(blob) + 1):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        r, jr = WalReader(d, 0), jwal.WalReader(d, 0)
        frames, jframes = r.read_frames(), jr.read_frames()
        expect = sum(1 for e in ends if e <= cut)
        assert len(frames) == len(jframes) == expect, f"cut={cut}"
        assert (r.valid_segment, r.valid_offset, r.torn) == \
            (jr.valid_segment, jr.valid_offset, jr.torn), f"cut={cut}"
        r.truncate_torn_tail()
        assert len(WalReader(d, 0).read_frames()) == expect
        assert len(jwal.WalReader(d, 0).read_frames()) == expect


def test_wal_crc_corruption_stops_reader(tmp_path):
    d = str(tmp_path)
    w = WalWriter(d, 0, fsync="never")
    for i in range(3):
        w.append(FRAME_BATCH, i, *frame_cols(i, 4))
    w.close()
    path = _seg_path(shard_dir(d, 0), 0)
    blob = bytearray(open(path, "rb").read())
    blob[-5] ^= 0xFF  # scribble inside the last frame's payload
    open(path, "wb").write(bytes(blob))
    for reader in (WalReader, jwal.WalReader):
        r = reader(d, 0)
        assert len(r.read_frames()) == 2
        assert r.torn


# ------------------------------------------------------------- manifest
def test_manifest_versioned_commits_and_fallback(tmp_path):
    docs = {}
    for side, cls in (("port", LevelManifest), ("ref", JLevelManifest)):
        d = str(tmp_path / side)
        m = cls(d, keep=3, config={"x": 1}, fsync=False)
        assert (m.commit(), m.commit()) == (1, 2)
        m.doc["shards"]["0"] = {"levels": []}
        assert m.commit(fsync=True) == 3
        docs[side] = {os.path.basename(p): open(p, "rb").read()
                      for p in sorted(glob.glob(os.path.join(
                          d, "MANIFEST-*.json")))}
    assert docs["port"] == docs["ref"]
    d = str(tmp_path / "port")
    loaded = LevelManifest.load(d, fsync=False)
    assert loaded.version == 3 and loaded.config == {"x": 1}
    assert loaded.shard_record(0) == {"levels": []}
    # Damage the newest file: load falls back to the previous version
    # in both packages.
    newest = sorted(glob.glob(os.path.join(d, "MANIFEST-*.json")))[-1]
    open(newest, "w").write("{not json")
    assert LevelManifest.load(d, fsync=False).version == 2
    assert JLevelManifest.load(d, fsync=False).version == 2


def _without_uids(doc: dict) -> dict:
    """A manifest document with SSTable uids (a per-process counter)
    taken out of its level records."""
    out = dict(doc, shards={})
    for s, rec in doc["shards"].items():
        out["shards"][s] = dict(rec, levels=[
            None if lv is None else {k: v for k, v in lv.items()
                                     if k != "uid"}
            for lv in rec["levels"]])
    return out


def test_manifest_records_structure_on_flush_like_reference(tmp_path):
    docs = []
    for side in (True, False):
        d = tmp_path / str(side)
        eng = make_engine(side, d, shards=1)
        keys = np.arange(1, 200, dtype=np.uint64)
        eng.put_batch(keys, keys)
        eng.flush()
        eng.close()
        m = LevelManifest.load(str(d / "manifest"))
        rec = m.shard_record(0)
        assert rec is not None and any(lv for lv in rec["levels"])
        assert rec["seq"] == len(keys)
        assert [e.get("reason") for e in m.doc["edits"]].count("flush") == 1
        docs.append((m.version, _without_uids(m.doc)))
    assert docs[0] == docs[1]


# ------------------------------------------------------- engine wiring
def test_engine_refuses_dirty_wal_dir(tmp_path):
    eng = make_engine(True, tmp_path, shards=1)
    eng.put_batch(np.arange(1, 10, dtype=np.uint64),
                  np.arange(1, 10, dtype=np.uint64))
    eng.close()
    with pytest.raises(RuntimeError, match="recover"):
        make_engine(True, tmp_path, shards=1)
    # An empty stream is not dirty: a fresh store may open it.
    fresh = make_engine(True, tmp_path / "clean", shards=1)
    fresh.close()
    make_engine(True, tmp_path / "clean", shards=1).close()


def test_unknown_fsync_policy_raises():
    with pytest.raises(ValueError, match="fsync"):
        EngineConfig(device="cpu", fsync="sometimes")


def test_engine_context_manager_and_close_idempotent(tmp_path):
    with make_engine(True, tmp_path, shards=2) as eng:
        eng.put_batch(np.arange(1, 50, dtype=np.uint64),
                      np.arange(1, 50, dtype=np.uint64))
    eng.close()  # second close is a no-op
    assert eng._pools is None
    for sh in eng.shards:
        assert sh.wal._closed
    with pytest.raises(AssertionError, match="closed WAL"):
        eng.put_batch(np.arange(1, 3, dtype=np.uint64),
                      np.arange(1, 3, dtype=np.uint64))


def test_recover_default_config_wants_the_card(tmp_path):
    eng = make_engine(True, tmp_path, shards=1)
    eng.put_batch(np.arange(1, 10, dtype=np.uint64),
                  np.arange(1, 10, dtype=np.uint64))
    eng.close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recover(str(tmp_path))


def test_wal_and_recovery_metrics_match_reference(tmp_path):
    metrics = {}
    for side in (True, False):
        d = tmp_path / str(side)
        eng = make_engine(side, d, shards=2)
        keys = np.arange(1, 300, dtype=np.uint64)
        eng.put_batch(keys, keys)
        eng.range_delete(10, 20)
        eng.flush()
        m = eng.stats()["metrics"]
        assert m["wal.bytes"] > 0 and m["wal.fsyncs"] > 0
        assert m["wal.frames"] >= 1
        assert m["recovery.wall_s"] == 0.0
        eng.close()
        rec = recover_in(side, d)
        m2 = rec.stats()["metrics"]
        assert m2["recovery.wall_s"] > 0.0
        assert m2["recovery.frames_replayed"] >= 1
        rec.close()
        metrics[side] = [{k: v for k, v in mm.items()
                          if k.startswith(("wal.", "recovery."))
                          and k != "recovery.wall_s"} for mm in (m, m2)]
    assert metrics[True] == metrics[False]


def test_wal_append_precedes_the_plan_start_drain(tmp_path):
    """In ``run_plan`` the frame is appended before the scheduler drains
    due jobs, the point that replay mirrors at the start of each
    frame."""
    eng = make_engine(True, tmp_path, shards=2, scheduler=True,
                      pipeline=True)
    events = {0: [], 1: []}
    for s, sh in enumerate(eng.shards):
        for obj, name in ((sh, "run_plan"), (sh.wal, "append"),
                          (sh.scheduler, "run_due")):
            def spy(*a, _real=getattr(obj, name), _name=name, _s=s, **k):
                events[_s].append(_name)
                return _real(*a, **k)
            setattr(obj, name, spy)
    keys = np.arange(1, 401, dtype=np.uint64)
    for i in range(0, 400, 40):
        eng.put_batch(keys[i:i + 40], keys[i:i + 40])
    seen = {s: list(ev) for s, ev in events.items()}
    eng.close()
    for ev in seen.values():
        assert ev.count("run_due") > 0
        assert all(ev[i - 2:i] == ["run_plan", "append"]
                   for i, e in enumerate(ev) if e == "run_due"), ev


def test_replay_after_explicit_flush_keeps_level_shapes(tmp_path):
    eng = make_engine(True, tmp_path, shards=1)
    keys = np.arange(1, 40, dtype=np.uint64)  # below buffer capacity
    eng.put_batch(keys[:20], keys[:20])
    eng.flush()  # structure change outside any plan
    eng.put_batch(keys[20:], keys[20:])
    eng.close()
    rec = recover_in(True, tmp_path)
    assert_same_store(eng, rec)
    rec.close()


# ----------------------------------------------- crash consistency sweep
def run_crash_case(tmp, strategy, shards, seed, cut_frac):
    """A port store's WAL cut in shard 0 at ``cut_frac`` of its bytes:
    the port's recovery equals the reference's recovery of a copy of
    the directory, a port store fed exactly the surviving frames, and
    the frames' oracle."""
    wdir = tmp / "wal"
    eng = make_engine(True, wdir, shards=shards, strategy=strategy,
                      segment_bytes=2048)
    apply_workload(eng, mixed_ops(seed=seed, n_batches=4, batch=32))
    eng.close()
    sdir = shard_dir(str(wdir), 0)
    total = sum(os.path.getsize(s)
                for s in glob.glob(os.path.join(sdir, "*.wal")))
    truncate_wal_at(wdir, 0, int(cut_frac * total))
    shutil.copytree(wdir, tmp / "copy")
    surviving = {s: WalReader(str(wdir), s).read_frames()
                 for s in range(shards)}

    rec = recover_in(True, wdir)
    jrec = recover_in(False, tmp / "copy")
    assert rec.recovery["frames_replayed"] == \
        jrec.recovery["frames_replayed"] == \
        sum(len(f) for f in surviving.values())
    got = observe(rec)
    assert got == observe(jrec)
    # Both recoveries truncated the torn tail to the same bytes.
    assert segment_files(wdir) == segment_files(tmp / "copy")

    ref = make_engine(True, shards=shards, strategy=strategy)
    for s in range(shards):
        for fr in surviving[s]:
            replay_frame(ref.shards[s], fr)
    assert observe(ref) == got

    oracle = crash_oracle(surviving)
    keys = np.array(sorted(oracle), dtype=np.uint64)
    if len(keys):
        found, vals = rec.get_batch(keys)
        assert found.all()
        np.testing.assert_array_equal(
            vals, np.array([oracle[int(k)] for k in keys], np.uint64))
    sk, _ = rec.range_scan(0, UNIVERSE)
    np.testing.assert_array_equal(sk, keys)
    for e in (rec, jrec, ref):
        e.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("cut_frac", [0.33, 0.87])
def test_crash_consistency_sweep(tmp_path, strategy, shards, cut_frac):
    seed = 97 * STRATEGIES.index(strategy) + 13 * shards
    run_crash_case(tmp_path, strategy, shards, seed, cut_frac)
