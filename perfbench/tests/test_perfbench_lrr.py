"""The readers of the LRR store's range tombstones (``lsm.rt_mem_ms``,
``lsm.rt_levels_ms``, ``lsm.rt_insert_ms``, ``lsm.rt_reads_per_get``) on
the CPU: a traced tiny copy of the cell ``lrr-8shard-3m.lookup90-rd1``,
with enough keys that every shard's levels hold range-tombstone blocks,
reads all four; a traced tiny GLORAN cell reads none; and windows made
by hand pin down a store whose levels hold no block yet (0) and a
program without the spans (None)."""

from __future__ import annotations

import json
import time

import pytest

import perfbench.harness as harness
from perfbench.harness import load_bench, reader, run_cell
from perfbench.window import Window
from conftest import make_tiny_root

CELL = "lrr-8shard-3m.lookup90-rd1"
GLORAN = "gloran-8shard-3m.lookup90-rd1"
NEW = ("lsm.rt_mem_ms", "lsm.rt_levels_ms", "lsm.rt_insert_ms",
       "lsm.rt_reads_per_get")
# 8,192 puts and 656 range deletes a shard: each shard flushes twice
# during the preload, so its levels hold range-tombstone blocks.
LEVEL_KEYS = 65_536


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each cell traced on the CPU: (result line, window, client)."""
    root = make_tiny_root(tmp_path_factory.mktemp("lrr"))
    f = root / "perfbench" / "configs" / "lrr-8shard-3m.json"
    c = json.loads(f.read_text())
    c["preload_keys"] = LEVEL_KEYS
    f.write_text(json.dumps(c))
    out = {}
    for cell in (CELL, GLORAN):
        windows, clients = [], []

        def keep(*a, **kw):
            windows.append(window(*a, **kw))
            return windows[-1]

        window = harness._window
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(harness, "_window", keep)
            res = run_cell(cell, 2147531007, 2.0, True,
                           t_start=time.perf_counter(), device="cpu",
                           bench=load_bench(root), root=root,
                           log=lambda m: None, clients=clients)
        out[cell] = (res, windows[0], clients[0])
    return out


def test_the_new_cell_is_correct_and_reads_its_four_metrics(runs):
    res, _, client = runs[CELL]
    assert res["correct"] and res["failed"] == 0
    assert all(any(len(b) for b in sh.tree.level_rts)
               for sh in client.eng.shards)
    for name in NEW:
        assert res["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_the_lrr_window_and_not_the_gloran_one(runs, name):
    read = reader(name)
    assert read(runs[CELL][1]) > 0
    assert runs[GLORAN][0]["correct"]
    assert read(runs[GLORAN][1]) is None


def hand_window(names: tuple, rt_reads: int) -> Window:
    """One get batch and one write batch on one thread, each with its
    plan and one shard step, and the spans ``names`` inside the steps."""
    def sp(name, t0, t1, batch):
        return {"name": name, "t0": t0, "t1": t1, "tid": 1,
                "attrs": {"batch": batch}}
    spans = [sp("plan.compile", 0.1, 0.2, 1), sp("shard.get", 0.2, 0.9, 1),
             sp("plan.compile", 1.1, 1.2, 2),
             sp("shard.range_delete", 1.2, 1.9, 2)]
    inner = {"lsm.rt_mem": (0.3, 0.4), "lsm.rt_probe": (0.5, 0.55),
             "lsm.rt_insert": (1.3, 1.5)}
    spans += [sp(n, *inner[n], None) for n in names]
    io = {"io": {"by_tag": {"rt_block": rt_reads}}}
    return Window(seconds=2.0, requests=[("get", 0.0, 1.0, 100),
                                         ("write", 1.0, 2.0, 10)],
                  spans=spans, stats0={"io": {"by_tag": {}}}, stats1=io,
                  device_ops=None, kind="cpu")


def test_before_any_level_holds_a_tombstone_block_the_levels_read_zero():
    w = hand_window(("lsm.rt_mem", "lsm.rt_insert"), 0)
    assert reader("lsm.rt_levels_ms")(w) == 0.0
    assert reader("lsm.rt_reads_per_get")(w) == 0.0
    assert reader("lsm.rt_mem_ms")(w) == pytest.approx(100.0)
    w = hand_window(("lsm.rt_mem", "lsm.rt_probe", "lsm.rt_insert"), 250)
    assert reader("lsm.rt_levels_ms")(w) == pytest.approx(50.0)
    assert reader("lsm.rt_insert_ms")(w) == pytest.approx(200.0)
    assert reader("lsm.rt_reads_per_get")(w) == pytest.approx(2.5)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    assert reader(name)(hand_window((), 250)) is None
