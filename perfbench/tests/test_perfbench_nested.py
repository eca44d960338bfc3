"""The readers of the spans inside the store's host path and of GLORAN's
counters (``perfbench/nested.py`` and five ``perfbench/layers/``
files), on hand-built windows: what each reads, what it leaves out (a
span on another thread or outside its step, another batch's kind), and
that a window of a program without those spans or counters reads
nothing and raises nothing."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from perfbench.harness import load_bench, reader, run_cell
from perfbench.nested import inside_seconds, per_batch
from perfbench.window import Window

ROOT = Path(__file__).resolve().parents[2]
NEW = ("lsm.get_levels_ms", "gloran.validity_ms", "gloran.eve_fpr_pct",
       "kernel.cascade_submit_us", "gloran.index_insert_ms")


def span(name, t0, t1, tid=1, **attrs):
    return {"name": name, "t0": t0, "t1": t1, "tid": tid, "attrs": attrs}


def window(spans, stats0=None, stats1=None) -> Window:
    """Three requests (get, write, get), one plan each (batches 1-3),
    and ``spans`` beside their ``plan.compile`` spans."""
    requests = [("get", 0.0, 1.0, 100), ("write", 1.0, 2.0, 50),
                ("get", 2.0, 3.0, 100)]
    plans = [span("plan.compile", t, t + 0.005, batch=b)
             for b, t in ((1, 0.01), (2, 1.01), (3, 2.01))]
    return Window(seconds=3.0, requests=requests, spans=plans + spans,
                  stats0=stats0 or {}, stats1=stats1 or {},
                  device_ops=None, kind="cpu")


def get_batches(child: str) -> list:
    """Two get batches of two shards each (one thread), with ``child``
    spans inside, on another thread, outside any step, and inside the
    write batch's step."""
    return [
        span("shard.get", 0.1, 0.3, shard=0, batch=1),
        span(child, 0.15, 0.20),
        span("shard.get", 0.3, 0.5, shard=1, batch=1),
        span(child, 0.35, 0.37),
        span(child, 0.15, 0.25, tid=2),        # another thread
        span(child, 0.6, 0.7),                 # outside any step
        span("shard.get", 2.1, 2.2, shard=0, batch=3),
        span(child, 2.12, 2.14),
        span("shard.range_delete", 1.1, 1.2, shard=0, batch=2),
        span(child, 1.12, 1.13),               # a write batch's
    ]


@pytest.mark.parametrize("metric,child", [
    ("lsm.get_levels_ms", "lsm.get_levels"),
    ("gloran.validity_ms", "gloran.validity")])
def test_get_path_readers_sum_the_shards_of_each_get_batch(metric, child):
    # Batch 1: 50 + 20 ms over its two shards; batch 3: 20 ms.
    assert reader(metric)(window(get_batches(child))) == \
        pytest.approx((70 + 20) / 2)


def test_index_insert_reads_the_write_batches_range_delete_steps():
    w = window([
        span("shard.range_delete", 1.1, 1.3, shard=0, batch=2),
        span("gloran.index_insert", 1.11, 1.15),
        span("gloran.index_flush", 1.12, 1.14),
        span("shard.range_delete", 1.3, 1.4, shard=1, batch=2),
        span("gloran.index_insert", 1.31, 1.32),
        span("shard.get", 0.1, 0.3, shard=0, batch=1),
        span("gloran.index_insert", 0.2, 0.25),  # not a write batch's
    ])
    assert reader("gloran.index_insert_ms")(w) == pytest.approx(50.0)


def test_cascade_submit_reads_upload_and_launch_per_launch():
    launches = []
    for t, up, launch in ((0.1, 30e-6, 20e-6), (0.2, 10e-6, 20e-6)):
        launches += [span("kernel.cascade", t, t + 1e-3),
                     span("cascade.upload", t + 1e-6, t + 1e-6 + up),
                     span("cascade.launch", t + 2e-4, t + 2e-4 + launch),
                     span("cascade.copy_back", t + 3e-4, t + 9e-4)]
    assert reader("kernel.cascade_submit_us")(window(launches)) == \
        pytest.approx((50 + 30) / 2)


def counters(probes, maybe, dead):
    return {"gloran": {"lookup_probes": probes, "eve_maybe": maybe,
                       "deleted": dead}}


def test_eve_false_positives_over_the_window():
    w = window([], counters(100, 30, 10), counters(1100, 130, 60))
    # 1000 probes, 100 maybes, 50 deleted: 50 of 950 valid entries.
    assert reader("gloran.eve_fpr_pct")(w) == pytest.approx(100 * 50 / 950)
    assert reader("gloran.eve_fpr_pct")(
        window([], counters(5, 2, 1), counters(5, 2, 1))) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_spans_or_counters_reads_nothing(metric):
    """The parent program: its get and write batches carry only their
    step spans and ``kernel.cascade``, and ``engine.stats()`` has no
    ``gloran`` counters."""
    w = window([span("shard.get", 0.1, 0.3, shard=0, batch=1),
                span("kernel.cascade", 0.12, 0.2),
                span("shard.range_delete", 1.1, 1.2, shard=0, batch=2)],
               {"io": {"reads": 1}}, {"io": {"reads": 9}})
    assert reader(metric)(w) is None


def test_inside_seconds_and_per_batch_by_hand():
    w = window(get_batches("lsm.get_levels"))
    step = w.named("shard.get")[0]
    assert inside_seconds(w, step, "lsm.get_levels") == pytest.approx(0.05)
    assert inside_seconds(w, step, "no.such_span") == 0.0
    assert sorted(per_batch(w, "shard.get", "get", "lsm.get_levels")) == \
        pytest.approx([0.02, 0.07])
    assert per_batch(w, "shard.get", "get", "no.such_span") == []


def test_the_new_metrics_are_entered_for_the_gets_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert (ROOT / "perfbench" / "layers" / f"{name}.py").exists()
        assert by_name[name]["workloads"] == ["gloran-8shard-3m.lookup90-rd1"]


# The harness tests' tiny CPU cells of gets: a shard's sub-batch of a
# tiny get batch (128 keys) is under ``kernel_min_batch``, so no cascade
# runs there, and the ``lrr`` store has no GLORAN index.
TINY_GETS = {
    "gloran-8shard-3m.lookup90-rd1": {"lsm.get_levels_ms",
                                      "gloran.validity_ms",
                                      "gloran.eve_fpr_pct",
                                      "gloran.index_insert_ms"},
    "test-wal.lookup90-rd1": {"lsm.get_levels_ms", "gloran.validity_ms",
                              "gloran.eve_fpr_pct",
                              "gloran.index_insert_ms"},
    "test-lrr.lookup90-rd1": {"lsm.get_levels_ms"},
}


@pytest.mark.parametrize("cell", sorted(TINY_GETS))
def test_a_traced_tiny_cell_reads_each_new_metric_it_has_a_source_for(
        tiny_root, cell):
    out = run_cell(cell, 7, 2.0, True, t_start=time.perf_counter(),
                   device="cpu", bench=load_bench(tiny_root),
                   root=tiny_root, log=lambda m: None)
    assert out["correct"]
    assert set(out["metrics"]) & set(NEW) == TINY_GETS[cell]
    times = TINY_GETS[cell] - {"gloran.eve_fpr_pct"}
    assert all(out["metrics"][m]["value"] > 0 for m in times)
