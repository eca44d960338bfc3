"""The reader of ``gloran.view_fold_us``: on a hand-built window, the
folds it reads and those it leaves out; in a tiny traced CPU cell with
range deletes, that it reads."""

from __future__ import annotations

import time

import pytest

from perfbench.harness import load_bench, reader, run_cell
from perfbench.window import Window


def span(name, t0, t1, tid=1, **attrs):
    return {"name": name, "t0": t0, "t1": t1, "tid": tid, "attrs": attrs}


def window(spans) -> Window:
    """Three requests (get, write, get), one plan each (batches 1-3),
    and ``spans`` beside their ``plan.compile`` spans."""
    requests = [("get", 0.0, 1.0, 100), ("write", 1.0, 2.0, 50),
                ("get", 2.0, 3.0, 100)]
    plans = [span("plan.compile", t, t + 0.005, batch=b)
             for b, t in ((1, 0.01), (2, 1.01), (3, 2.01))]
    return Window(seconds=3.0, requests=requests, spans=plans + spans,
                  stats0={}, stats1={}, device_ops=None, kind="cpu")


def fold(t0, us, tid=1):
    return span("gloran.view_fold", t0, t0 + us * 1e-6, tid=tid, n=819,
                view=4096, merged=6)


def test_view_fold_reads_the_mean_fold_span_under_the_lookups():
    """The folds inside ``gloran.index_probe`` on their thread, not those
    under a flush or on another thread; nothing where the program opens
    no such span."""
    w = window([
        span("shard.get", 0.1, 0.3, shard=0, batch=1),
        span("gloran.index_probe", 0.14, 0.2),
        fold(0.15, 400),
        span("gloran.index_probe", 0.14, 0.2, tid=2),
        fold(0.15, 700, tid=3),                     # another thread
        span("shard.get", 2.1, 2.3, shard=0, batch=3),
        span("gloran.index_probe", 2.12, 2.2),
        fold(2.13, 200),
        span("gloran.index_probe", 2.21, 2.22),
        fold(2.215, 10_000),                        # ends past the probe
        span("shard.range_delete", 1.1, 1.2, shard=0, batch=2),
        span("gloran.index_flush", 1.11, 1.15),
        fold(1.12, 900),                            # a flush's
    ])
    assert reader("gloran.view_fold_us")(w) == pytest.approx(300.0)
    assert reader("gloran.view_fold_us")(window([
        span("shard.get", 0.1, 0.3, shard=0, batch=1),
        span("gloran.index_probe", 0.14, 0.2),
    ])) is None


def test_a_traced_tiny_cell_with_range_deletes_reads_the_view_fold(
        tiny_root):
    out = run_cell("gloran-8shard-3m.lookup90-rd1", 2147483659, 2.0, True,
                   t_start=time.perf_counter(), device="cpu",
                   bench=load_bench(tiny_root), root=tiny_root,
                   log=lambda m: None)
    assert out["correct"]
    assert out["metrics"]["gloran.view_fold_us"]["value"] > 0
    assert out["metrics"]["gloran.view_fold_us"]["unit"] == "us"
