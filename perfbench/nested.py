"""Spans inside spans, as three per-layer readers group them.

The program's tracer records no parent ids: a span lies inside another
when both ran on the same thread and its interval lies within the
other's, which ``Window.self_seconds`` already measures.  ``per_batch``
sums, for each batch of one request kind, the spans of one name that
lie inside the batch's step spans (one a shard: ``shard.get``,
``shard.range_delete``), over the batch's shards.  A cell whose engine
runs the shards' plans in turn on one thread (pipeline off) waits for
that sum.
"""

from __future__ import annotations


def inside_seconds(w, parent: dict, name: str) -> float:
    """Seconds of the spans ``name`` that lie inside the span ``parent``
    on its thread."""
    return (parent["t1"] - parent["t0"]) - w.self_seconds(parent, name)


def per_batch(w, step: str, kind: str, name: str) -> list:
    """For each batch of request kind ``kind`` that has spans ``step``,
    the seconds of the spans ``name`` inside them, summed over them; []
    where the window holds no span ``name`` (a program without it)."""
    if not w.named(name):
        return []
    by_batch: dict = {}
    for s in w.of_kind(step, kind):
        b = s["attrs"].get("batch")
        by_batch[b] = by_batch.get(b, 0.0) + inside_seconds(w, s, name)
    return list(by_batch.values())
