"""Unified namespaced metrics: counters + gauges under one flat schema.

The engine's observability surface had grown one ad-hoc ledger per
subsystem — ``KernelCounters``, the registry's ``upload_bytes``, block
-cache hit rates, staging-buffer occupancy — each with its own snapshot
shape.  ``MetricsRegistry`` absorbs them all under dot-namespaced keys
(``kernels.cascade_calls``, ``cache.hit_rate``, ``staging.occupancy``)
into ONE flat, sorted, JSON-serializable dict, so dashboards and tests
consume a single stable schema regardless of which subsystem a number
came from.
"""

from __future__ import annotations

import threading

_SCALARS = (bool, int, float, str)


class MetricsRegistry:
    """Thread-safe flat registry of namespaced counters and gauges."""

    def __init__(self):
        self._vals: dict[str, float | int | str | bool] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int | float = 1) -> None:
        """Add ``n`` to counter ``name`` (created at 0)."""
        with self._lock:
            self._vals[name] = self._vals.get(name, 0) + n

    def set(self, name: str, value) -> None:
        """Set gauge ``name`` to ``value`` (last write wins)."""
        with self._lock:
            self._vals[name] = value

    def get(self, name: str, default=0):
        with self._lock:
            return self._vals.get(name, default)

    def absorb(self, prefix: str, mapping: dict) -> None:
        """Fold a subsystem snapshot in under ``prefix.``.

        Nested dicts recurse (``a.b.c``); scalar leaves are kept, and
        non-scalar leaves (lists, arrays, per-shard breakdowns) are
        skipped — the flat schema carries rollups, the source snapshot
        keeps the structure.
        """
        flat = {}
        _flatten(prefix, mapping, flat)
        with self._lock:
            self._vals.update(flat)

    def snapshot(self) -> dict:
        """Key-sorted flat dict; every value is JSON-serializable."""
        with self._lock:
            return {k: self._vals[k] for k in sorted(self._vals)}

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()


def _flatten(prefix: str, mapping: dict, out: dict) -> None:
    for k, v in mapping.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten(key, v, out)
        elif isinstance(v, _SCALARS):
            out[key] = v
        elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[key] = v.item()  # numpy scalar
