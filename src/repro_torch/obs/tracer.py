"""Low-overhead tracing: spans on ``time.perf_counter``, Chrome export.

The engine's request path is instrumented with ``obs.span(name, **attrs)``
context managers — submit, plan compilation, per-shard plan execution,
kernel dispatch, registry uploads, flush/compaction.  A process-global
tracer decides what those calls cost:

  NullTracer   the default: ``span()`` returns a shared no-op context
               manager, no lock, no allocation beyond the (empty) kwargs
               dict — the instrumented path stays within noise of an
               uninstrumented one (gated in ``scripts/check.sh``),
  Tracer       records (name, begin, end, thread) per span, thread-safe,
               bounded (drops past ``max_events``), exportable as Chrome
               trace-event JSON that loads directly in Perfetto / about:
               //tracing, with one named track per thread — the shard
               worker pools are named ``shard-N``, so per-shard timelines
               come out of the box.

Enable globally with env ``REPRO_TRACE=1`` (read once at import), or per
scope with ``set_tracer(Tracer())`` / the ``enabled()`` context manager.
Span names are dot-namespaced (``engine.submit``, ``shard.plan``,
``kernel.cascade``); the prefix becomes the Chrome event category.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op context manager (the zero-cost off switch)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracer that records nothing; every call is O(1) and lock-free."""

    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def events(self) -> list:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """One open span; records on ``__exit__`` (begin/end always pair)."""

    __slots__ = ("tracer", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter()

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer._record(self.name, self.t0, time.perf_counter(),
                            self.attrs)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only before the span closes."""
        self.attrs.update(attrs)


class Tracer:
    """Thread-safe span recorder on the monotonic ``perf_counter`` clock.

    Every span is stored as a completed ``(name, t0, t1, tid, thread
    name, attrs)`` tuple — begin/end pair by construction, timestamps are
    monotonic and shared across threads (one clock).  Memory is bounded:
    past ``max_events`` spans, new ones are counted in ``dropped`` and
    discarded (the trace stays loadable, never OOMs a long run).
    """

    enabled = True

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: list[tuple] = []
        # Spans absorbed from other processes (shard workers): same
        # tuple shape prefixed with (pid, process name).  perf_counter
        # is CLOCK_MONOTONIC system-wide on Linux, so foreign
        # timestamps land on this tracer's clock directly.
        self._foreign: list[tuple] = []
        self._lock = threading.Lock()
        self._base = time.perf_counter()

    # ----------------------------------------------------------- record
    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def _record(self, name: str, t0: float, t1: float,
                attrs: dict) -> None:
        th = threading.current_thread()
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append((name, t0, t1, th.ident, th.name, attrs))

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._foreign.clear()
            self.dropped = 0
            self._base = time.perf_counter()

    # --------------------------------------------- cross-process merge
    def drain(self) -> list[list]:
        """Return + clear the recorded spans as JSON-able rows — the
        shipping format a shard worker sends home with each reply.  The
        epoch is kept, so successive drains stay on one timeline."""
        with self._lock:
            snap, self._events = self._events, []
        return [[n, t0, t1, tid, tname, attrs]
                for n, t0, t1, tid, tname, attrs in snap]

    def absorb(self, rows: list, *, pid: int,
               process_name: str | None = None) -> None:
        """Merge spans drained in another process into this trace,
        keyed under that process's pid so the Chrome export renders one
        named track group per worker."""
        with self._lock:
            for r in rows:
                if (len(self._events) + len(self._foreign)
                        >= self.max_events):
                    self.dropped += 1
                    continue
                self._foreign.append((int(pid), process_name, r[0],
                                      float(r[1]), float(r[2]),
                                      int(r[3]), r[4], r[5] or {}))

    # ------------------------------------------------------------ views
    def events(self) -> list[dict]:
        """Completed spans as dicts (seconds on the tracer's clock)."""
        with self._lock:
            snap = list(self._events)
        return [{"name": n, "t0": t0, "t1": t1, "tid": tid,
                 "thread": tname, "attrs": attrs}
                for n, t0, t1, tid, tname, attrs in snap]

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event list: complete ('X') events in microseconds
        relative to the tracer epoch, plus thread/process name metadata
        so Perfetto labels each shard worker's track."""
        with self._lock:
            snap = list(self._events)
            foreign = list(self._foreign)
            base = self._base
        out = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "repro-engine"}}]
        seen: dict[tuple, str] = {}

        def emit(pid, name, t0, t1, tid, tname, attrs):
            if (pid, tid) not in seen:
                seen[(pid, tid)] = tname
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": tname}})
            ev = {"name": name, "cat": name.split(".", 1)[0], "ph": "X",
                  "pid": pid, "tid": tid,
                  "ts": round((t0 - base) * 1e6, 3),
                  "dur": round((t1 - t0) * 1e6, 3)}
            if attrs:
                ev["args"] = attrs
            out.append(ev)

        for name, t0, t1, tid, tname, attrs in snap:
            emit(1, name, t0, t1, tid, tname, attrs)
        pids_named: set[int] = set()
        for pid, pname, name, t0, t1, tid, tname, attrs in foreign:
            if pid not in pids_named:
                pids_named.add(pid)
                out.append({"name": "process_name", "ph": "M",
                            "pid": pid, "tid": 0,
                            "args": {"name": pname or f"pid {pid}"}})
            emit(pid, name, t0, t1, tid, tname, attrs)
        return out

    def export_chrome(self, path: str) -> dict:
        """Write the Chrome/Perfetto trace JSON; returns the document."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "otherData": {"clock": "perf_counter",
                             "dropped_events": self.dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


# ------------------------------------------------------- global dispatch
def _from_env() -> NullTracer | Tracer:
    return Tracer() if os.environ.get("REPRO_TRACE", "0") not in \
        ("0", "", "off") else NULL_TRACER


_TRACER = _from_env()


def get_tracer():
    """The process-global tracer all instrumented call sites use."""
    return _TRACER


def set_tracer(tracer) -> None:
    """Install ``tracer`` globally (``NULL_TRACER`` to disable)."""
    global _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER


def span(name: str, **attrs):
    """Open a span on the global tracer (a no-op when tracing is off).

    Hot call sites pass at most a couple of scalar attrs; anything
    costly to compute should be guarded with ``tracing_enabled()``.
    """
    return _TRACER.span(name, **attrs)


def tracing_enabled() -> bool:
    return _TRACER.enabled


class enabled:
    """Scope with a fresh recording ``Tracer`` installed globally.

        with obs.enabled() as tr:
            engine.get_batch(keys)
        tr.export_chrome("trace.json")
    """

    def __init__(self, tracer: Tracer | None = None):
        self.tracer = tracer or Tracer()
        self._prev = None

    def __enter__(self) -> Tracer:
        self._prev = get_tracer()
        set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, *exc) -> bool:
        set_tracer(self._prev)
        return False
