"""The traced window (``--trace 1``): the program's spans, the inputs of
each lookup-cascade launch, and the device's operations.

Spans come from the program's own ``repro_torch.obs`` tracer, installed
for the window with room for every span.  The cascade's launches are
recorded at ``repro_torch.kernels.cascade.ops.cascade_lookup``, wherever
the program's modules bind it: each launch's query keys and the packed
state it hands the kernel, whose Bloom filters and level sizes
``roofline.cascade_bytes`` counts the launch's bytes from after the
window.
The device's operations (kernels, copies, memsets) come from
``torch.profiler`` on the card, moved onto ``time.perf_counter``'s clock
by a pair of clock readings taken together.
"""

from __future__ import annotations

import time

import numpy as np

MAX_EVENTS = 8_000_000  # spans a window may record before dropping


class Trace:
    """Start before the window, ``stop`` after it."""

    def __init__(self, device: str):
        self.device = device
        self.launches: list = []   # (query keys, pack key) per launch
        self._packs: dict = {}
        self.tracer = None
        self._prof = None
        self._undo = []

    def start(self) -> None:
        import sys
        from repro_torch import obs
        from repro_torch.kernels.cascade import ops
        self.tracer = obs.Tracer(max_events=MAX_EVENTS)
        prev = obs.get_tracer()
        obs.set_tracer(self.tracer)
        self._undo.append(lambda: obs.set_tracer(prev))

        orig = ops.cascade_lookup
        launches, packs = self.launches, self._packs

        def cascade_lookup(qkey32, qhash32, qseq32, qres, state):
            # The pack's filter columns, held (not copied) until the
            # window has closed; keyed by the words tensor, whose id
            # cannot be reused while it is held.
            packs.setdefault(id(state.words), (
                state.words, state.word_off, state.mbits, state.seeds,
                state.key_cnt, state.gl_cnt))
            launches.append((np.array(qkey32, np.uint64), id(state.words)))
            return orig(qkey32, qhash32, qseq32, qres, state)

        for mod in [m for n, m in list(sys.modules.items())
                    if n == "repro_torch" or n.startswith("repro_torch.")]:
            names = [k for k, v in vars(mod).items() if v is orig]
            for k in names:
                setattr(mod, k, cascade_lookup)
                self._undo.append(
                    lambda mod=mod, k=k: setattr(mod, k, orig))

        if self.device != "cpu":
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
            # One reading of both clocks: the profiler's timestamps are
            # on the wall clock, the spans on perf_counter.
            self._clocks = (time.time_ns(), time.perf_counter())

    def stop(self) -> None:
        if self._prof is not None:
            import torch
            torch.cuda.synchronize()
            self._prof.stop()
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    # ------------------------------------------------------------ views
    def cascade_launches(self) -> list:
        """(keys, blooms, key_cnt, gl_cnt) of each cascade launch, as
        ``roofline.cascade_bytes`` takes them, from the pack it read."""
        host = {}
        for k, (words, woff, mbits, seeds, kcnt, gcnt) in \
                self._packs.items():
            u32 = [t.cpu().numpy().view(np.uint32)
                   for t in (words, mbits, seeds)]
            woff, kcnt, gcnt = (t.cpu().numpy().astype(np.int64)
                                for t in (woff, kcnt, gcnt))
            words, mbits, seeds = u32
            blooms = [(words[o:o + -(-int(m) // 32)], int(m), seeds[i])
                      for i, (o, m) in enumerate(zip(woff, mbits))]
            host[k] = (blooms, kcnt.tolist(), gcnt.tolist())
        return [(keys, *host[k]) for keys, k in self.launches]

    def spans(self) -> list:
        return self.tracer.events()

    def device_ops(self) -> list | None:
        """(name, start, end) of every device operation the profiler
        recorded, on perf_counter's clock; None without a card."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType
        wall0, perf0 = self._clocks
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = perf0 + (e.start_ns() - wall0) * 1e-9
            out.append((e.name(), s, s + e.duration_ns() * 1e-9))
        out.sort(key=lambda x: x[1])
        return out


def busy_seconds(ops: list, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some device operation ran (the
    union of their intervals, not their sum)."""
    busy, end = 0.0, t0
    for _, s, e in sorted(ops, key=lambda x: x[1]):
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return busy


def short_name(name: str) -> str:
    """A device op's name without its argument list."""
    name = name.split("(", 1)[0]
    return name[5:] if name.startswith("void ") else name


def device_breakdown(ops: list, t0: float, t1: float, top: int = 10):
    """The device operations that took most time, by name."""
    tot: dict = {}
    for n, s, e in ops:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            k = short_name(n)
            tot[k] = tot.get(k, 0.0) + (e - s)
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda x: -x[1])[:top]


def idle_breakdown(ops: list, spans: list, requests: list, t0: float,
                   t1: float, top: int = 10, bin_s: float = 50e-6):
    """Idle device time by what the host was doing: each idle gap goes
    to the innermost program span open at its middle on any thread (the
    one that started last), else to the client's request kind, else to
    the harness between requests."""
    nb = int(np.ceil((t1 - t0) / bin_s)) + 1
    names = ["harness"]
    label = np.zeros(nb, np.int32)
    index = {"harness": 0}

    def paint(a, b, name):
        i = index.setdefault(name, len(names))
        if i == len(names):
            names.append(name)
        lo = max(int((a - t0) / bin_s), 0)
        hi = min(int((b - t0) / bin_s) + 1, nb)
        if hi > lo:
            label[lo:hi] = i

    for kind, a, b, _ in requests:
        paint(a, b, f"request.{kind}")
    for s in sorted(spans, key=lambda s: s["t0"]):
        paint(s["t0"], s["t1"], s["name"])
    idle: dict = {}
    end = t0
    for _, s, e in sorted(ops, key=lambda x: x[1]) + [("", t1, t1)]:
        s = min(s, t1)
        if s > end:
            mid = int(((end + s) / 2 - t0) / bin_s)
            k = names[label[min(max(mid, 0), nb - 1)]]
            idle[k] = idle.get(k, 0.0) + (s - end)
        end = max(end, min(e, t1))
    return sorted(([k, v] for k, v in idle.items()),
                  key=lambda x: -x[1])[:top]
