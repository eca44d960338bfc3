"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the cell names its configuration (whose entry names
its file) and its traffic mix (``perfbench/traffic/<traffic>.json``);
its end-to-end metrics are computed here from the harness's own timing
of every request, and each per-layer metric is read by
``perfbench/layers/<metric>.py``.  Adding a cell, a mix or a metric
takes new files and new entries only.

The window is a closed loop: one client keeps one request outstanding,
timed on ``time.perf_counter`` around ``Engine.submit`` and the wait for
its answer.  Requests follow the mix's rounds until ``seconds`` have
passed; the request in flight then completes and closes the window.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from .reference import StreamModel, compare_gets, compare_scans
from .roofline import cascade_bytes
from .trace import Trace, busy_seconds, device_breakdown, idle_breakdown
from .traffic import Request, Traffic
from .window import Window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_P_MS = re.compile(r"^(get|write|scan)_p(\d+)_ms$")


# --------------------------------------------------------------- specs
def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, cell: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration and mix, and the metrics it
    reports, all found by name."""
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / HERE.name / "traffic" /
                      f"{work['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics
                if cell in m.get("workloads", [cell])]

    return {"workload": work, "config": config, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(name: str, root: Path = ROOT):
    """The ``read(window)`` function of per-layer metric ``name``."""
    path = root / HERE.name / "layers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_layer_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------- store
def with_fields(obj, fields: dict):
    """The dataclass ``obj`` with ``fields`` set; a nested dict sets the
    fields of the nested dataclass it names."""
    kw = {k: with_fields(getattr(obj, k), v)
          if isinstance(v, dict) and dataclasses.is_dataclass(
              getattr(obj, k)) else v
          for k, v in fields.items()}
    return dataclasses.replace(obj, **kw)


def build_engine(config: dict, device: str, wal_dir: str | None):
    """The configuration's engine, as its file states it: its
    ``strategy``, ``lsm`` and ``engine`` fields, and a ``gloran`` block
    (``GloranConfig``'s fields) where the file has one."""
    from repro_torch.core import GloranConfig
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.lsm import LSMConfig
    durable = config["durability"]
    extra = {"wal_dir": wal_dir, "fsync": durable["fsync"]} \
        if durable["wal"] else {}
    gloran = config.get("gloran")
    return Engine(
        num_shards=int(config["num_shards"]), strategy=config["strategy"],
        lsm_config=LSMConfig(**config["lsm"]),
        gloran_config=None if gloran is None
        else with_fields(GloranConfig(), gloran),
        config=EngineConfig(device=device, **config["engine"], **extra))


def op_batch(req: Request):
    """The request as one ``OpBatch``: a get batch; puts, then range
    deletes; or inserts, then scans."""
    from repro_torch.engine import OpBatch
    if req.kind == "get":
        return OpBatch.gets(req.keys)
    ranges = zip(req.lo.tolist(), req.hi.tolist())
    return OpBatch.concat([
        OpBatch.puts(req.put_keys, req.put_vals),
        OpBatch.range_scans(ranges) if req.kind == "scan"
        else OpBatch.range_deletes(ranges)])


class Client:
    """The closed-loop client: serves requests and logs what the check
    needs (writes into the reference's log as they are acknowledged,
    every read's answer with its read point)."""

    def __init__(self, eng):
        self.eng = eng
        self.model = StreamModel()
        self.gets: list = []
        self.scans: list = []

    def write(self, keys, vals, lo, hi) -> None:
        """An untimed write batch (the preload and the tail)."""
        self.serve(Request("write", -1, put_keys=keys, put_vals=vals,
                           lo=lo, hi=hi))

    def serve(self, req: Request, batch=None) -> tuple[float, float]:
        """Serve one request; returns the perf_counter readings at its
        submit and at its answer."""
        batch = op_batch(req) if batch is None else batch
        # A scan batch's inserts precede its scans.
        at = self.model.pos + (len(req.put_keys) if req.kind == "scan"
                               else 0)
        t0 = time.perf_counter()
        pending = self.eng.submit(batch)
        if req.kind == "get":
            found, vals = pending.get_results()
        elif req.kind == "scan":
            res = pending.scan_results()
        else:
            pending.wait()
        t1 = time.perf_counter()
        if req.kind == "get":
            self.gets.append((req.keys, at, found, vals))
        elif req.kind == "scan":
            self.model.write(req.put_keys, req.put_vals, [], [])
            self.scans.append((req.lo, req.hi, at, res))
        else:
            self.model.write(req.put_keys, req.put_vals, req.lo, req.hi)
        return t0, t1


def preload(client: Client, traffic: Traffic, config: dict) -> int:
    """The preloaded stream, then the tail: with ``tail_max_batches``
    above 0, batches of range deletes until every shard's GLORAN index
    holds DR-tree levels and each has areas (bottom-compaction GC can
    leave them empty after the load); returns the tail batches."""
    rl = np.uint64(traffic.range_len)
    for k, v, lo in traffic.preload():
        client.write(k, v, lo, lo + rl)
    most = int(config.get("tail_max_batches", 0))
    if not most:
        return 0
    if any(sh.tree.gloran is None for sh in client.eng.shards):
        raise ValueError("a tail waits for GLORAN levels; this store has "
                         "no GLORAN index (set tail_max_batches to 0)")
    none = np.zeros(0, np.uint64)
    t = 0
    while not all(views and all(len(v) for v in views)
                  for views in (sh.tree.gloran.level_views()
                                for sh in client.eng.shards)):
        if t >= most:
            raise RuntimeError(f"no GLORAN level after {t} tail batches")
        lo = traffic.tail_lo(t)
        client.write(none, none, lo, lo + rl)
        t += 1
    return t


# -------------------------------------------------------------- metrics
def end_to_end(name: str, requests: list, window_s: float,
               setup_s: float) -> float:
    """An end-to-end metric from the harness's timing of every request
    of the window: (kind, t0, t1, ops) each."""
    if name == "setup_s":
        return setup_s
    if name == "ops_per_s":
        return sum(r[3] for r in requests) / window_s
    m = _P_MS.match(name)
    if m is None:
        raise KeyError(f"no end-to-end metric {name!r}")
    kind, q = m.group(1), int(m.group(2))
    lat = [1e3 * (r[2] - r[1]) for r in requests if r[0] == kind]
    if not lat:
        raise RuntimeError(f"{name}: no {kind} request in the window")
    return float(np.percentile(lat, q))


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's or
    the JAX package's."""
    import sys
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & banned)


# ------------------------------------------------------------------ run
def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", bench: dict | None = None,
             root: Path = ROOT, before_window=None,
             clients: list | None = None, log=print) -> dict:
    """One run; returns the result line's object.  ``before_window
    (engine)`` runs after set-up (tests break the program with it);
    ``clients`` receives the client with everything it logged (the
    control replays it)."""
    import torch
    bench = bench or load_bench(root)
    spec = cell_spec(bench, cell, root)
    config = spec["config"]
    traffic = Traffic(config, spec["mix"], seed)
    cuda = device != "cpu"
    if cuda:
        from repro_torch.kernels import native
        native.build_all()
        torch.cuda.reset_peak_memory_stats()
    wal_dir = (tempfile.mkdtemp(prefix="perfbench-wal-")
               if config["durability"]["wal"] else None)
    eng = None
    try:
        eng = build_engine(config, device, wal_dir)
        client = Client(eng)
        tail = preload(client, traffic, config)
        warmup = traffic.warmup()
        for req in warmup:
            client.serve(req)
        eng.drain()
        if cuda:
            torch.cuda.synchronize()
        log(f"set-up: {len(traffic.preload_lo)} preload batches, {tail} "
            f"tail batches, {len(warmup)} warm-up requests, "
            f"{time.perf_counter() - t_start:.3f} s")
        if before_window is not None:
            before_window(eng)
        # The set-up's objects stay out of the collector's window scans.
        gc.collect()
        gc.freeze()
        tr = stats0 = None
        if trace:
            stats0 = eng.stats()
            tr = Trace(device)
            tr.start()
        requests, failed, error = [], 0, None
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        deadline = w0 + seconds
        i = 0
        while True:
            req = traffic.request(i)
            batch = op_batch(req)
            try:
                t0, t1 = client.serve(req, batch)
            except Exception as exc:  # a failed request ends the run
                failed, error = 1, repr(exc)
                t0 = t1 = time.perf_counter()
            requests.append((req.kind, t0, t1, req.ops))
            i += 1
            if failed or t1 >= deadline:
                break
        if cuda:
            torch.cuda.synchronize()
        w1 = time.perf_counter()
        window_s = w1 - w0
        window = None
        if trace:
            tr.stop()
            window = _window(tr, eng, stats0, requests, w0, w1, window_s,
                             device, log)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        if eng is not None:
            eng.close()
        if wal_dir:
            shutil.rmtree(wal_dir, ignore_errors=True)
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if clients is not None:
        clients.append(client)
    # The check, once the program's state is freed.
    t_ref = time.perf_counter()
    wrong_g, n_g = compare_gets(client.model, client.gets)
    wrong_s, n_s = compare_scans(client.model, client.scans)
    checks = {}
    if n_g:
        checks["wrong_get_answers"] = {"value": wrong_g, "limit": 0}
    if n_s:
        checks["wrong_scans"] = {"value": wrong_s, "limit": 0}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    log(f"window: {len(requests)} requests in {window_s:.3f} s; checked "
        f"{n_g} get answers and {n_s} scans in "
        f"{time.perf_counter() - t_ref:.3f} s" +
        (f"; failed: {error}" if error else ""))

    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"], root)(window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], requests,
                                                   window_s, setup_s),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]} if not failed else {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(requests), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and window.device_ops is not None:
        dev["busy_s"] = window.busy_s
        dev["window_s"] = window_s
        out["breakdown"] = {
            "device_ops": device_breakdown(window.device_ops, w0, w1),
            "idle_gaps": idle_breakdown(window.device_ops, window.spans,
                                        requests, w0, w1)}
    out["checks"] = checks
    return out


def _window(tr, eng, stats0, requests, w0, w1, window_s, device,
            log) -> Window:
    """The traced window as the per-layer readers see it."""
    import torch
    ops = tr.device_ops()
    if tr.tracer.dropped:
        raise RuntimeError(f"the tracer dropped {tr.tracer.dropped} spans")
    launches = tr.cascade_launches()
    log(f"trace: {len(tr.tracer.events())} spans (0 dropped), "
        f"{len(launches)} cascade launches recorded, "
        f"{'no' if ops is None else len(ops)} device operations")
    return Window(
        seconds=window_s, requests=requests, spans=tr.spans(),
        stats0=stats0, stats1=eng.stats(), device_ops=ops,
        kind=torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
        cascade_bytes=[cascade_bytes(*l) for l in launches],
        busy_s=None if ops is None else busy_seconds(ops, w0, w1))
