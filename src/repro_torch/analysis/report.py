"""Dry-run and roofline tables from results/*.json (a port of
``repro.analysis.report``); the result files of either package's
dry-run read alike.

    PYTHONPATH=src python -m repro_torch.analysis.report results/ > tables.md

"fits 80G" is one H100's memory.  With ``--trace trace.json`` (a Chrome
trace exported by ``repro_torch.obs.Tracer.export_chrome``) a §Trace
section is appended:
per-batch critical path, per-shard busy/stall (and each shard's share
of the pipeline's total stall — the modeled-vs-wall gap), and kernel
launches per lookup.
"""

from __future__ import annotations

import json
import os
import sys

from ..configs import ARCHS, SHAPES
from ..launch.mesh import HBM_BYTES


def load(results_dir: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            with open(os.path.join(results_dir, name)) as f:
                out.append(json.load(f))
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | compile | bytes/device (arg+tmp) | "
           "fits 80G | HLO GFLOPs/dev | collective bytes | collectives |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        mem = r.get("memory_per_device", {})
        tot = mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)
        colls = " ".join(f"{k.split('-')[0][:3]}+{k.split('-')[1][:4]}:"
                         f"{fmt_b(v)}" if "-" in k else f"{k}:{fmt_b(v)}"
                         for k, v in sorted(r["coll_by_op"].items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']}s | {fmt_b(tot)} | "
            f"{'Y' if tot < HBM_BYTES else '**N**'} | "
            f"{r['hlo_flops'] / 1e9:.1f} | {fmt_b(r['coll_bytes'])} | "
            f"{colls} |")
    return "\n".join(out)


def roofline_table(rows: list[dict]) -> str:
    out = ["| arch | shape | t_compute | t_memory | t_collective | "
           "bottleneck | roofline frac | useful FLOPs ratio | "
           "what would move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != "single":
            continue  # roofline table is single-pod per the brief
        hint = _hint(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"{r['bottleneck']} | {r['roofline_fraction']:.3f} | "
            f"{r['useful_flops_ratio']:.2f} | {hint} |")
    return "\n".join(out)


def _hint(r: dict) -> str:
    b = r["bottleneck"]
    if b == "memory":
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            return ("decode is weight+cache-streaming bound: batch more "
                    "queries per weight read, or quantize KV")
        return ("reduce rematerialized bytes: coarser remat policy, fused "
                "loss, smaller logits footprint")
    if b == "collective":
        top = max(r["coll_by_op"], key=r["coll_by_op"].get) \
            if r["coll_by_op"] else "all-reduce"
        return (f"dominant {top}: reshard to cut it (e.g. reduce-scatter "
                "grads, keep activations sharded through the stack)")
    return "compute-bound: at the roofline; only kernel-level wins remain"


def trace_report(events: list[dict]) -> dict:
    """Distill a Chrome trace (``Tracer.chrome_events`` output, or the
    JSON file's ``traceEvents`` list) into the pipeline's span-level
    story:

    - ``batches``: per submitted batch, the execution window across its
      shard plans and the critical-path shard (the slowest ``shard.plan``
      span — the one the collect actually waited on).
    - ``shards``: per shard, total busy vs stall microseconds and
      ``stall_share`` — this shard's fraction of the pipeline's total
      idle time, i.e. who owns the modeled-vs-wall gap.
    - ``wall_us`` (submit->collect extent), ``modeled_us`` (busiest
      shard's total busy time = the perfect-overlap lower bound) and
      ``gap_us`` = wall - modeled.
    - ``kernel_launches`` / ``launches_per_lookup``: fused-cascade
      efficiency — how many device launches each point lookup cost.
    """
    xs = [e for e in events if e.get("ph") == "X"]
    plans = [e for e in xs if e["name"] == "shard.plan"]
    by_batch: dict[int, list[dict]] = {}
    for e in plans:
        by_batch.setdefault(e.get("args", {}).get("batch", -1),
                            []).append(e)
    batches = []
    busy: dict[int, float] = {}
    stall: dict[int, float] = {}
    for b, evs in sorted(by_batch.items()):
        w0 = min(e["ts"] for e in evs)
        w1 = max(e["ts"] + e["dur"] for e in evs)
        crit = max(evs, key=lambda e: e["dur"])
        for e in evs:
            s = e["args"]["shard"]
            busy[s] = busy.get(s, 0.0) + e["dur"]
            stall[s] = stall.get(s, 0.0) + (w1 - w0) - e["dur"]
        batches.append({"batch": b, "window_us": w1 - w0,
                        "critical_shard": crit["args"]["shard"],
                        "critical_us": crit["dur"],
                        "n_shards": len(evs)})
    outer = [e for e in xs
             if e["name"] in ("engine.submit", "engine.collect")] or plans
    wall = (max(e["ts"] + e["dur"] for e in outer)
            - min(e["ts"] for e in outer)) if outer else 0.0
    modeled = max(busy.values()) if busy else 0.0
    tot_stall = sum(stall.values())
    shards = {s: {"busy_us": busy[s], "stall_us": stall[s],
                  "stall_share": stall[s] / tot_stall if tot_stall else 0.0}
              for s in sorted(busy)}
    launches = sum(1 for e in xs if e["name"].startswith("kernel."))
    lookups = sum(e.get("args", {}).get("n", 0)
                  for e in xs if e["name"] == "shard.get")
    return {"batches": batches, "shards": shards, "wall_us": wall,
            "modeled_us": modeled, "gap_us": max(0.0, wall - modeled),
            "kernel_launches": launches, "lookups": lookups,
            "launches_per_lookup": launches / lookups if lookups else 0.0}


def trace_tables(rep: dict) -> str:
    out = [f"Wall {rep['wall_us']:.0f}us, perfect-overlap bound "
           f"{rep['modeled_us']:.0f}us, gap {rep['gap_us']:.0f}us; "
           f"{rep['kernel_launches']} kernel launches / "
           f"{rep['lookups']} lookups = "
           f"{rep['launches_per_lookup']:.4f} launches/lookup.", "",
           "| shard | busy | stall | stall share of gap |",
           "|---|---|---|---|"]
    for s, r in rep["shards"].items():
        out.append(f"| {s} | {fmt_s(r['busy_us'] * 1e-6)} | "
                   f"{fmt_s(r['stall_us'] * 1e-6)} | "
                   f"{r['stall_share']:.1%} |")
    out += ["", "| batch | window | critical shard | critical path | "
            "shards |", "|---|---|---|---|---|"]
    for b in rep["batches"][:20]:
        out.append(f"| {b['batch']} | {fmt_s(b['window_us'] * 1e-6)} | "
                   f"{b['critical_shard']} | "
                   f"{fmt_s(b['critical_us'] * 1e-6)} | {b['n_shards']} |")
    if len(rep["batches"]) > 20:
        out.append(f"| ... {len(rep['batches']) - 20} more batches |  |  "
                   "|  |  |")
    return "\n".join(out)


def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def main():
    argv = list(sys.argv[1:])
    trace_path = None
    if "--trace" in argv:
        i = argv.index("--trace")
        trace_path = argv[i + 1]
        del argv[i:i + 2]
    results_dir = argv[0] if argv else "results"
    if trace_path is not None:
        print("## §Trace (spans from submit to kernel launch)\n")
        print(trace_tables(trace_report(load_trace(trace_path))))
        if not os.path.isdir(results_dir):
            return
        print()
    rows = load(results_dir)
    key = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    ordered = [key[k] for k in sorted(key)]
    print("## §Dry-run (all cells, both meshes)\n")
    print(dryrun_table(ordered))
    skips = [(a, s) for a in ARCHS for s in SHAPES
             if (a, s, "single") not in key]
    print("\nSkipped cells (full attention x long_500k): "
          + ", ".join(f"{a}/{s}" for a, s in skips))
    print("\n## §Roofline (single-pod 16x16 = 256 chips)\n")
    print(roofline_table(ordered))


if __name__ == "__main__":
    main()
