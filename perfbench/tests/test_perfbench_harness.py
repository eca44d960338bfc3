"""The harness on the CPU: its generator, its metric and byte
arithmetic, how it finds a cell's files by name, a tiny cell through the
port's plain kernel versions, the control, and broken programs that the
check must catch."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from perfbench import roofline
from perfbench.harness import end_to_end, load_bench, run_cell
from perfbench.traffic import Traffic, round_shares
from conftest import TEST_CELLS, TEST_MIXES

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# The benchmark's cells, and the test cells the tiny root adds.
CELLS = [w["name"] for w in BENCH["workloads"]] + sorted(TEST_CELLS)
MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json")
               ) + sorted(TEST_MIXES)
SECONDS = 2.0


def tiny_run(root, cell, seed=7, trace=False, **kw) -> dict:
    return run_cell(cell, seed, SECONDS, trace, t_start=time.perf_counter(),
                    device="cpu", bench=load_bench(root), root=root,
                    log=lambda m: None, **kw)


def spec(mix: str):
    config = json.loads((ROOT / "perfbench" / "configs" /
                         "gloran-8shard-3m.json").read_text())
    config["preload_keys"] = 50_000
    m = TEST_MIXES.get(mix) or json.loads(
        (ROOT / "perfbench" / "traffic" / f"{mix}.json").read_text())
    return config, m


def bench_of(root) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


# ------------------------------------------------------------ generator
@pytest.mark.parametrize("mix", MIXES)
def test_generator_repeats_for_a_seed_and_differs_across_seeds(mix):
    config, m = spec(mix)
    a, b, c = (Traffic(config, m, s) for s in (2**31 + 11, 2**31 + 11, 5))
    assert (a.keys == b.keys).all() and not (a.keys == c.keys).all()
    for i in (0, 1, 17, 250):
        ra, rb, rc = a.request(i), b.request(i), c.request(i)
        assert ra.kind == rb.kind
        for col in ("keys", "put_keys", "put_vals", "lo", "hi"):
            x, y = getattr(ra, col), getattr(rb, col)
            assert (x is None and y is None) or (x == y).all()
        cols = [getattr(r, "keys") if r.kind == "get" else r.lo
                for r in (ra, rc)]
        if ra.kind == rc.kind and len(cols[0]):
            assert not np.array_equal(*cols)


@pytest.mark.parametrize("mix", MIXES)
def test_every_round_holds_the_mix_shares(mix):
    config, m = spec(mix)
    t = Traffic(config, m, 3)
    n = len(t.round)
    want = round_shares(m)
    for r in range(3):
        got: dict = {}
        for i in range(r * n, (r + 1) * n):
            q = t.request(i)
            if q.kind == "get":
                parts = {"get": len(q.keys)}
            elif q.kind == "write":
                parts = {"put": len(q.put_keys), "range_delete": len(q.lo)}
            else:
                parts = {"scan": len(q.lo), "put": len(q.put_keys)}
            for k, v in parts.items():
                got[k] = got.get(k, 0) + v
        assert {k: v for k, v in got.items() if v} == \
            {k: v for k, v in want.items() if v}


def test_the_mixes_shares_are_the_papers():
    shares = {}
    for mix in MIXES:
        s = round_shares(spec(mix)[1])
        tot = sum(s.values())
        shares[mix] = {k: round(100 * v / tot) for k, v in s.items() if v}
    assert shares["lookup90-rd1"] == {"get": 90, "put": 9,
                                      "range_delete": 1}


def test_scans_are_zipfian_and_short():
    config, m = spec("test-scans")
    m = json.loads(json.dumps(m))
    m["round"][0]["scans"] = 1946
    t = Traffic(config, m, 9)
    r = next(t.request(i) for i in range(40) if t.request(i).kind == "scan")
    width = config["key_universe"] / config["preload_keys"]
    span = (r.hi - r.lo).astype(np.float64)
    assert span.min() >= width and span.max() <= np.ceil(100 * width)
    assert np.isin(r.lo, t.keys).all()
    _, counts = np.unique(r.lo, return_counts=True)
    assert counts.max() > 20  # the hottest start recurs


# -------------------------------------------------------------- metrics
def test_p95_and_ops_per_s_take_every_request_and_the_whole_window():
    reqs = [("get", 0.0, 0.001 * (i + 1), 8192) for i in range(100)]
    reqs += [("write", 0.0, 1.0, 100), ("write", 0.0, 2.0, 50)]
    assert end_to_end("get_p95_ms", reqs, 10.0, 1.0) == \
        pytest.approx(np.percentile(np.arange(1, 101), 95))
    assert end_to_end("write_p95_ms", reqs, 10.0, 1.0) == \
        pytest.approx(1950.0)
    assert end_to_end("ops_per_s", reqs, 10.0, 1.0) == \
        pytest.approx((100 * 8192 + 150) / 10.0)
    assert end_to_end("setup_s", reqs, 10.0, 3.5) == 3.5


def test_roofline_bytes_on_hand_worked_inputs():
    assert roofline.search_sectors(1024, 1) == 8
    assert roofline.search_sectors(1000, 4) == 24
    keys = np.arange(4, dtype=np.uint64)
    seeds = np.array([1, 2, 3], np.uint32)
    ones = (np.full(2, 0xFFFFFFFF, np.uint32), 64, seeds)
    zeros = (np.zeros(2, np.uint32), 64, seeds)
    # Every probe reads all 3 words (12), or stops at the first (4);
    # one level of 1000 keys: min(24 + 4, 126) sectors; no GLORAN level.
    assert roofline.cascade_bytes(keys, [ones], [1000], []) == \
        16 * 4 + 16 * 4 + 32 * (12 + 28)
    assert roofline.cascade_bytes(keys, [zeros], [1000], []) == \
        16 * 4 + 16 * 4 + 32 * (4 + 28)
    # A GLORAN level of 64 areas adds min(8, 9) + 3 * 4 sectors.
    assert roofline.cascade_bytes(keys, [zeros], [1000], [64]) == \
        16 * 4 + 16 * 4 + 32 * (4 + 28 + 8 + 12)


def test_hashes_match_the_filters_they_stand_for():
    from repro_torch.core.eve import fold64to32, mix32
    x = np.random.default_rng(0).integers(0, 2**63, 1000, dtype=np.uint64)
    assert (roofline.fold64to32(x) == fold64to32(x)).all()
    h = roofline.fold64to32(x)
    assert (roofline.mix32(h, 77) == mix32(h, 77)).all()



def test_the_trace_records_each_cascade_launch_from_the_pack_it_read():
    from perfbench.harness import Client, build_engine, preload
    from perfbench.trace import Trace
    config, mix = spec("lookup90-rd1")
    config.update(preload_keys=65_536, num_shards=2)
    traffic = Traffic(config, mix, 5)
    eng = build_engine(config, "cpu", None)
    try:
        client = Client(eng)
        preload(client, traffic, config)
        eng.drain()
        calls0 = eng.stats()["kernels"]["cascade_calls"]
        tr = Trace("cpu")
        tr.start()
        for i in range(3):
            req = traffic.request(i)
            if req.kind == "get":
                client.serve(req)
        tr.stop()
        launches = tr.cascade_launches()
        assert len(launches) == \
            eng.stats()["kernels"]["cascade_calls"] - calls0 > 0
        by_count = {}
        for sh in eng.shards:
            lv = [l for l in sh.tree.levels if l is not None and len(l)]
            by_count[tuple(len(l) for l in lv)] = (
                [l.bloom.words for l in lv],
                [len(g.areas) for g in sh.tree.gloran.level_views()])
        for keys, blooms, key_cnt, gl_cnt in launches:
            words, areas = by_count[tuple(key_cnt)]
            assert all((b[0] == w).all() for b, w in zip(blooms, words))
            assert gl_cnt == areas and len(keys) >= 256
            assert roofline.cascade_bytes(keys, blooms, key_cnt, gl_cnt) > 0
    finally:
        eng.close()


def test_the_cascade_roofline_refuses_launches_it_did_not_record():
    from perfbench.harness import reader
    from perfbench.window import Window
    read = reader("cascade_sm90_roofline")
    kind = "NVIDIA H100 80GB HBM3"
    op = ("void cascade_sm90_kernel<8>(int)", 1.0, 1.0 + 1e-5)
    w = Window(seconds=1.0, requests=[], spans=[], stats0={}, stats1={},
               device_ops=[op], kind=kind)
    with pytest.raises(RuntimeError, match="1 launches on the device, 0"):
        read(w)
    w.cascade_bytes = [3.35e6 * 5]  # 5 us at the memory rate
    assert read(w) == pytest.approx(50.0)
    w.device_ops = []
    assert read(w) is None


# ----------------------------------------------------- cells on the CPU
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_runs_and_is_correct(tiny_root, cell):
    out = tiny_run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in bench_of(tiny_root)["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_cell_reads_its_span_metrics(tiny_root, cell):
    out = tiny_run(tiny_root, cell, trace=True)
    assert out["correct"]
    device = {"cascade_sm90_roofline", "device.idle_pct"}
    want = {m["name"] for m in bench_of(tiny_root)["per_layer"]
            if cell in m.get("workloads", [cell])} - device
    assert set(out["metrics"]) == want
    # No device trace on the CPU: those readers return nothing.
    assert "device.idle_pct" not in out["metrics"]
    assert "cascade_sm90_roofline" not in out["metrics"]


def test_a_new_cell_mix_and_metric_are_found_by_name(tiny_root):
    pb = tiny_root / "perfbench"
    c = json.loads((pb / "configs" / "gloran-8shard-3m.json").read_text())
    c["num_shards"] = 4
    (pb / "configs" / "gloran-4shard.json").write_text(json.dumps(c))
    (pb / "traffic" / "gets-only.json").write_text(json.dumps({
        "round": [{"kind": "get", "count": 1, "keys": 512,
                   "present_share": 0.9}]}))
    (pb / "layers" / "test.gets_seen.py").write_text(
        "def read(w):\n    return w.ops('get')\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "gloran-4shard",
                             "file": "perfbench/configs/gloran-4shard.json"})
    cell = "gloran-4shard.gets-only"
    bench["workloads"].append({"name": cell, "config": "gloran-4shard",
                               "traffic": "gets-only", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append(cell)
    bench["per_layer"].append({"name": "test.gets_seen", "unit": "keys",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "get_p95_ms",
                               "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny_run(tiny_root, cell)
    assert out["correct"] and "get_p95_ms" in out["metrics"]
    traced = tiny_run(tiny_root, cell, trace=True)
    assert traced["metrics"]["test.gets_seen"]["value"] > 0


def test_a_config_of_another_strategy_runs_from_its_file_alone(tmp_path):
    """RocksDB's range tombstones (``lrr``), the paper's baseline: a new
    configuration file with its own strategy and no GLORAN block or
    tail, and a new entry, run with no other edit."""
    from conftest import make_tiny_root
    root = make_tiny_root(tmp_path)
    pb = root / "perfbench"
    c = json.loads((pb / "configs" / "gloran-8shard-3m.json").read_text())
    c.update(name="lrr-8shard", strategy="lrr", tail_max_batches=0)
    del c["gloran"]
    (pb / "configs" / "lrr-8shard.json").write_text(json.dumps(c))
    bench = bench_of(root)
    bench["configs"].append({**bench["configs"][0], "name": "lrr-8shard",
                             "file": "perfbench/configs/lrr-8shard.json"})
    cell = "lrr-8shard.lookup90-rd1"
    bench["workloads"].append({"name": cell, "config": "lrr-8shard",
                               "traffic": "lookup90-rd1", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    clients: list = []
    out = tiny_run(root, cell, clients=clients)
    assert out["correct"] and out["attempted"] > 0
    eng_strategy = {sh.tree.strategy for sh in clients[0].eng.shards}
    assert eng_strategy == {"lrr"}
    assert all(sh.tree.gloran is None for sh in clients[0].eng.shards)


def test_a_tail_without_a_gloran_index_is_refused(tmp_path):
    from conftest import make_tiny_root
    root = make_tiny_root(tmp_path)
    f = root / "perfbench" / "configs" / "test-lrr.json"
    c = json.loads(f.read_text())
    c["tail_max_batches"] = 5
    f.write_text(json.dumps(c))
    with pytest.raises(ValueError, match="no GLORAN index"):
        tiny_run(root, "test-lrr.lookup90-rd1")


def test_the_command_without_a_card_exits_and_prints_nothing():
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_the_command_without_the_program_exits(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_run_loads_nothing_of_jax_or_the_jax_package(tiny_root):
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench.harness import run_cell, load_bench, jax_modules\n"
        "import perfbench.reference\n"
        f"root = __import__('pathlib').Path({str(tiny_root)!r})\n"
        f"out = run_cell({CELLS[0]!r}, 1, 0.5, False, "
        "t_start=time.perf_counter(), device='cpu', "
        "bench=load_bench(root), root=root, log=lambda m: None)\n"
        "print(json.dumps([out['correct'], jax_modules(), "
        "sorted({m.split('.')[0] for m in sys.modules})]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, check=True)
    correct, banned, mods = json.loads(r.stdout.strip().splitlines()[-1])
    assert correct and banned == []
    assert "repro_torch" in mods
    assert not {"jax", "jaxlib", "flax", "repro"} & set(mods)


# ------------------------------------------------- the control and faults
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(tiny_root, cell):
    from perfbench.control import control_checks
    clients: list = []
    out = tiny_run(tiny_root, cell, clients=clients)
    assert out["correct"]
    control = control_checks(clients[0])
    assert control and all(v > 0 for v in control.values()), control


def _unchanged(eng):
    """Write steps acknowledged but leaving the state unchanged."""
    for sh in eng.shards:
        sh.put_batch = lambda keys, vals: None
        sh.range_delete_arrays = lambda los, his: None


def _half(eng):
    """Half of each read batch left out: the second half of every get
    sub-batch not found, of every scan sub-batch empty."""
    for sh in eng.shards:
        get, scan = sh.get_batch, sh.range_scan_batch

        def get_half(keys, get=get):
            found, vals = get(keys)
            found[len(keys) // 2:] = False
            return found, vals

        def scan_half(ranges, scan=scan):
            res = scan(ranges)
            e = np.zeros(0, np.uint64)
            return res[:len(res) // 2] + [(e, e)] * (len(res) - len(res) // 2)

        sh.get_batch, sh.range_scan_batch = get_half, scan_half


def _exchange(eng):
    """The merge-back across shards left out: only shard 0's answers
    reach the client."""
    for sh in eng.shards[1:]:
        get, scan = sh.get_batch, sh.range_scan_batch
        e = np.zeros(0, np.uint64)
        sh.get_batch = lambda keys, get=get: (
            np.zeros(len(keys), bool), get(keys)[1])
        sh.range_scan_batch = lambda ranges, scan=scan: [
            (e, e) for _ in scan(ranges)]


def _altered(eng):
    """One answer altered where it is produced: a found value on shard
    0, or the last value of its first non-empty scan."""
    sh = eng.shards[0]
    get, scan = sh.get_batch, sh.range_scan_batch

    def get_altered(keys):
        found, vals = get(keys)
        hit = np.flatnonzero(found)
        if len(hit):
            vals = vals.copy()
            vals[hit[0]] += np.uint64(1)
        return found, vals

    def scan_altered(ranges):
        res = scan(ranges)
        for i, (k, v) in enumerate(res):
            if len(v):
                v = v.copy()
                v[-1] += np.uint64(1)
                res[i] = (k, v)
                break
        return res

    sh.get_batch, sh.range_scan_batch = get_altered, scan_altered


FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half,
          "merge_back_left_out": _exchange, "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tiny_root, cell, fault):
    out = tiny_run(tiny_root, cell, before_window=FAULTS[fault])
    assert not out["correct"], out["checks"]


# --------------------------------------------------------------- card
@pytest.mark.card
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
