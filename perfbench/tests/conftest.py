"""Tests of the benchmark (``python -m pytest perfbench/tests``).

Registers ``card``, the marker of tests that need a CUDA card: such a
test decides inside itself whether there is one and skips with a reason
on a machine without.  ``tiny_root`` builds a copy of the benchmark's
data files (``BENCHMARK.json``, configurations, mixes, readers) with
small stores and batches, so a cell runs its loop on the CPU in
seconds, and adds the test cells (``TEST_CELLS``) as new files.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_KEYS = 16_384
# Batch sizes of the tiny mixes: the real ones over this, so that a
# two-second window on the CPU holds whole rounds.
SHRINK = 8


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without")


def shrink_mix(mix: dict) -> dict:
    """The mix with every batch smaller, its rounds kept."""
    mix = json.loads(json.dumps(mix))
    by = SHRINK
    for e in mix["round"]:
        for f in ("keys", "puts", "range_deletes", "scans"):
            if e.get(f):
                e[f] = max(1, e[f] // by)
    return mix


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


# Cells the tests add as new files beside the benchmark's own, at the
# tiny size: another strategy, a write-ahead log, and a scan mix.  They
# show that such cells need data files only, and drive the harness's
# paths that the benchmark's cell does not.
TEST_CONFIGS = {
    "test-lrr": {"strategy": "lrr", "gloran": None, "tail_max_batches": 0},
    "test-wal": {"durability": {"wal": True, "fsync": "batch"}},
}
TEST_MIXES = {
    "test-scans": {"round": [
        {"kind": "scan", "count": 1, "scans": 24, "inserts": 2,
         "zipf_theta": 0.99, "records": [1, 100]},
        {"kind": "write", "count": 1, "puts": 64, "range_deletes": 2,
         "range_len": 128}]},
}
TEST_CELLS = {
    "test-lrr.lookup90-rd1": ("test-lrr", "lookup90-rd1"),
    "test-wal.lookup90-rd1": ("test-wal", "lookup90-rd1"),
    "gloran-8shard-3m.test-scans": ("gloran-8shard-3m", "test-scans"),
}


def add_test_cells(root: Path, base: str = "gloran-8shard-3m") -> None:
    """Write the test cells' configurations and mixes as new files under
    ``root`` and enter them in its ``BENCHMARK.json``: a cell of gets
    joins the metrics of the benchmark's gets."""
    pb = root / "perfbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == base)
    for name, edit in TEST_CONFIGS.items():
        c = json.loads((root / conf["file"]).read_text())
        c.update(edit)
        if c.get("gloran") is None:
            c.pop("gloran", None)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(c))
        bench["configs"].append({**conf, "name": name,
                                 "file": f"perfbench/configs/{name}.json"})
    for name, mix in TEST_MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    gets = [w["name"] for w in bench["workloads"] if w["traffic"] ==
            "lookup90-rd1"][0]
    for cell, (config, traffic) in TEST_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a test cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if traffic == "lookup90-rd1" and gets in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def make_tiny_root(tmp_path: Path) -> Path:
    """A root holding the benchmark's data files at a tiny size, and the
    test cells."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench" / "layers", pb / "layers")
    for sub in ("configs", "traffic"):
        (pb / sub).mkdir(parents=True)
    for f in (ROOT / "perfbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["preload_keys"] = TINY_KEYS
        (pb / "configs" / f.name).write_text(json.dumps(c))
    for f in (ROOT / "perfbench" / "traffic").glob("*.json"):
        (pb / "traffic" / f.name).write_text(
            json.dumps(shrink_mix(json.loads(f.read_text()))))
    add_test_cells(tmp_path)
    return tmp_path
