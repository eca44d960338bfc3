"""The port stands alone and fails loudly.

``repro_torch`` imports neither ``jax`` nor the JAX package, asking for
CUDA where there is none raises instead of falling back to the CPU,
the options not ported yet raise, and a kernel that cannot be built
raises.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels import native
from repro_torch.kernels.bloom import bloom_probe
from repro_torch.kernels.u32 import to_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    .replace(".__init__", "").rstrip(".")
    for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m.rstrip('.'))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
            "             m.startswith(('jax.', 'jaxlib')) or m == 'repro'\n"
            "             or m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert len(MODULES) > 30


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_cuda_device_without_cuda_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineConfig(device="cuda")
    with pytest.raises(RuntimeError):
        EngineConfig()  # the default device is the card


@pytest.mark.parametrize("option,value", (
    ("wal_dir", "/nonexistent"), ("procs", 2), ("scheduler", True),
    ("tombstone_trigger", 0.5)))
def test_deferred_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(device="cpu", **{option: value})


def test_range_scans_raise():
    eng = Engine(2, config=EngineConfig(device="cpu"))
    eng.put_batch(np.arange(10, dtype=np.uint64), np.arange(10,
                                                            dtype=np.uint64))
    for call in (lambda: eng.range_scan_batch([(0, 5)]),
                 lambda: eng.range_scan(0, 5),
                 lambda: eng.execute([("range_scan", 0, 5)])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    assert eng.execute([("get", 3), ("put", 3, 9), ("get", 3)]) == [3, None,
                                                                     9]
    eng.close()


def test_kernel_wrapper_refuses_cpu_operands_and_missing_nvcc(monkeypatch):
    keys = to_device(np.arange(8), "cpu")
    words = to_device(np.full(4, 0xFFFFFFFF), "cpu")
    # A CPU tensor takes the plain version...
    assert bloom_probe(keys, words, m_bits=128, seeds=[1, 2]).all()
    # ...and nothing launches a kernel on one.
    with pytest.raises(ValueError, match="CUDA tensors"):
        native.require_cuda("bloom", keys, words)
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.library("bloom")
