"""The port stands alone and fails loudly.

``repro_torch`` imports neither ``jax`` nor the JAX package (nor does
the code a spawned shard worker runs), asking for CUDA where there is
none raises instead of falling back to the CPU, and a kernel that
cannot be built raises.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.engine import EngineConfig
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


# ------------------------------------------- what a shard worker imports
WORKER_MODULES = ("repro_torch.engine.procpool", "repro_torch.engine",
                  "repro_torch.device", "repro_torch.lsm",
                  "repro_torch.lsm.scheduler", "repro_torch.durable.wal",
                  "repro_torch.durable.manifest",
                  "repro_torch.durable.recovery", "repro_torch.obs.tracer",
                  "repro_torch.kernels.native")


def test_worker_modules_load_neither_jax_nor_repro():
    """The procpool module and everything its spawned worker imports
    (``_WorkerHost`` imports the tree, scheduler, WAL, manifest, replay
    and tracer lazily) stand alone."""
    code = ("import importlib, sys\n"
            f"for m in {WORKER_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "repro_torch.engine.procpool" in MODULES


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
        native.library("bloom_sm90")


# ------------------------------------------------ the model stack's slice
SLICE_MODULES = ("repro_torch.configs", "repro_torch.models",
                 "repro_torch.models.moe",
                 "repro_torch.kernels.ssd", "repro_torch.kernels.flash_attention",
                 "repro_torch.runtime", "repro_torch.launch.serve",
                 "repro_torch.carry", "repro_torch.baselines",
                 "repro_torch.baselines.workload", "repro_torch.data",
                 "repro_torch.data.versioned_store", "repro_torch.optim",
                 "repro_torch.ckpt", "repro_torch.launch.steps",
                 "repro_torch.launch.train", "repro_torch.runtime.train_loop",
                 "repro_torch.runtime.straggler",
                 "repro_torch.data.pipeline",
                 # the mesh slice
                 "repro_torch.models.sharding", "repro_torch.launch.mesh",
                 "repro_torch.optim.grad_compress",
                 "repro_torch.kernels.sharded", "repro_torch.launch.dryrun",
                 "repro_torch.analysis", "repro_torch.analysis.roofline",
                 "repro_torch.analysis.report")


def test_model_stack_modules_load_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "assert 'repro_torch.models.model' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def _imports_neither_jax_nor_repro(path: Path) -> None:
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                       for n in names), names


def test_chip_smoke_imports_neither_jax_nor_repro():
    _imports_neither_jax_nor_repro(ROOT / "chip_smoke.py")


def test_kill_writer_imports_neither_jax_nor_repro():
    """The child process of the CPU SIGKILL check (chip_smoke's own
    ``--kill-child`` writer is the script above)."""
    _imports_neither_jax_nor_repro(ROOT / "tests" / "torch_kill_cells.py")


def _model_kernel_operands():
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    x = torch.zeros(1, 16, 2, 8)
    dt = torch.zeros(1, 16, 2)
    bc = torch.zeros(1, 16, 4)
    q = torch.zeros(1, 16, 2, 8)
    return ((lambda: ssd_ops._launch(x, dt, dt, bc, bc, 16)),
            (lambda: flash_ops._launch(q, q, q, None, True, None)))


@pytest.mark.parametrize("which", ["ssd", "flash_attention"])
def test_model_kernels_refuse_cpu_launch(which):
    """The launch path never runs on CPU tensors (no silent fallback):
    the wrapper sends a CPU tensor to the plain version before it."""
    launch = dict(zip(("ssd", "flash_attention"),
                      _model_kernel_operands()))[which]
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch()


def test_float_operand_check():
    f = torch.zeros(4)
    with pytest.raises(TypeError, match="expected"):
        native.require_cuda("ssd", f.to(torch.float64),
                            dtypes=native.FLOATS)
    with pytest.raises(TypeError, match="expected"):
        native.require_cuda("bloom", f)  # the int kernels take no floats
    with pytest.raises(ValueError, match="contiguous"):
        native.require_cuda("ssd", torch.zeros(4, 4).t(),
                            dtypes=native.FLOATS)
    assert {"ssd", "flash_attention"} <= set(native.KERNELS)
    assert {"ssd", "flash_attention"} <= set(native.LAUNCHES)


def test_model_kernels_build_from_csrc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    monkeypatch.setattr(native, "_libs", {})
    for name in ("ssd", "flash_attention"):
        assert (native.CSRC / f"{name}.cu").exists()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            native.library(name)


def test_model_and_cli_want_the_card():
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.runtime import SessionRegistry
    cfg = smoke(get_config("zamba2-7b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg)  # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SessionRegistry()
    # The full-width model is never built: the device check comes first.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "zamba2-7b"])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_model_and_cli_want_the_card(arch):
    """The MoE stacks build on the CPU only when asked; the default is
    the card, and neither the model nor the CLI falls back without one."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    cfg = smoke(get_config(arch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg)
    assert "moe" in Transformer(cfg, device="cpu").params["layers"][0]
    # The full config (46.7 B / 1 T parameters) is never built: the
    # device check comes first.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", arch])


def test_train_cli_wants_the_card_and_trains_on_the_cpu(tmp_path):
    """``launch.train`` raises without a card unless ``--device cpu`` is
    given (before building anything), and trains there."""
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "zamba2-7b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "zamba2-7b"])  # full width: never built
    res = train.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--global-batch", "2", "--seq", "32",
                      "--ckpt-dir", str(tmp_path)])
    assert res.final_step == 2 and len(res.losses) == 2
    assert all(np.isfinite(res.losses))
    assert (tmp_path / "step_00000002" / "arrays.npz").exists()


def test_full_width_train_state_outgrows_one_card():
    """zamba2-7b's 6.75 B parameters with their gradients and AdamW
    moments need about 81 GB: more than one 80 GB card holds."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_state_bytes
    need = train_state_bytes(get_config("zamba2-7b"))
    assert 80e9 < need < 82e9


def test_a_spawned_rank_loads_neither_jax_nor_repro():
    """A gloo rank that imports every ``repro_torch`` module and runs a
    sharded matmul holds no JAX module (``run_world`` checks each
    rank's ``sys.modules``)."""
    import torch_mesh_cells as cells
    assert cells.run_world(cells.import_program, world=2,
                           timeout=120)["sum"] == 8.0


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "zamba2-7b"])
def test_full_size_model_builds_on_meta_only(arch):
    """``device="meta"`` builds a full-size model with no memory (the
    dry-run's); the engine's devices still take cuda or cpu only."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import Transformer, count_params, param_specs
    cfg = get_config(arch)
    model = Transformer(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == \
        count_params(param_specs(cfg))
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
