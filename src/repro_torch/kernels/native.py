"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, the
hash being that of the source and the shared headers, so an edited
source builds anew and an
unchanged one loads the library it built before.  Every C entry point
takes raw device pointers plus the CUDA stream and returns
``cudaGetLastError()`` after its launch; ``check`` raises on anything
but 0.  Nothing here runs at import: the first wrapper that launches a
kernel builds its library.

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("cascade", "merge_rank", "bloom", "interval")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return str(path)


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    running process (or None) and the library path."""
    src, lib = _target(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def _finish_build(name: str, proc, lib: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)  # atomic: a reader never sees half a library


def build_all() -> None:
    """Compile every kernel source at once (one nvcc per source, all
    started together) and load the libraries."""
    with _lock:
        todo = [name for name in KERNELS if name not in _libs]
        started = [(name, *_start_build(name)) for name in todo]
        for name, proc, lib in started:
            _finish_build(name, proc, lib)
            _libs[name] = ctypes.CDLL(str(lib))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            proc, path = _start_build(name)
            _finish_build(name, proc, path)
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {err}")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """Device pointer of a contiguous tensor (NULL for None)."""
    if t is None:
        return ctypes.c_void_p(0)
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Check that every operand is a contiguous 32-bit tensor on one
    CUDA device; return that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"{name}: 32-bit operands expected, "
                            f"got {t.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {dev}")
    return dev
