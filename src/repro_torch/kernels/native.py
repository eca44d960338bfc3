"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, the
hash being that of the source and the shared headers, so an edited
source builds anew and an
unchanged one loads the library it built before.  Every C entry point
takes raw device pointers plus the CUDA stream and returns
``cudaGetLastError()`` after its launch; ``check`` raises on anything
but 0.  ``SIGNATURES`` declares each entry point's parameters once;
``library`` applies them when it loads a library, and ``entry`` hands a
wrapper the declared function.  Nothing here runs at import: the first
wrapper that launches a kernel builds its library.

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.  ``plain_vjp`` is the
backward of the model kernels' autograd Functions.
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
KERNELS = ("merge_rank", "ssd", "flash_attention", "ssd_sm90",
           "flash_attention_sm90", "cascade_sm90", "merge_path_sm90",
           "bloom_sm90", "interval_sm90")
INTS = (torch.int32, torch.uint32)
FLOATS = (torch.float32, torch.bfloat16)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
# The parameters of every C entry point, by library and entry name, in
# the order of its ``extern "C"`` declaration: pointers (the stream
# last), ints, u32 and floats.  Every entry point returns int.
SIGNATURES = {
    "merge_rank": {
        # n, q, m, run, leq, out, stream
        "merge_rank_launch": (_I, _P, _I, _P, _I, _P, _P)},
    "ssd": {
        # x, dac, dt, B, C, y, states; batch, S, H, P, N, Q, bf16; stream
        "ssd_chunks_launch": (_P,) * 7 + (_I,) * 7 + (_P,)},
    "flash_attention": {
        # q, k, v, o; B, Sq, Skv, Hq, Hkv, D; scale; causal, has_window,
        # window, bf16; stream
        "flash_attention_launch":
            (_P,) * 4 + (_I,) * 6 + (_F,) + (_I,) * 4 + (_P,)},
    "ssd_sm90": {
        # as ssd_chunks_launch, strict in place of bf16
        "ssd_sm90_launch": (_P,) * 7 + (_I,) * 7 + (_P,),
        "ssd_sm90_floor_launch": (_I,) * 6 + (_P,)},
    "flash_attention_sm90": {
        # as flash_attention_launch, without bf16
        "flash_attention_sm90_launch":
            (_P,) * 4 + (_I,) * 6 + (_F,) + (_I,) * 3 + (_P,),
        "flash_attention_sm90_floor_launch": (_I,) * 4 + (_P,)},
    "cascade_sm90": {
        # n; qkey, qhash, qseq, qres, lkeys, lseqs, key_off, key_cnt,
        # words, word_off, mbits, seeds; L, H; glo_lo, glo_hi, glo_smin,
        # glo_smax, gl_off, gl_cnt; G; bloom, hit, gl, pos; planted_fault;
        # stream
        "cascade_sm90_launch": (_I,) + (_P,) * 12 + (_I,) * 2 + (_P,) * 6
        + (_I,) + (_P,) * 4 + (_I, _P),
        "cascade_sm90_floor_launch": (_I,) * 3 + (_P,)},
    "merge_path_sm90": {
        # a, na, b, nb, out, planted_fault, stream
        "merge_path_sm90_launch": (_P, _I, _P, _I, _P, _I, _P),
        "merge_path_sm90_floor_launch": (_I, _I, _P)},
    "bloom_sm90": {
        # n, keys, words, m_bits, seeds (host), H, out, planted_fault,
        # stream
        "bloom_sm90_launch": (_I, _P, _P, _U, _P, _I, _P, _I, _P),
        "bloom_sm90_floor_launch": (_I, _P)},
    "interval_sm90": {
        # n, keys, seqs, m, lo, hi, smin, smax, out, planted_fault, stream
        "interval_sm90_launch": (_I, _P, _P, _I) + (_P,) * 5 + (_I, _P),
        "interval_sm90_floor_launch": (_I, _P)},
}

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


def _load(name: str, path: Path) -> None:
    """Load a built library and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    for entry_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _libs[name] = lib


def build_all() -> None:
    """Compile every kernel source at once (one nvcc per source, all
    started together) and load the libraries."""
    with _lock:
        todo = [name for name in KERNELS if name not in _libs]
        started = [(name, *_start_build(name)) for name in todo]
        for name, proc, lib in started:
            _finish_build(name, proc, lib)
            _load(name, lib)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            proc, path = _start_build(name)
            _finish_build(name, proc, path)
            _load(name, path)
        return _libs[name]


def entry(name: str, fn: str):
    """The C entry point ``fn`` of kernel ``name``'s library, declared
    as ``SIGNATURES`` gives it."""
    if fn not in SIGNATURES[name]:
        raise KeyError(f"{name}: no declared entry point {fn}")
    return getattr(library(name), fn)


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


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtypes=INTS) -> torch.device:
    """Check that every operand is a contiguous tensor of one of
    ``dtypes`` (by default the 32-bit ints) on one CUDA device; return
    that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: operands of {dtypes} expected, "
                            f"got {t.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {dev}")
    return dev


def plain_vjp(fn, inputs, grad_outputs, needs) -> tuple:
    """The vector-Jacobian product of ``fn`` (a kernel's plain version)
    at ``inputs``, recomputed under autograd: the gradient of each input
    whose ``needs`` is true (None for the others) given the gradients of
    ``fn``'s outputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(outs, want, grad_outputs,
                                       allow_unused=True) if want else ())
    return tuple(next(got) if n else None for n in needs)
