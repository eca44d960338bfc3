"""The benchmark of the PyTorch/CUDA store (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card of this machine
and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the correctness check compared, with its limit (also the last
lines of standard error).  Without a CUDA card, or with fewer cards than
the cell asks for, it exits non-zero and prints no result; it never
falls back to the CPU.  It exits non-zero too if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # One thread for the libraries' own pools: the engine's shard
    # threads are the run's only parallel load.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # Build and kernel caches live at fixed paths inside the checkout
    # (the kernels' nvcc builds go to build/repro_torch/ there).
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import cell_spec, jax_modules, load_bench, run_cell

    bench = load_bench(ROOT)
    chips = cell_spec(bench, args.workload, ROOT)["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine "
            f"has {torch.cuda.device_count()} (no CPU fallback)")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, bench=bench, root=ROOT, log=log)
    found = jax_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
