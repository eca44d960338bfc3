"""The control of the correctness check: the reference put in the
program's place with one guarantee the configuration states broken.

The store states that a read sees every write acknowledged before it.
The control acknowledges each write batch one batch early: a read sees
every write batch but the last one acknowledged before it, as a store
that acknowledged before applying would.  It answers the same reads, at
the same points of the same stream, that a run of the program served,
and the harness's comparison holds its answers to the reference.  The
program's own run gives the lower reading of each number compared, the
control the upper one; the limit lies between them.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <run_seconds>

Prints one JSON line a seed, each with the program's checks and the
control's.  It needs the card the cell asks for, as a run does.
"""

from __future__ import annotations

import time


import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def lagged(model, at: int) -> int:
    """The read point of a store one write batch behind: the start of
    the last write batch acknowledged before ``at``."""
    s = np.asarray(model.starts)
    i = int(np.searchsorted(s, at, "left")) - 1
    return int(s[i]) if i >= 0 else 0


def control_checks(client) -> dict:
    """The control's answers to the client's reads, compared with the
    reference's by the harness's own comparison."""
    from perfbench.reference import compare_gets, compare_scans
    m = client.model
    gets = [(k, at, *m.lookup(k, lagged(m, at))) for k, at, _, _ in
            client.gets]
    scans = [(lo, hi, at, m.scan(lo, hi, lagged(m, at)))
             for lo, hi, at, _ in client.scans]
    out = {}
    if gets:
        out["wrong_get_answers"] = compare_gets(m, gets)[0]
    if scans:
        out["wrong_scans"] = compare_scans(m, scans)[0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import run_cell
    import torch
    if not torch.cuda.is_available():
        print("the control runs the program on a CUDA card",
              file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        clients: list = []
        out = run_cell(args.workload, seed, args.seconds, False,
                       t_start=time.perf_counter(), clients=clients,
                       log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "attempted": out["attempted"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": control_checks(clients[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
