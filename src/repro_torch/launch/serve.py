"""Serving launcher CLI: batched decode + GLORAN session registry.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --smoke

Runs on the card unless ``--device cpu`` is given; asking for ``cuda``
where there is none raises before anything is built.  The MoE archs'
full configs do not fit one 80 GB card (mixtral-8x7b holds 46.7 B
parameters, 93.4 GB in bf16; kimi-k2 about 1 T), so ``--smoke`` is
their path on a card as on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import ARCHS, get_config, smoke as smoke_cfg
from ..device import resolve_device
from ..models import Transformer
from ..runtime import ServeLoop, SessionRegistry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Batched decode behind a session registry.",
        epilog="mixtral-8x7b and kimi-k2-1t-a32b outgrow one 80 GB card "
               "at full size: serve them with --smoke, on a card or with "
               "--device cpu.")
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--registry", default="gloran",
                    choices=("gloran", "lrr"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # raises without the card
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    if cfg.stub_frontend is not None:
        raise SystemExit("stub-frontend archs serve via embeddings; use a "
                         "token arch for this CLI")
    model = Transformer(cfg, device=str(device), seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reg = SessionRegistry(strategy=args.registry, device=str(device))
    sessions = np.arange(args.batch, dtype=np.uint64)
    for s in sessions:
        reg.register(int(s), np.arange(8), np.arange(8))
    loop = ServeLoop(model, batch=args.batch, max_len=args.max_len,
                     registry=reg)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.batch, 8)).astype(np.int32)
    out = loop.run(prompts, steps=args.steps, session_ids=sessions)
    tps = loop.stats.tokens_generated / max(loop.stats.wall_seconds, 1e-9)
    print(f"generated {out.shape} on {device}, {tps:.0f} tok/s, registry "
          f"lookups {loop.stats.registry_lookups}")
    reg.engine.close()


if __name__ == "__main__":
    main()
