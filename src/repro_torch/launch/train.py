"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --smoke --device cpu --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --smoke

Runs on the card unless ``--device cpu`` is given; asking for ``cuda``
where there is none raises before anything is built.  ``--smoke`` takes
the arch's reduced same-family config; without it the full config is
built, unless its parameters, gradients and optimizer state outgrow
the card (zamba2-7b's 6.75 B parameters need 81 GB with AdamW), which
raises before building and names the memory.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import ARCHS, get_config, smoke as smoke_cfg
from ..data import PipelineConfig, TokenPipeline
from ..device import resolve_device
from ..models import Transformer, count_params, param_specs
from ..optim import OptimizerConfig
from ..runtime import TrainLoopConfig, run_training


def train_state_bytes(cfg, microbatch: int = 1) -> int:
    """Bytes of parameters, gradients and optimizer state (plus the f32
    gradient sums of ``microbatch > 1``) of a config: AdamW keeps two
    f32 moments a parameter; for Adafactor's factored statistics one
    f32 a parameter is an upper bound."""
    n = count_params(param_specs(cfg))
    size = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    state = 8 * n if cfg.optimizer == "adamw" else 4 * n
    return 2 * size * n + state + (4 * n if microbatch > 1 else 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train with checkpoints.")
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=TrainLoopConfig().checkpoint_dir)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # raises without the card
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    if device.type == "cuda":
        need = train_state_bytes(cfg, args.microbatch)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: parameters, gradients and {cfg.optimizer} "
                f"state need {need / 1e9:.1f} GB; {device} holds "
                f"{have / 1e9:.1f} GB.  Train it with --smoke.")
    model = Transformer(cfg, device=str(device), seed=args.seed)
    print(f"{cfg.name} [{cfg.family}] on {device} "
          f"params={count_params(param_specs(cfg)) / 1e6:.1f}M")
    pipe = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, global_batch=args.global_batch, seq_len=args.seq,
        seed=0, emit_embeddings=cfg.stub_frontend is not None,
        d_model=cfg.d_model))
    res = run_training(model, pipe, TrainLoopConfig(
        total_steps=args.steps, checkpoint_every=max(10, args.steps // 4),
        checkpoint_dir=args.ckpt_dir, microbatch=args.microbatch),
        opt_cfg=OptimizerConfig(name=cfg.optimizer, warmup_steps=10,
                                decay_steps=args.steps),
        rng_seed=args.seed)
    print(f"done: steps={res.final_step} loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f} retries={res.retries}")
    return res


if __name__ == "__main__":
    main()
