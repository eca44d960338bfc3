"""Fault-tolerant training loop (a port of
``repro.runtime.train_loop``).

Wraps the train step with the production concerns:
  * periodic async checkpoints (atomic; keep-last-k),
  * restart recovery (params/opt/pipeline/step restored from latest),
  * step retry on transient failures + failure injection for tests,
  * preemption handling (SIGTERM -> blocking final checkpoint),
  * straggler detection hooks (per-host durations -> mitigation callback).

Checkpoints hold the JAX package's trees (``carry.jax_params``, the
optimizer's stacked state), so a run of either package resumes the
other's.  With no checkpoint the parameters are drawn from ``rng_seed``
by the model's own init rule, as ``Transformer(cfg, seed=rng_seed)``
draws them on its device.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..carry import jax_params, load_jax_params, param_leaves, param_template
from ..ckpt.checkpoint import CheckpointManager
from ..data.pipeline import TokenPipeline
from ..launch.steps import make_train_step
from ..models import Transformer
from ..optim.optimizer import OptimizerConfig, make_optimizer
from .straggler import StragglerDetector


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = field(default_factory=_default_dir)
    keep_checkpoints: int = 3
    max_retries: int = 3
    log_every: int = 10
    microbatch: int = 1


class TransientFailure(Exception):
    """Simulated recoverable fault (node flake, collective timeout)."""


@dataclass
class TrainResult:
    final_step: int
    losses: list = field(default_factory=list)
    retries: int = 0
    resumed_from: int | None = None
    preempted: bool = False
    straggler_events: list = field(default_factory=list)


def _copy_into(dst: dict, src: dict) -> None:
    """Copy a restored tree into the live state's tensors."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def run_training(model: Transformer, pipeline: TokenPipeline,
                 loop_cfg: TrainLoopConfig,
                 opt_cfg: OptimizerConfig | None = None,
                 failure_injector=None, rng_seed: int = 0,
                 host_durations_fn=None) -> TrainResult:
    """failure_injector(step) -> bool: raise TransientFailure when True.
    host_durations_fn(step, real_duration) -> list[float]: per-host step
    times (tests inject stragglers)."""
    opt_cfg = opt_cfg or OptimizerConfig(name=model.cfg.optimizer,
                                         warmup_steps=10, decay_steps=1000)
    init_fn, _ = make_optimizer(opt_cfg)
    step_fn = make_train_step(model, opt_cfg,
                              microbatch=loop_cfg.microbatch)
    ckpt = CheckpointManager(loop_cfg.checkpoint_dir,
                             keep=loop_cfg.keep_checkpoints)
    detector = StragglerDetector(n_hosts=max(1, pipeline.cfg.n_hosts))
    result = TrainResult(final_step=0)

    # ---------------------------------------------------------- bootstrap
    opt_state = init_fn(param_leaves(model))
    start_step = 0
    latest = ckpt.latest_step()
    if latest is None:
        model.reseed(rng_seed)
    else:
        state, extra = ckpt.restore({"params": param_template(model),
                                     "opt": opt_state}, step=latest)
        load_jax_params(model, state["params"])
        _copy_into(opt_state, state["opt"])
        pipeline.restore(extra["pipeline"])
        start_step = int(extra["step"])
        result.resumed_from = start_step

    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    try:
        step = start_step
        while step < loop_cfg.total_steps:
            batch = pipeline.next()
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in batch.items()}
            attempts = 0
            while True:
                try:
                    if failure_injector is not None and \
                            failure_injector(step):
                        raise TransientFailure(f"injected @ step {step}")
                    t0 = time.perf_counter()
                    opt_state, metrics = step_fn(opt_state, batch)
                    loss = float(metrics["loss"])
                    dur = time.perf_counter() - t0
                    break
                except TransientFailure:
                    attempts += 1
                    result.retries += 1
                    if attempts > loop_cfg.max_retries:
                        raise
            durations = (host_durations_fn(step, dur)
                         if host_durations_fn else [dur])
            flagged = detector.observe(step, durations)
            if flagged:
                result.straggler_events.extend(
                    detector.events[-len(flagged):])
            result.losses.append(loss)
            step += 1
            result.final_step = step
            if step % loop_cfg.checkpoint_every == 0 or \
                    step == loop_cfg.total_steps or preempted["flag"]:
                ckpt.save(step, {"params": jax_params(model),
                                 "opt": opt_state},
                          extra={"step": step,
                                 "pipeline": pipeline.state()},
                          blocking=preempted["flag"])
            if preempted["flag"]:
                result.preempted = True
                break
        ckpt.wait()
        return result
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        try:
            # Durability even on the failure path: a crash must not lose
            # checkpoints already queued (the restart depends on them).
            ckpt.wait()
        except Exception:
            pass
