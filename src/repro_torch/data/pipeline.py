"""Deterministic, shardable, checkpointable synthetic data pipeline.

Produces token batches from a counter-based RNG (threefry on (seed, step,
host_shard)): any batch is reproducible from (seed, step) alone, so the
pipeline state checkpoint is just two integers — restart-safe and
elastic (a different host count re-slices the same global batch).

This stands in for a tokenized corpus reader; the interface (``next()``,
``state()``, ``restore()``, per-host sharding) is the production one.
A copy of ``repro.data.pipeline`` (host numpy): the batches are the
JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    emit_embeddings: bool = False  # stub-frontend archs
    d_model: int = 0


def _batch_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step,)))


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.step = 0

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def next(self) -> dict:
        """Next per-host batch: {tokens|embeds, labels}."""
        cfg = self.cfg
        rng = _batch_rng(cfg.seed, self.step)
        # Draw the GLOBAL batch deterministically, slice this host's rows:
        # elastic restarts with different n_hosts see identical data.
        if cfg.emit_embeddings:
            glob = rng.standard_normal(
                (cfg.global_batch, cfg.seq_len, cfg.d_model),
                dtype=np.float32)
            labels = rng.integers(0, cfg.vocab,
                                  size=(cfg.global_batch, cfg.seq_len),
                                  dtype=np.int32)
        else:
            glob = rng.integers(0, cfg.vocab,
                                size=(cfg.global_batch, cfg.seq_len),
                                dtype=np.int32)
            # Labels are a fixed bijection of the tokens: a learnable
            # stand-in for next-token targets.  (Independent random labels
            # would make the irreducible loss ln(vocab) — nothing to
            # learn, so training smoke tests could only pass by noise.)
            labels = (glob + 1) % cfg.vocab
        lo = cfg.host_id * self.host_batch
        hi = lo + self.host_batch
        self.step += 1
        key = "embeds" if cfg.emit_embeddings else "tokens"
        return {key: glob[lo:hi], "labels": labels[lo:hi]}

    # ------------------------------------------------------- checkpointing
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(state["step"])
