"""Batched serving loop with a GLORAN-backed session state registry.

The paper's technique as serving infrastructure: an inference fleet keeps
per-session state records (KV-cache page ownership, prefix-cache entries,
session metadata) in an LSM key-value store.  Sessions expire in RANGES —
"drop everything for tenant T", "expire all sessions started before the
deploy" — which is exactly the range-delete workload that poisons point
lookups under RocksDB-style range tombstones.  With GLORAN the
registry's point lookups (one per scheduled token batch per session) stay
fast regardless of expiry churn.

Keys: (session_id << 16 | page_idx).  ``expire_session`` / ``expire_range``
are single range deletes; the decode scheduler's page lookups are typed
``OpBatch`` gets submitted through the engine — ``lookup_submit`` returns
the ``PendingBatch`` so a decode step can run while the registry shards
execute; ``live_pages`` / ``live_pages_batch`` list a session's live
pages with engine range scans over its key slab.  The registry's engine
keeps its filter state on one torch device (``cuda`` unless the caller
asks for ``cpu``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.gloran import GloranConfig
from ..engine import Engine, EngineConfig, OpBatch, PendingBatch
from ..lsm import LSMConfig
from ..models import Transformer
from ..obs import span

PAGE_BITS = 16


@dataclass
class ServeStats:
    tokens_generated: int = 0
    registry_lookups: int = 0
    registry_io_reads: int = 0
    registry_stall_seconds: float = 0.0  # blocked on in-flight lookups
    expired_sessions: int = 0
    wall_seconds: float = 0.0


class SessionRegistry:
    """Engine-backed session/page registry with range-delete expiry.

    Lookups, registrations, expiries and live-page scans execute
    through a sharded batched query ``Engine`` on ``device``;
    ``num_shards=1`` (the default) keeps one tree, reachable as
    ``.tree``.
    """

    def __init__(self, strategy: str = "gloran",
                 lsm_config: LSMConfig | None = None,
                 gloran_config: GloranConfig | None = None,
                 num_shards: int = 1,
                 engine_config: EngineConfig | None = None,
                 device: str = "cuda"):
        self.engine = Engine(
            num_shards=num_shards, strategy=strategy,
            lsm_config=lsm_config or LSMConfig(buffer_capacity=4096,
                                               key_size=16, value_size=48),
            gloran_config=gloran_config,
            config=engine_config or EngineConfig(device=device))

    @property
    def tree(self):
        """The backing LSM-tree — only well-defined unsharded."""
        assert self.engine.num_shards == 1, \
            "registry is sharded; use .engine for per-shard access"
        return self.engine.shards[0].tree

    @property
    def io_reads(self) -> int:
        return self.engine.io_reads

    @staticmethod
    def key(session_id: int, page: int = 0) -> int:
        return (session_id << PAGE_BITS) | page

    @staticmethod
    def _keys(session_ids, pages) -> np.ndarray:
        return (np.asarray(session_ids, np.uint64) << np.uint64(PAGE_BITS)) \
            | np.asarray(pages, dtype=np.uint64)

    def register(self, session_id: int, pages: np.ndarray,
                 values: np.ndarray) -> None:
        self.engine.put_batch(self._keys(session_id, pages),
                              np.asarray(values, dtype=np.uint64))

    def lookup(self, session_ids: np.ndarray,
               pages: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.engine.get_batch(self._keys(session_ids, pages))

    def lookup_submit(self, session_ids: np.ndarray,
                      pages: np.ndarray) -> PendingBatch:
        """Non-blocking ``lookup``: submit the page-lookup batch and
        return its ``PendingBatch`` so the caller can overlap the decode
        step with registry execution; collect with ``.get_results()``."""
        return self.engine.submit(OpBatch.gets(self._keys(session_ids,
                                                          pages)))

    def expire_session(self, session_id: int) -> None:
        lo = session_id << PAGE_BITS
        self.engine.range_delete(lo, lo + (1 << PAGE_BITS))

    def expire_range(self, first_session: int, last_session: int) -> None:
        """Expire [first, last) sessions with ONE range delete."""
        self.engine.range_delete(first_session << PAGE_BITS,
                                 last_session << PAGE_BITS)

    def expire_spans(self, spans) -> None:
        """Expire many [first, last) session spans as ONE batched
        range-delete."""
        self.engine.range_delete_batch(
            [(int(f) << PAGE_BITS, int(l) << PAGE_BITS)
             for f, l in spans])

    def live_pages(self, session_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(pages, values) still live for one session: an engine range
        scan over the session's key slab."""
        lo = session_id << PAGE_BITS
        keys, vals = self.engine.range_scan(lo, lo + (1 << PAGE_BITS))
        return keys & np.uint64((1 << PAGE_BITS) - 1), vals

    def live_pages_batch(self, session_ids) -> list:
        """Batched ``live_pages``: one engine ``range_scan_batch`` for
        many sessions; returns one (pages, values) pair per session."""
        res = self.engine.range_scan_batch(
            [(int(s) << PAGE_BITS, (int(s) + 1) << PAGE_BITS)
             for s in session_ids])
        mask = np.uint64((1 << PAGE_BITS) - 1)
        return [(k & mask, v) for k, v in res]

    def flush(self) -> None:
        self.engine.flush()


class ServeLoop:
    """Greedy batched decode over a model + the session registry.  It
    serves the parameters the model holds (drawn from the seed the
    model was built with, or loaded into it)."""

    def __init__(self, model: Transformer, batch: int, max_len: int,
                 registry: SessionRegistry):
        self.model = model
        self.batch = batch
        self.max_len = max_len
        self.registry = registry
        self.stats = ServeStats()

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32),
                               device=self.model.device)

    @torch.inference_mode()
    def run(self, prompts: np.ndarray, steps: int,
            session_ids: np.ndarray) -> np.ndarray:
        """prompts: (B, P) int32; returns (B, steps) generated tokens.
        Each decode step consults the registry for every live session
        (page lookups), as a production scheduler would."""
        t0 = time.perf_counter()
        b, p_len = prompts.shape
        assert b == self.batch
        model = self.model
        cache = model.init_cache(b, self.max_len)
        # Teacher-forced prompt feed, one decode step a token.
        for t in range(p_len):
            logits, cache = model.decode_step(
                self._tokens(prompts[:, t:t + 1]), cache, t)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out = []
        for t in range(steps):
            # Submit the step's page lookups, decode while the registry
            # shards execute, then collect (a serial engine executes
            # the lookup inside lookup_submit; collection is then free).
            io0 = self.registry.io_reads
            pending = self.registry.lookup_submit(
                session_ids, np.full(b, t % 4, dtype=np.uint64))
            with span("serve.decode", step=t, batch=b):
                logits, cache = model.decode_step(tok, cache, p_len + t)
                tok = torch.argmax(logits[:, -1], dim=-1).to(
                    torch.int32)[:, None]
                out.append(tok[:, 0].cpu().numpy())
            t_wait = time.perf_counter()
            with span("serve.collect", step=t):
                pending.get_results()
            self.stats.registry_stall_seconds += \
                time.perf_counter() - t_wait
            self.stats.registry_lookups += b
            self.stats.registry_io_reads += \
                self.registry.io_reads - io0
            self.stats.tokens_generated += b
        self.stats.wall_seconds += time.perf_counter() - t0
        return np.stack(out, axis=1)
