"""Device-resident read-path filter registry for the fused cascade.

Makes the whole filter stack **persistent device state** on the shard's
torch device: each SSTable's packed piece (u32 keys + entry seqs +
pow2-padded Bloom words) is uploaded once when the run is first probed
— runs are immutable, so the piece is cached on ``(SSTable.uid,
device)`` until a compaction replaces the run — and the GLORAN disjoint
interval view is uploaded once per index epoch (``LSMDRTree.epoch``
moves on index flush/compaction/GC).  Assembling a ``CascadeState`` for
the cascade kernel is then a device-side concat of cached pieces; a
steady-state lookup uploads nothing but its own queries.

Pow2 padding (keys, words, interval columns) is the JAX package's
layout, kept so the ``upload_bytes`` ledger and the pack budgets match
it byte for byte; the kernel itself reads true counts.

Eligibility: the cascade compares keys exactly in u32 working space, so
a tree whose level keys or entry seqs reach 2^32 - 1 is declined
wholesale and the per-level route serves it — identical results, just
per-level launches.  GLORAN interval columns are *clamped* into u32
like the per-level view (exact for u32-range queries); packs past the
``MAX_PACK_*`` budgets are also declined.  Every decline is cached on
the same key as a hit, so ineligible trees pay one scan, not one per
lookup.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.cascade.ops import (CascadeState, MAX_PACK_AREAS,
                                   MAX_PACK_BYTES, MAX_PACK_KEYS,
                                   MAX_PACK_WORDS, pack_bytes)
from ..kernels.u32 import to_device
from ..obs import span
from .stats import KernelCounters

_U32_LIMIT = 0xFFFFFFFF
_MAX_LEVEL_BITS = 30  # survivor masks are int32 bitmasks


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def clamp_level_u32(areas):
    """Clamped, pow2-padded u32 columns of one disjoint DR-tree level.

    THE single source of the u32 working-space transform both kernel
    paths rely on (the cascade's packed GLORAN view here, the per-level
    interval path via ``ShardExecutor._level_u32``) — the cascade-vs-
    per-level parity contract requires the two to stay bit-identical.
    Exact for queries with key, seq < 2^32 - 1: areas that cannot cover
    such queries (lo or smin past u32) are dropped, hi/smax are clamped
    to the u32 ceiling (coverage for in-range queries is unchanged), and
    the columns are padded to a power of two (min 64) with
    never-covering sentinels (lo = hi = ceiling, smax = 0).

    Returns ``(lo, hi, smin, smax, n)`` numpy uint32 columns + the true
    (unpadded) area count.
    """
    ceil = np.uint64(_U32_LIMIT)
    keep = (areas.lo < ceil) & (areas.smin < ceil)
    lo = areas.lo[keep]
    n = len(lo)
    pad = max(64, _next_pow2(n))
    cols = (np.full(pad, _U32_LIMIT, np.uint32),
            np.full(pad, _U32_LIMIT, np.uint32),
            np.zeros(pad, np.uint32),
            np.zeros(pad, np.uint32))
    cols[0][:n] = lo.astype(np.uint32)
    cols[1][:n] = np.minimum(areas.hi[keep], ceil).astype(np.uint32)
    cols[2][:n] = areas.smin[keep].astype(np.uint32)
    cols[3][:n] = np.minimum(areas.smax[keep], ceil).astype(np.uint32)
    return cols[0], cols[1], cols[2], cols[3], n


@dataclass
class _RunPiece:
    """One SSTable's device-resident filter piece (immutable, per-uid)."""

    sstable: object        # pinned: uid is only unique while it lives
    keys: torch.Tensor     # (pow2,) u32, 0xFFFFFFFF sentinels
    seqs: torch.Tensor     # (pow2,) u32, zero padding
    words: torch.Tensor    # (pow2,) u32 Bloom words, zero padding
    n: int                 # true entry count
    m_bits: int
    seeds: np.ndarray      # (H,) u32


@dataclass
class _GlPiece:
    """One DR-tree level's clamped u32 interval columns (per-object)."""

    level: object          # pinned DRTree
    lo: torch.Tensor       # (pow2,) u32, never-covering sentinels
    hi: torch.Tensor
    smin: torch.Tensor
    smax: torch.Tensor
    n: int                 # clamped area count


@dataclass
class CascadeView:
    """Everything one fused launch needs for one tree state."""

    state: CascadeState
    slots: np.ndarray          # tree level index -> packed column (-1)
    has_gloran: bool           # gl_cov columns align with index levels


class DeviceFilterRegistry:
    """Per-shard cache of device-resident packed filter state.

    Invalidation is structural, never temporal: the LSM half keys on the
    exact (level index, run uid, run length) tuple — process-unique uids
    make stale hits impossible after compaction — and the GLORAN half
    keys on the index epoch.  A changed key rebuilds only the changed
    pieces (uploads are counted in the kernel counters' byte ledger,
    split per destination device) and re-concats the rest on device.
    """

    def __init__(self, device: torch.device,
                 counters: KernelCounters | None = None):
        self.counters = counters if counters is not None else \
            KernelCounters()
        self.device = torch.device(device)
        self._dev_key = str(self.device)
        self._runs: dict[tuple, _RunPiece] = {}   # (uid, dev) -> piece
        self._gl: dict[tuple, _GlPiece] = {}      # (id(level), dev) -> piece
        self._view: CascadeView | None = None
        self._view_key: tuple | None = None          # includes declines
        self._bloom_words: OrderedDict[int, torch.Tensor] = OrderedDict()

    def _put(self, arr, dtype=np.uint32) -> torch.Tensor:
        return to_device(arr, self.device, dtype)

    def _charge_upload(self, nbytes: int) -> None:
        """Count host->device bytes in the total AND per-device ledger."""
        self.counters.upload_bytes += nbytes
        by_dev = self.counters.upload_bytes_by_device
        by_dev[self._dev_key] = by_dev.get(self._dev_key, 0) + nbytes

    # ----------------------------------------------------------- packing
    def view(self, tree) -> CascadeView | None:
        """The cascade view of ``tree``'s current levels (+ GLORAN index
        when present), rebuilt only when the structure moved; None when
        the tree is cascade-ineligible."""
        lvls = [(i, lvl) for i, lvl in enumerate(tree.levels)
                if lvl is not None and len(lvl)]
        gloran = tree.gloran if tree.strategy == "gloran" else None
        gl_levels = gloran.level_views() if gloran is not None else None
        key = (len(tree.levels),
               tuple((i, lvl.uid, len(lvl)) for i, lvl in lvls),
               None if gloran is None else gloran.index_epoch,
               None if gl_levels is None else len(gl_levels))
        if key == self._view_key:
            return self._view
        with span("registry.pack", levels=len(lvls),
                  gl_levels=len(gl_levels or [])):
            view = self._build(tree, lvls, gl_levels)
        self._view, self._view_key = view, key
        return view

    def _build(self, tree, lvls, gl_levels) -> CascadeView | None:
        # Evict first, gate after: even a tree that has become cascade-
        # ineligible must release the pieces (and the runs/levels they
        # pin) of structures compaction has since replaced.
        self._evict(tree, gl_levels)
        if not lvls or len(lvls) > _MAX_LEVEL_BITS:
            return None
        if gl_levels is not None and len(gl_levels) > _MAX_LEVEL_BITS:
            return None
        for _, lvl in lvls:
            if lvl.max_key >= _U32_LIMIT or lvl.max_seq >= _U32_LIMIT:
                return None
        # Budget + uniformity gates run on host-side lengths BEFORE any
        # piece is built, so a permanently over-budget tree never pays a
        # host->device upload for a view that will always be declined.
        H = len(lvls[0][1].bloom.seeds)
        if any(len(lvl.bloom.seeds) != H for _, lvl in lvls):
            return None
        key_slots = sum(_next_pow2(len(lvl)) for _, lvl in lvls)
        word_slots = sum(_next_pow2(len(lvl.bloom.words))
                         for _, lvl in lvls)
        # u32 clamping only shrinks a level's columns, so the unclamped
        # bound is conservative (a decline just means per-level serving).
        area_slots = sum(max(64, _next_pow2(len(g.areas)))
                         for g in (gl_levels or []))
        if (key_slots > MAX_PACK_KEYS or word_slots > MAX_PACK_WORDS
                or area_slots > MAX_PACK_AREAS
                or pack_bytes(key_slots, word_slots,
                              area_slots) > MAX_PACK_BYTES):
            return None
        pieces = [self._run_piece(lvl) for _, lvl in lvls]
        key_pad = [p.keys.numel() for p in pieces]
        word_pad = [p.words.numel() for p in pieces]
        gl_pieces = [self._gl_piece(g) for g in (gl_levels or [])]
        gl_pad = [p.lo.numel() for p in gl_pieces]

        slots = np.full(len(tree.levels), -1, np.int32)
        for col, (i, _) in enumerate(lvls):
            slots[i] = col
        i32 = np.int32
        state = CascadeState(
            lkeys=torch.cat([p.keys for p in pieces]),
            lseqs=torch.cat([p.seqs for p in pieces]),
            key_off=self._put(np.cumsum([0] + key_pad[:-1]), i32),
            key_cnt=self._put([p.n for p in pieces], i32),
            words=torch.cat([p.words for p in pieces]),
            word_off=self._put(np.cumsum([0] + word_pad[:-1]), i32),
            mbits=self._put([p.m_bits for p in pieces]),
            seeds=self._put(np.stack([p.seeds for p in pieces])),
            glo_lo=self._gl_cat(gl_pieces, "lo"),
            glo_hi=self._gl_cat(gl_pieces, "hi"),
            glo_smin=self._gl_cat(gl_pieces, "smin"),
            glo_smax=self._gl_cat(gl_pieces, "smax"),
            gl_off=self._put(np.cumsum([0] + gl_pad[:-1])
                             if gl_pieces else [], i32),
            gl_cnt=self._put([p.n for p in gl_pieces], i32),
            L=len(pieces), H=H, G=len(gl_pieces))
        self.counters.cascade_packs += 1
        return CascadeView(state=state, slots=slots,
                           has_gloran=gl_levels is not None)

    def _gl_cat(self, pieces: list[_GlPiece], field: str) -> torch.Tensor:
        if not pieces:  # G = 0: the kernel reads no GLORAN column
            return self._put([])
        return torch.cat([getattr(p, field) for p in pieces])

    def _run_piece(self, lvl) -> _RunPiece:
        piece = self._runs.get((lvl.uid, self._dev_key))
        if piece is not None and piece.sstable is lvl:
            return piece
        with span("registry.upload_run", uid=lvl.uid, entries=len(lvl),
                  device=self._dev_key):
            n = len(lvl)
            pad = _next_pow2(n)
            keys = np.full(pad, _U32_LIMIT, np.uint32)
            keys[:n] = lvl.keys.astype(np.uint32)
            seqs = np.zeros(pad, np.uint32)
            seqs[:n] = lvl.seqs.astype(np.uint32)
            bb = lvl.bloom
            wpad = _next_pow2(len(bb.words))
            words = np.zeros(wpad, np.uint32)
            words[:len(bb.words)] = bb.words
            piece = _RunPiece(sstable=lvl, keys=self._put(keys),
                              seqs=self._put(seqs),
                              words=self._put(words),
                              n=n, m_bits=bb.m_bits, seeds=bb.seeds)
            self._charge_upload(keys.nbytes + seqs.nbytes + words.nbytes)
            self._runs[(lvl.uid, self._dev_key)] = piece
        return piece

    def _gl_piece(self, lvl) -> _GlPiece:
        piece = self._gl.get((id(lvl), self._dev_key))
        if piece is not None and piece.level is lvl:
            return piece
        with span("registry.upload_gl", areas=len(lvl.areas),
                  device=self._dev_key):
            lo, hi, smin, smax, n = clamp_level_u32(lvl.areas)
            piece = _GlPiece(level=lvl, lo=self._put(lo),
                             hi=self._put(hi), smin=self._put(smin),
                             smax=self._put(smax), n=n)
            self._charge_upload(4 * lo.nbytes)
            self._gl[(id(lvl), self._dev_key)] = piece
        return piece

    def _evict(self, tree, gl_levels) -> None:
        """Drop pieces of compacted-away runs/levels so stale device
        copies (and the objects they pin) don't linger."""
        live = {lvl.uid for lvl in tree.levels
                if lvl is not None and len(lvl)}
        self._runs = {k: p for k, p in self._runs.items()
                      if k[0] in live}
        for uid in [u for u in self._bloom_words if u not in live]:
            del self._bloom_words[uid]
        if gl_levels is not None:
            alive = {id(g) for g in gl_levels}
            self._gl = {k: p for k, p in self._gl.items()
                        if k[0] in alive}

    # -------------------------------------------- per-level device state
    def gl_columns(self, lvl, live) -> tuple:
        """Device-resident clamped u32 columns of one DR-tree level, for
        the per-level (non-cascade) interval path — served from the same
        cached ``_GlPiece`` the cascade packs, so both kernel paths
        share ONE upload and ONE device copy per level.  ``live`` is the
        index's current non-None level list; pieces of compacted-away
        levels are pruned against it (cascade-off engines never call
        ``view()``, so eviction must happen here too)."""
        alive = {id(g) for g in live}
        if any(k[0] not in alive for k in self._gl):
            self._gl = {k: p for k, p in self._gl.items()
                        if k[0] in alive}
        p = self._gl_piece(lvl)
        return p.lo, p.hi, p.smin, p.smax

    def bloom_words(self, lvl) -> torch.Tensor:
        """Device-resident Bloom words of one run, for the per-level
        (non-cascade) kernel path: uploaded once per uid, served from
        the cascade piece when one exists, else from a small LRU.
        Run uids are process-unique and never recycled, so a uid hit
        can never be stale; only the words are stored (no run pin)."""
        piece = self._runs.get((lvl.uid, self._dev_key))
        if piece is not None and piece.sstable is lvl:
            return piece.words  # pow2-padded: positions never reach pad
        words = self._bloom_words.get(lvl.uid)
        if words is not None:
            self._bloom_words.move_to_end(lvl.uid)
            return words
        words = self._put(lvl.bloom.words)
        self._charge_upload(lvl.bloom.words.nbytes)
        self._bloom_words[lvl.uid] = words
        if len(self._bloom_words) > 128:
            self._bloom_words.popitem(last=False)
        return words
