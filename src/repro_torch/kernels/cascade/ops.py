"""Wrapper of the fused lookup-cascade kernel (``csrc/cascade_sm90.cu``).

Replaces ``src/repro/kernels/cascade/kernel.py::cascade_pallas``.
``CascadeState`` is the packed filter state the engine's
``DeviceFilterRegistry`` builds once per tree shape and keeps on the
shard's device: per-level keys, seqs and Bloom words, pow2-padded and
concatenated, and the GLORAN disjoint interval view likewise.
``cascade_masks`` takes the plain version for CPU tensors and launches
``cascade_sm90`` (a warp per query and level) for CUDA tensors, or
raises.  ``cascade_lookup`` uploads a query batch and unpacks the
bitmasks into the per-level verdicts the tree's read path consumes.

Pack budgets: the registry declines packs past the ``MAX_PACK_*``
limits, which then go the per-level route.  They are the reference's
values, kept so that kernel counters match it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...obs import span
from .. import native
from ..u32 import to_device, to_numpy
from .ref import cascade_ref


def pack_bytes(key_slots: int, word_slots: int, area_slots: int) -> int:
    """Resident operand bytes of a pack: u32 keys+seqs, u32 words, and
    four u32 interval columns (one budget formula for gate + docs)."""
    return 8 * key_slots + 4 * word_slots + 16 * area_slots


MAX_PACK_KEYS = 1 << 20
MAX_PACK_WORDS = 1 << 20
MAX_PACK_AREAS = 1 << 20
MAX_PACK_BYTES = 12 << 20

_U32_FIELDS = ("lkeys", "lseqs", "words", "mbits", "seeds", "glo_lo",
               "glo_hi", "glo_smin", "glo_smax")
_I32_FIELDS = ("key_off", "key_cnt", "word_off", "gl_off", "gl_cnt")
_GL_FIELDS = ("glo_lo", "glo_hi", "glo_smin", "glo_smax", "gl_off",
              "gl_cnt")


@dataclass
class CascadeState:
    """Packed filter state of one cascade-eligible tree, on one device.

    Every u32 column is int32 storage.  With ``G == 0`` the GLORAN
    columns are empty and the kernel never reads them."""

    lkeys: torch.Tensor      # (K,) u32 concat per-level keys (pow2-padded)
    lseqs: torch.Tensor      # (K,) u32 matching entry seqs
    key_off: torch.Tensor    # (L,) i32 segment offsets
    key_cnt: torch.Tensor    # (L,) i32 true (unpadded) level sizes
    words: torch.Tensor      # (W,) u32 concat Bloom words (pow2-padded)
    word_off: torch.Tensor   # (L,) i32
    mbits: torch.Tensor      # (L,) u32 per-level filter bit counts
    seeds: torch.Tensor      # (L, H) u32 per-level hash seeds
    glo_lo: torch.Tensor     # (A,) u32 GLORAN disjoint view (clamped u32)
    glo_hi: torch.Tensor
    glo_smin: torch.Tensor
    glo_smax: torch.Tensor
    gl_off: torch.Tensor     # (G,) i32
    gl_cnt: torch.Tensor     # (G,) i32
    L: int
    H: int
    G: int

    @classmethod
    def from_numpy(cls, device, **arrays) -> "CascadeState":
        """A state on ``device`` (no default: the caller names the card
        or the CPU) from host arrays named like the fields
        (e.g. ``np.asarray`` of each array of the JAX package's
        ``CascadeState``).  ``L``, ``H`` and ``G`` come from the shapes;
        with ``G == 0`` the GLORAN arrays may be absent or placeholders."""
        seeds = np.asarray(arrays["seeds"])
        L, H = seeds.shape
        G = len(np.asarray(arrays.get("gl_off", ())))
        cols = {}
        for f in _U32_FIELDS + _I32_FIELDS:
            a = np.asarray(arrays[f]) if (G or f not in _GL_FIELDS) \
                else np.zeros(0)
            cols[f] = to_device(a, device, np.uint32 if f in _U32_FIELDS
                                else np.int32)
        return cls(**cols, L=int(L), H=int(H), G=int(G))

    @property
    def device(self) -> torch.device:
        return self.lkeys.device

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * 4
                   for f in _U32_FIELDS + _I32_FIELDS)


def cascade_masks(qkey, qhash, qseq, qres, state: CascadeState):
    """One fused pass over every level for (n,) query tensors (u32 keys,
    folded u32 Bloom hashes, u32 seqs and int32 resolved flags of
    entries the memtable already answered) on the state's device.

    Returns ``(bloom, hit, gl, pos)``: int32 (n,) bitmasks and int32
    (L, n) level-local candidate positions."""
    if qkey.device.type == "cpu":
        return cascade_ref(qkey, qhash, qseq, qres, state)
    return _launch_sm90(qkey, qhash, qseq, qres, state)


def _launch_sm90(qkey, qhash, qseq, qres, st: CascadeState, *,
                 planted_fault: bool = False):
    """``cascade_sm90``; ``planted_fault`` stabs the GLORAN levels at
    lower_bound - 1 (a wrong kernel, for the card's checks)."""
    if not (1 <= st.L <= 30 and 0 <= st.G <= 30):
        raise ValueError(f"cascade_sm90: L={st.L}, G={st.G} outside "
                         f"1..30/0..30")
    gl_cols = (st.glo_lo, st.glo_hi, st.glo_smin, st.glo_smax, st.gl_off,
               st.gl_cnt) if st.G else ()
    dev = native.require_cuda(
        "cascade_sm90", qkey, qhash, qseq, qres, st.lkeys, st.lseqs,
        st.key_off, st.key_cnt, st.words, st.word_off, st.mbits, st.seeds,
        *gl_cols)
    n = qkey.numel()
    outs = (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((st.L, n), dtype=torch.int32, device=dev))
    p = native.ptr
    gp = (lambda t: p(t if st.G else None))
    fn = native.entry("cascade_sm90", "cascade_sm90_launch")
    native.check("cascade_sm90", fn(
        n, p(qkey), p(qhash), p(qseq), p(qres), p(st.lkeys), p(st.lseqs),
        p(st.key_off), p(st.key_cnt), p(st.words), p(st.word_off),
        p(st.mbits), p(st.seeds), st.L, st.H, gp(st.glo_lo), gp(st.glo_hi),
        gp(st.glo_smin), gp(st.glo_smax), gp(st.gl_off), gp(st.gl_cnt),
        st.G, *map(p, outs), int(planted_fault), native.stream(dev)))
    native.count_launch("cascade_sm90")
    return outs


def _launch_floor(n: int, st: CascadeState) -> None:
    """An empty kernel on ``cascade_sm90``'s grid for n queries: the
    launch floor beneath its time (not a launch of the cascade)."""
    fn = native.entry("cascade_sm90", "cascade_sm90_floor_launch")
    native.check("cascade_sm90_floor",
                 fn(n, st.L, st.G, native.stream(st.device)))


def cascade_lookup(qkey32, qhash32, qseq32, qres, state: CascadeState):
    """One fused launch for a batch of point lookups given as host
    arrays: (n,) u32 exact keys (u32-gated by the caller), u32
    ``fold64to32`` Bloom inputs, u32 seqs and bool resolved flags.

    Returns numpy ``(maybe, hit, gl_cov, pos)``: (n, L) bool Bloom and
    exact-match verdicts per level, (n, G) bool GLORAN per-level
    coverage of (key, resolved seq), and (n, L) int64 level-local
    candidate positions."""
    n = len(qkey32)
    with span("kernel.cascade", n=n, levels=state.L, gl_levels=state.G):
        dev = state.device
        # The host's three phases.  The first copy back waits on the
        # kernel, so on the device it starts after ``cascade.launch``
        # opens and ends before ``cascade.copy_back`` closes.
        with span("cascade.upload", n=n):
            q = (to_device(qkey32, dev), to_device(qhash32, dev),
                 to_device(qseq32, dev),
                 to_device(np.asarray(qres, bool), dev, np.int32))
        with span("cascade.launch", n=n):
            bloom, hit, gl, pos = cascade_masks(*q, state)
        with span("cascade.copy_back", n=n):
            bloom, hit, gl, pos = (to_numpy(t, np.int32)
                                   for t in (bloom, hit, gl, pos))
    lbits = np.arange(state.L, dtype=np.int32)
    maybe = ((bloom[:, None] >> lbits) & 1).astype(bool)
    hitm = ((hit[:, None] >> lbits) & 1).astype(bool)
    gbits = np.arange(state.G, dtype=np.int32)
    gl_cov = ((gl[:, None] >> gbits) & 1).astype(bool)
    return maybe, hitm, gl_cov, pos.T.astype(np.int64)
