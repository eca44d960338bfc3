"""Plain PyTorch version of the fused lookup-cascade kernel.

Same packed layout and outputs as the kernel (see ``ops.CascadeState``):
per SSTable level a lower-bound fence position over the level's true
count, the Bloom verdict against the level's word segment and the exact
hit, with the first hit resolving the entry's seq; per GLORAN level the
upper-bound point stab of (key, resolved seq).
"""

from __future__ import annotations

import torch

from ..u32 import mix32, widen


def cascade_ref(qkey, qhash, qseq, qres, st):
    """Returns ``(bloom, hit, gl, pos)``: int32 (n,) bitmasks (bit l =
    verdict at packed level l, bit g = coverage at GLORAN level g) and
    int32 (L, n) level-local candidate positions."""
    q, qh = widen(qkey), widen(qhash)
    res_seq = widen(qseq)
    resolved = qres != 0
    dev = q.device
    n = q.numel()
    lkeys, lseqs, words = widen(st.lkeys), widen(st.lseqs), widen(st.words)
    key_off, key_cnt = st.key_off.tolist(), st.key_cnt.tolist()
    word_off = st.word_off.tolist()
    mbits = widen(st.mbits).tolist()
    seeds = widen(st.seeds).tolist()
    bloom = torch.zeros(n, dtype=torch.int32, device=dev)
    hit = torch.zeros(n, dtype=torch.int32, device=dev)
    gl = torch.zeros(n, dtype=torch.int32, device=dev)
    pos = torch.empty((st.L, n), dtype=torch.int32, device=dev)
    for l in range(st.L):
        o, c = key_off[l], key_cnt[l]
        idxc = torch.searchsorted(lkeys[o:o + c], q).clamp_max(c - 1)
        pos[l] = idxc.to(torch.int32)
        maybe = torch.ones(n, dtype=torch.bool, device=dev)
        for h in range(st.H):
            p = mix32(qh, seeds[l][h]) % mbits[l]
            w = words[word_off[l] + (p >> 5)]
            maybe &= ((w >> (p & 31)) & 1) == 1
        h_l = maybe & (lkeys[o + idxc] == q)
        bloom |= maybe.to(torch.int32) << l
        hit |= h_l.to(torch.int32) << l
        res_seq = torch.where(h_l & ~resolved, lseqs[o + idxc], res_seq)
        resolved |= h_l
    if st.G:
        lo, hi = widen(st.glo_lo), widen(st.glo_hi)
        smin, smax = widen(st.glo_smin), widen(st.glo_smax)
        for g, (o, c) in enumerate(zip(st.gl_off.tolist(),
                                       st.gl_cnt.tolist())):
            if c <= 0:
                continue
            i = torch.searchsorted(lo[o:o + c], q, right=True) - 1
            j = o + i.clamp_min(0)
            cov = ((i >= 0) & (q < hi[j]) & (smin[j] <= res_seq)
                   & (res_seq < smax[j]))
            gl |= cov.to(torch.int32) << g
    return bloom, hit, gl, pos
