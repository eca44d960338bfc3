"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` (``$CUDA_HOME``, default ``/usr/local/cuda``)
and this checkout; without them it exits non-zero before printing any
result.  Phases, each of which fails the run on any error:

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the seconds the nine kernels took to build (one
   nvcc per source, all started together).
2. The store's slice: an 8-shard hash-partitioned GLORAN
   ``Engine`` on ``cuda`` with the paper's default ``LSMConfig`` loads
   3 M uniform keys in [0, 2^28) with 1% range deletes (82 deletes of
   length 256 after every 8192-put batch), then answers 64 lookup
   batches of 8192 keys (half loaded, half uniform).  Results must
   equal a plain model of the op stream (last put wins; a range delete
   kills every older put it covers); every shard sub-batch must take
   one ``cascade_sm90`` launch covering G >= 1 GLORAN levels, and
   every ``merge_ranks`` call of the load one
   ``merge_path_sm90`` launch and no ``merge_rank`` launch.
   Bottom-compaction GC leaves
   the DR-tree levels empty at the end of the load, so range deletes
   continue until every shard's index flushes a level again, and the
   lookups run once more against that state, the profiler reading the
   device's busy time over a few of them.
2b. Range scans on the same store at the default gates, each held to the
   plain model (the sorted live keys in [lo, hi) and their values):
   "slabs", 8 batches of 1024 scans of width 2^16 at uniform starts
   (``SessionRegistry.live_pages``' slab), and "long", 8 batches of 64
   scans of width 2^20.  Every launch must be ``merge_path_sm90`` or
   ``interval_sm90``, as many as the ``KernelCounters`` count (the mixes
   run again with the gates lowered only if no interval launch came);
   scans/s, entries/s, batch p50/p99, launches a batch; the profiler's
   device share and a host profile of one batch per mix; the interval
   kernel's sub-batches of batch 0 captured for phase 4.
2c. A second store with ``EngineConfig(scheduler=True)`` takes the same
   load, lookups, tail deletes and both scan mixes: its level shapes,
   ``IOStats`` and kernel counters after the load and after the lookups,
   its lookup results, and its scan results, I/O and counter deltas
   must equal the inline store's; every launch a Hopper kernel, as many
   as the gated calls; put-batch p50/p99, load ops/s and the ``sched``
   counters both ways.
2d. A third 3 M-key store with a write-ahead log
   (``EngineConfig(wal_dir=<tmp dir>, fsync="batch")``) takes the same
   load, lookups and tail deletes and is held to the inline store like
   phase 2c's, with a ``take_snapshot`` after the load; its load ops/s
   and put p50/p99 against the inline store's are the price of an fsync
   a batch.  Then ``recover`` from the directory alone, three ways, each
   held to the inline store in level shapes, ``seq``, ``num_entries``,
   lookup results and (the first two) the digests of both scan mixes'
   first 2 batches: the full
   log replayed, the snapshot plus the WAL tail, and a copy whose shard 0
   lost half of its last frame (shard 0 replays one frame fewer and
   equals a one-shard store fed its surviving frames; shards 1-7 equal
   the full replay).  Every launch of the durable load and of each
   recovery is a ``merge_path_sm90`` one, as many as the gated merges,
   and each recovered lookup batch 8 ``cascade_sm90`` ones, the first
   batch re-packing the registry; wall times, frames/s, the WAL's
   counters, the snapshot's size and the temporary directory's
   filesystem are printed.  The directories are removed at the end.
2e. A fourth 3 M-key store with its shards in worker processes
   (``EngineConfig(procs=4, devices=1, wal_dir=<tmp dir>,
   fsync="batch")``: two shards a worker, every shard on cuda:0, a CUDA
   context a worker) takes the same load, lookups and tail deletes and
   the first 2 batches of each scan mix.  What its parent sees is held to
   the inline store after the load and after the lookups: every shard's
   entries and ``IOStats`` from its worker's STATS reply, the kernel
   counters, and the level records the workers shipped into the
   manifest against ``describe_tree`` of the inline shards (less run
   uids, counted per process, and ``seq``); its lookup results and scan
   digests equal the inline store's.  Each worker's launches (its
   ``native.LAUNCHES``, read through ``ProcPool.launches``) must be
   exactly its shards' gated calls: one ``cascade_sm90`` a lookup
   sub-batch, one ``merge_path_sm90`` a gated merge, one
   ``interval_sm90`` a scan validity call, and nothing else; the parent
   launches nothing.  Then ``recover`` of its directory with 4 workers
   (each replays its own streams) and in-process, both held to the
   inline store in structure, lookups and scan digests.  Load ops/s and
   put p50/p99 against phase 2d's durable store, lookup keys/s and
   p50/p99 against the inline store, scans/s, worker spawn and ready
   seconds, the transport ledger, the workers' allocator peaks and the
   card's memory a process, the replay with 4 workers against phase
   2d's, and the launches a worker are printed; the device's busy share
   is not (the parent's profiler sees no worker's kernels).
2f. A real process death: a writer process (``python3 chip_smoke.py
   --kill-child <dir>`` on ``cuda``, a CUDA context of its own) streams
   the cell's load into a durable 8-shard store (``fsync="batch"``) and
   acknowledges each put batch and its range deletes by a line of
   ``acked.log``, fsynced after both calls returned.  Once a number of
   batches drawn from ``--seed`` in [120, 240] is acknowledged, the
   parent kills it with SIGKILL, recovers the directory on the card and
   looks up each put batch's keys (lookup batches of 8192) up to two
   batches past the in-flight one, then 8192 keys the acked range
   deletes killed.  Every key of the acked batches and of the in-flight
   one must be served as some stage of the envelope gives it, by the
   plain model: the acked prefix, then the in-flight batch's puts, its
   point deletes (none in this stream) and its range deletes, each a
   WAL frame of its own on every shard.  The killed keys must be absent,
   and the envelope of two batches more than were acknowledged (writes
   never issued: a planted fault) must fail.  The replay launches one
   ``merge_path_sm90`` a gated merge; the lookups one ``cascade_sm90`` a
   shard sub-batch that leaves the memtable a key to find, as many as
   the kernel counters count.
3. The per-level route: the same lookups with the cascade off must
   return the same results, every per-level launch a ``bloom_sm90`` or
   ``interval_sm90`` one, as many as the ``KernelCounters`` count gated
   calls.
4. Each store kernel against its plain PyTorch version on the card, at
   the shapes the slice gives it, bit-exact, with its median time, the
   plain version's time, its bound and, for the merge kernels, the
   ``torch.searchsorted`` pair as a yardstick.  ``cascade_sm90`` takes
   shard 0's sub-batch of a real lookup batch as the engine's
   partitioner and memtable probe make it (request order) against
   shard 0's pack, and is timed there, on the same keys sorted, on the
   mixed batch of earlier runs (half uniform keys sorted, half level
   keys in random order), and rotated over the eight shards' sub-batches
   and packs, beside an empty kernel on its grid (the launch floor).
   Keys set to area starts must leave it exact and fail it with its
   GLORAN stab at lower_bound (a planted fault); it runs at n = 8192
   too.  Both merge kernels take runs of 2^19 and 2^16 with cross-run
   duplicates, where ``merge_path_sm90`` with ties broken b-first (a
   planted fault) must fail, then a sweep: (2^12, 2^16), (2^16, 2^19),
   (2^19, 2^22), all keys equal, disjoint runs both ways, a run of one
   both ways, ragged lengths, and 0 and 0xFFFFFFFE present.
   ``bloom_sm90`` and ``interval_sm90``: bit-exact and timed on the
   route's sub-batches captured from a per-level ``get_batch``, on n =
   1024 and 8192 keys against the deepest level's filter and a 3 M-key
   filter (10 bits a key, 6 hashes), and on n = 1024 and 8192 stabs
   against the cell's largest DR-tree level and a level of 2^20 areas,
   beside an empty kernel on the kernel's grid; ``bloom_sm90`` probing
   H - 1 seeds must fail on absent keys and ``interval_sm90`` searching
   lower_bound at area starts (planted faults); then a sweep of edge
   cases (``bloom_cases``, ``interval_cases``) through both kernels.
   Empty kernels on ``merge_path_sm90``'s grid give its floor too.
   ``interval_sm90`` bit-exact and timed on phase 2b's captured scan
   sub-batches (rotated, and the smallest, median and largest beside
   the floor and the bound).
5. The model stack's slice: zamba2-7b at full width and depth (81
   layers, d_model 3584, random weights from ``--seed``).  In f32, a
   prefill of 2 x 128 tokens must launch the CUDA-core SSD kernel 81
   times and the CUDA-core flash kernel 13 times (and the tensor-core
   ones never), and its last logits and every cache entry must equal a
   teacher-forced ``decode_step`` loop over the same tokens (no kernel
   on that path) within 1e-3 of the decode side's largest magnitude.
   In bf16 (the config's type), after a warm-up, three timed prefills
   of 4 x 2048 tokens (the median reported) must each launch the
   tensor-core kernels ``ssd_sm90`` 81 times and
   ``flash_attention_sm90`` 13 times (and the CUDA-core ones never);
   then one prefill's time by kernel family, and ``ServeLoop`` over 4 sessions
   registered in a ``SessionRegistry`` on ``cuda`` for 16 steps: decode
   ms a step and tokens/s.
5b. The MoE serve cell: mixtral-8x7b at full width (d_model 4096, 32
   heads over 8 KV heads of 128, 8 experts top-2 of d_ff 14336, window
   4096).  In f32 at 2 layers, a prefill of 2 x 128 tokens on the card
   (2 ``flash_attention`` launches, nothing else) must equal the port's
   CPU path on the same weights (the model moved with ``.to``) within
   1e-3 of each tensor's largest magnitude, both sides dropping the same
   (token, expert) pairs, counted by a wrapper of the name ``moe_ffn``
   that recomputes top-k, ranks and capacity from its inputs.  Then in
   bf16 at the depth the card holds (24 of 32 layers unless its free
   memory less 8 GB forces fewer; 70.2 GB of weights), phase 5's
   traffic: three timed prefills of 4 x 2048 tokens, each launching
   ``flash_attention_sm90`` once a layer and nothing else, the time by
   kernel family, one MoE layer's time by step (routing, dispatch,
   expert products, combine), and ``ServeLoop`` over 4 sessions for 16
   steps.
5c. On the host: fig9's balanced mix with 5% range deletes
   (``benchmarks/fig9_throughput.py``: 150,000 preloaded keys in
   batches of 8192, 20,000 ops over 2^21 keys) through the port's
   ``make_tree`` / ``run_workload`` for all five strategies, each
   printing ops/s and I/O per op, all answering one seeded lookup batch
   alike; then a ``VersionedSampleStore`` of 8 versions of 100,000
   samples, two purged, held to a plain model by lookups and
   ``scan_version``.
5d. The seven configurations phases 5 and 5b do not run, one at a time:
   gemma3-1b, h2o-danube-3-4b, chatglm3-6b, minitron-8b, mamba2-130m,
   musicgen-large and paligemma-3b (these two take standard-normal
   embeddings through their stub frontends).  At 2 layers in f32 and
   full width, a prefill of 2 x 128 on the card launching only the
   CUDA-core kernels (``flash_attention`` once a layer, ``ssd`` once a
   layer for mamba2-130m) must equal the port's CPU path on the same
   weights within 1e-3 of each tensor's largest magnitude.  Then in bf16
   at full depth (random weights from ``--seed``): three timed prefills
   of 4 x 2048, each launching ``ZOO``'s count of
   ``flash_attention_sm90`` (gemma3-1b's local layers take the banded
   attention) or ``ssd_sm90`` and no CUDA-core kernel, the time by
   kernel family, then decode: ``ServeLoop`` over 4 sessions for 16
   steps for the token configs, 16 ``decode_step`` calls on embeddings
   at batch 4 for the other two; parameters and peak memory.
6. The four model kernels against their plain versions at the bf16
   prefill's shapes (SSD: 4 x 112 heads, chunks of 128, p = n = 64;
   flash: 4 x 2048, 32 heads of 112): the tensor-core kernels through
   the public wrappers, the CUDA-core kernels on the same bf16 inputs
   through their private launch functions.  The SSD kernels within
   1e-4 of the output's largest magnitude (f32 sums in another order),
   each element of the flash kernels' bf16 output within 2^-7 of its
   magnitude + 2^-12 (one bf16 ulp), with their times, bounds and, for
   flash, ``scaled_dot_product_attention`` as a yardstick, whose share
   of the flash tolerance is logged too (a reading, not a check).  Two
   planted faults must fail those tolerances: the tensor-core flash
   kernel run with the softmax scale of D = 128, and the tensor-core
   SSD kernel with the diagonal u == t left out of its mask.  Then all
   four kernels over a sweep of other shapes in f32 and bf16 (flash in
   f32 within 1e-4), each case logging the kernel that its dtype and
   shape choose.  ``flash_attention_sm90`` also at phase 5b's shape (4 x
   2048, 32 query heads over 8 KV heads of 128, causal, window 4096),
   beside SDPA with ``enable_gqa``, rejecting the scale of D = 64 there;
   both tensor-core kernels beside an empty kernel on their grid.
7. Training.  7a: at phase 6's shapes, the gradient of ``(out *
   w).sum()`` through each of the four model kernels' autograd
   Functions (the kernel forward, the plain version's VJP) equals the
   gradient through the plain version, each input's within the kernel's
   forward tolerance times that gradient's largest magnitude; a wrapper
   that returns the kernel's output detached must fail that.  7b:
   zamba2-7b's first group at full width (6 Mamba2 layers and the
   shared block) in f32, one AdamW ``make_train_step`` on 2 x 128
   ``TokenPipeline`` tokens: the card equals the CPU path on the same
   weights within 1e-3 of each tensor's largest magnitude (loss, grad
   norm, every updated parameter and first moment), launching ``ssd``
   and ``flash_attention`` twice a layer (remat).  7c: zamba2-7b in
   bf16 at full width and as many of its 13 groups as fit beside the
   larger of an 8 GB reserve and a one-group probe's need (16 B a
   parameter; no tail): 1 warm-up and 4 timed AdamW steps of
   ``train_4k``'s 4096-token sequences, 2 a step in 2 microbatches,
   with the step's median, tokens/s, 6 N tokens / 989 TFLOP/s as a share
   of the step, the peak memory and ``ssd_sm90`` / ``flash_attention_sm90``
   launches (2 x microbatches x the layers that run them); losses and
   grad norms finite, every matrix changed.  7d: ``run_training`` at
   zamba2-7b's smoke config on the card, 20 steps with a checkpoint
   every 5 and a falling loss; a run that crashes at step 7 and a new
   one that resumes from 5 within 1e-5 of the uninterrupted losses; the
   checkpoint's bytes and a blocking save's seconds; the last checkpoint
   restored on the CPU path bit-identical to the card's parameters.
8. Meshes and analysis.  8a: one NCCL rank on the card, the production
   axis names ('pod', 'data', 'model') at size 1; phase 7b's step with
   parameters, AdamW state and batch placed as DTensors by
   ``tree_shardings`` / ``opt_state_shardings`` / ``batch_shardings``
   equals the same step unsharded on the card within 1e-3 of each
   tensor's largest magnitude, the wrappers' DTensor branch launching
   ``ssd`` 12 and ``flash_attention`` 2 times; then mixtral-8x7b in bf16
   at 2 layers and full width prefills 2 x 128 tokens through the mesh,
   equal to its unsharded prefill, one ``flash_attention_sm90`` launch
   a layer.  8b (two ranks on the one card) is not run: NCCL refuses
   two ranks on one GPU, and two gloo ranks on cuda:0 run the c10d
   collectives but crash (SIGSEGV in ``wait_tensor``) in the functional
   all-gather DTensor calls.  8c: ``quantize_roundtrip`` on the card equals
   the CPU path bit for bit on 8a's gradient leaves, and 50 compressed
   reductions over the one-rank 'pod' group average to the gradient
   within 2e-3.  8d: the dry-run of zamba2-7b ``train_4k`` and
   mixtral-8x7b ``prefill_32k`` on the 16 x 16 mesh, traced on the host
   over a fake process group of 256 by ``python -m
   repro_torch.launch.dryrun``, one process a cell, started after phase
   4 and run (niced, no card) while the card takes phases 5-8c: their
   table rows (model estimates from the data sheet) and seconds.  8e
   (on phase 2's store, after its lookups): 3 lookup batches under the
   tracer, the exported Chrome
   trace read by ``analysis.report``: wall, perfect-overlap bound, gap,
   per-shard busy and stall, and ``cascade_sm90`` launches a lookup
   equal to the kernel counters'.

The line before the last is the kernels' JSON record, the one before
it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak, same sheet
SECTOR = 32
UNIVERSE = 1 << 28
PUT_BATCH = 8192
RANGES_PER_BATCH = 82
RANGE_LEN = 256
LOOKUP_BATCHES = 64
LOOKUP_BATCH = 8192
STORE_KEYS = 3_000_000  # the store cell's puts (the reference's MAX_PACK_*)
KERNEL_SOURCES = {
    "merge_rank": ("src/repro_torch/csrc/merge_rank.cu",
                   "src/repro/kernels/merge/kernel.py:53"),
    "ssd": ("src/repro_torch/csrc/ssd.cu",
            "src/repro/kernels/ssd/kernel.py:49"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:82"),
    "ssd_sm90": ("src/repro_torch/csrc/ssd_sm90.cu",
                 "src/repro/kernels/ssd/kernel.py:49"),
    "flash_attention_sm90": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention/kernel.py:82"),
    "cascade_sm90": ("src/repro_torch/csrc/cascade_sm90.cu",
                     "src/repro/kernels/cascade/kernel.py:125"),
    "merge_path_sm90": ("src/repro_torch/csrc/merge_path_sm90.cu",
                        "src/repro/kernels/merge/kernel.py:53"),
    "bloom_sm90": ("src/repro_torch/csrc/bloom_sm90.cu",
                   "src/repro/kernels/bloom/kernel.py:52"),
    "interval_sm90": ("src/repro_torch/csrc/interval_sm90.cu",
                      "src/repro/kernels/interval/kernel.py:61"),
}
FILTER_KEYS = 3_000_000  # the 3 M-key filter of ROADMAP A2's shard
BITS_PER_KEY, HASHES = 10, 6  # the paper's filter (LSMConfig's defaults)
BIG_LEVEL = 1 << 20  # areas of the large DR-tree level


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def timed(what: str):
    """Log the wall seconds of a phase that does not log its own."""
    t0 = time.perf_counter()
    yield
    log(f"{what}: {time.perf_counter() - t0:.3f} s")


# ------------------------------------------------------------ workload
def make_stream(seed: int, n_keys: int):
    """Put keys (value = key + 1) in batches, and after each batch its
    range deletes' low bounds."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, UNIVERSE, n_keys, dtype=np.uint64)
    n_batches = -(-n_keys // PUT_BATCH)
    los = rng.integers(0, UNIVERSE - RANGE_LEN,
                       (n_batches, RANGES_PER_BATCH), dtype=np.uint64)
    return keys, los


def make_lookups(seed: int, keys: np.ndarray, batches: int,
                 size: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(batches):
        loaded = keys[rng.integers(0, len(keys), size // 2)]
        uniform = rng.integers(0, UNIVERSE, size - size // 2,
                               dtype=np.uint64)
        out.append(rng.permutation(np.concatenate([loaded, uniform])))
    return out


def model_lookup(keys: np.ndarray, los: np.ndarray, q: np.ndarray):
    """Plain model of the op stream: a key is live iff its last put came
    after every range delete covering it.  Put batch b precedes the
    range deletes issued after it, so a delete of batch b' kills a put
    of batch b iff b' >= b."""
    batch_of = np.arange(len(keys)) // PUT_BATCH
    order = np.argsort(keys, kind="stable")
    sk, sb = keys[order], batch_of[order]
    last = np.r_[sk[1:] != sk[:-1], True]
    uk, ub = sk[last], sb[last]
    j = np.minimum(np.searchsorted(uk, q), len(uk) - 1)
    put = uk[j] == q
    put_batch = np.where(put, ub[j], -1)
    flat = los.reshape(-1)
    rd_batch = np.repeat(np.arange(los.shape[0]), los.shape[1])
    o = np.argsort(flat, kind="stable")
    slo, sbatch = flat[o], rd_batch[o]
    qi = q.astype(np.int64)
    a = np.searchsorted(slo, np.maximum(qi - (RANGE_LEN - 1), 0)
                        .astype(np.uint64))
    b = np.searchsorted(slo, q, side="right")
    killed_by = np.full(len(q), -1)
    for i in np.flatnonzero(b > a):
        killed_by[i] = sbatch[a[i]:b[i]].max()
    found = put & (killed_by < put_batch)
    return found, np.where(found, q + np.uint64(1), np.uint64(0))


def load(eng, keys: np.ndarray, los: np.ndarray):
    """The op stream: each put batch, then its range deletes.  Returns
    the wall seconds and each put batch's latency."""
    t0 = time.perf_counter()
    put_lat = []
    for b in range(los.shape[0]):
        k = keys[b * PUT_BATCH:(b + 1) * PUT_BATCH]
        t1 = time.perf_counter()
        eng.put_batch(k, k + np.uint64(1))
        put_lat.append(time.perf_counter() - t1)
        range_deletes(eng, los[b])
    return time.perf_counter() - t0, put_lat


def range_deletes(eng, lo: np.ndarray) -> None:
    eng.range_delete_batch(list(zip(lo.tolist(), (lo + RANGE_LEN).tolist())))


def lookups(eng, batches: list[np.ndarray]):
    results, lat = [], []
    for q in batches:
        t0 = time.perf_counter()
        found, vals = eng.get_batch(q)
        lat.append(time.perf_counter() - t0)
        results.append((found, vals))
    return results, lat


def check_results(results, batches, keys, los) -> None:
    for (found, vals), q in zip(results, batches):
        mf, mv = model_lookup(keys, los, q)
        # Values of keys not found are unspecified, as in the reference.
        wrong = (found != mf) | (found & (vals != mv))
        if wrong.any():
            bad = int(np.flatnonzero(wrong)[0])
            raise AssertionError(
                f"lookup of key {int(q[bad])}: engine ({found[bad]}, "
                f"{int(vals[bad])}) vs model ({mf[bad]}, {int(mv[bad])})")


# -------------------------------------------------------------- timing
def time_kernel_ms(fn, reps: int = 30) -> float:
    """Median device time of one launch: a sleep kernel holds the card
    while the host enqueues every launch between event pairs, so host
    overhead does not show as device time."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def time_host_ms(fn, reps: int = 10) -> float:
    """Median wall time of a call that synchronizes with the host (the
    plain versions read metadata back), ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return float((a.to(b.dtype) - b).abs().max().item()) if a.numel() else 0.0


def allowance_used(got, want, atol: float, rtol: float = 0.0) -> float:
    """The largest ``|got - want| / (atol + rtol * |want|)`` over the
    elements: at most 1 is within tolerance.  With ``rtol`` 0 the error
    is taken in ``want``'s own type, so integers compare exactly, and
    both 0 is bit-exact (0 or inf)."""
    if isinstance(got, tuple):
        return max(allowance_used(x, y, atol, rtol)
                   for x, y in zip(got, want))
    if not rtol:
        err = max_abs_err(got, want)
        return err / atol if atol else (0.0 if err == 0 else math.inf)
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def search_sectors(cnt: int, n: int) -> int:
    """Distinct 32-byte sectors n binary searches over cnt sorted u32
    touch below the levels they share: about log2(cnt / n) each, the
    last three halvings falling in one sector."""
    return n * max(1, int(np.ceil(np.log2(max(cnt, 2) / max(n, 1)))) - 2)


def bloom_probe_counts(hash32, words, m_bits, seeds) -> int:
    """Word reads a Bloom probe that stops at its first unset bit makes
    over these queries."""
    from repro_torch.core.eve import mix32
    n = len(hash32)
    alive = np.ones(n, bool)
    reads = 0
    for s in seeds:
        reads += int(alive.sum())
        p = mix32(hash32, s) % np.uint32(m_bits)
        bit = (words[(p >> np.uint32(5)).astype(np.int64)]
               >> (p & np.uint32(31))) & np.uint32(1)
        alive &= bit == 1
    return reads


# -------------------------------------------------------------- phases
def environment() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi, torch.cuda.get_device_name(0)


def build_engine(shards: int, device: str, **config):
    """The store's configuration: GLORAN, the paper's ``LSMConfig``, the
    EVE over the key universe; ``config`` sets ``EngineConfig`` fields."""
    from repro_torch.core import GloranConfig, RAEConfig
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.lsm import LSMConfig
    return Engine(num_shards=shards, strategy="gloran",
                  lsm_config=LSMConfig(),
                  gloran_config=GloranConfig(
                      eve=RAEConfig(key_universe=UNIVERSE)),
                  config=EngineConfig(device=device, **config))


def build_slice(n_keys: int, shards: int, seed: int, device: str,
                **config):
    keys, los = make_stream(seed, n_keys)
    return build_engine(shards, device, **config), keys, los


def tail_deletes(eng, los: np.ndarray) -> np.ndarray:
    """Range deletes (82 a batch, no puts) until every shard's GLORAN
    index holds a DR-tree level with areas again; returns the low
    bounds of the whole stream."""
    tail = []
    while not all(len(l) for sh in eng.shards
                  for l in sh.tree.gloran.level_views()):
        assert len(tail) < 200, "index never flushed"
        lo = np.random.default_rng(1000 + len(tail)).integers(
            0, UNIVERSE - RANGE_LEN, RANGES_PER_BATCH, dtype=np.uint64)
        range_deletes(eng, lo)
        tail.append(lo)
    return np.concatenate([los, np.stack(tail)]) if tail else los


def report_lookups(tag, lat, card) -> None:
    total = sum(lat)
    ms = sorted(1e3 * x for x in lat)
    log(f"{tag}: {len(lat)} x {LOOKUP_BATCH} keys in {total:.3f} s = "
        f"{len(lat) * LOOKUP_BATCH / total:.1f} ops/s; batch p50 "
        f"{statistics.median(ms):.3f} ms, p99 "
        f"{ms[int(0.99 * (len(ms) - 1))]:.3f} ms {card}")


def check_cascade_path(eng, kc0, kc1, launches: int, shards) -> list:
    """Every shard sub-batch took exactly one ``cascade_sm90`` launch
    (``launches``: the window's count); returns the shards' cascade
    views."""
    sub_batches = LOOKUP_BATCHES * shards
    calls = kc1.cascade_calls - kc0.cascade_calls
    assert calls == sub_batches == launches, (calls, sub_batches, launches)
    views = [sh.registry.view(sh.tree) for sh in eng.shards]
    assert all(v is not None and v.state.G >= 1 for v in views), views
    return views


def device_busy(eng, batches, run=None) -> str:
    """Device time of the kernels over a few batches (lookups, or
    ``run(eng, batches)``), from the profiler, against the wall time of
    those batches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (run or lookups)(eng, batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0]
    if not events:
        return "device time not measured (the profiler saw no kernels)"
    busy = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:4]
    return (f"{len(batches)} batches: wall {wall_us:.1f} us, device busy "
            f"{busy:.1f} us ({100 * busy / wall_us:.3f}%); "
            + "; ".join(f"{e.key[:40]} {e.device_time_total:.1f} us / "
                        f"{e.count}" for e in top))


def latency_ms(lat: list) -> str:
    ms = sorted(1e3 * x for x in lat)
    return (f"{len(ms)} put batches p50 {statistics.median(ms):.3f} ms, "
            f"p99 {ms[int(0.99 * (len(ms) - 1))]:.3f} ms")


def structure(eng) -> dict:
    """Every shard's level shapes, ``seq`` and ``num_entries``."""
    return {"levels": [[len(l) if l is not None else 0
                        for l in sh.tree.levels] for sh in eng.shards],
            "seq": [int(sh.tree.seq) for sh in eng.shards],
            "entries": [int(sh.tree.num_entries) for sh in eng.shards]}


def store_snapshot(eng) -> dict:
    """What two stores fed the same op stream must share at a point of
    it: their structure, every shard's ``IOStats``, the kernel
    counters."""
    return {**structure(eng),
            "io": [sh.tree.io.snapshot() for sh in eng.shards],
            "kernels": eng.kernel_counters.snapshot()}


def assert_same_snapshot(got: dict, want: dict, where: str,
                         what: str = "scheduler store") -> None:
    for key in want:
        if got[key] != want[key]:
            raise AssertionError(f"{what} differs from the inline one in "
                                 f"{key} {where}: {got[key]} vs "
                                 f"{want[key]}")


# ---------------------------------------------------------- range scans
SCAN_MIXES = {  # name: (batches, scans a batch, width)
    "slabs": (8, 1024, 1 << 16),  # SessionRegistry.live_pages' slab
    "long": (8, 64, 1 << 20),
}
# Batches of each mix that recovered and procs stores scan: enough to
# compare digests, few enough for the script's time limit.
RECOVERED_SCAN_BATCHES = 2


def live_keys(keys: np.ndarray, los: np.ndarray) -> np.ndarray:
    """The plain model's sorted live keys after the op stream (each
    holding its key + 1), made like ``model_lookup``."""
    uk = np.unique(keys)
    found, _ = model_lookup(keys, los, uk)
    return uk[found]


def make_scans(seed: int, batches: int, size: int, width: int) -> list:
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, UNIVERSE - width, (batches, size), dtype=np.uint64)
    return [list(zip(b.tolist(), (b + width).tolist())) for b in lo]


def check_scans(res, ranges, live: np.ndarray) -> int:
    """Each scan equals the model's live keys in [lo, hi) with their
    values; returns the entries."""
    entries = 0
    for (k, v), (lo, hi) in zip(res, ranges):
        a, b = np.searchsorted(live, [lo, hi])
        want = live[a:b]
        if not (np.array_equal(k, want) and np.array_equal(
                v, want + np.uint64(1))):
            raise AssertionError(f"scan [{lo}, {hi}): {len(k)} entries vs "
                                 f"the model's {len(want)}")
        entries += len(k)
    return entries


def scan_digest(res) -> str:
    h = hashlib.sha256()
    for k, v in res:
        h.update(np.int64(len(k)).tobytes())
        h.update(k.tobytes())
        h.update(v.tobytes())
    return h.hexdigest()


def reset_counts(eng) -> None:
    """Zero the launch counts of every process that runs ``eng``'s
    kernels: this one, and in procs mode each worker."""
    from repro_torch.kernels import native
    native.reset_launches()
    if eng.procs:
        eng._proc_pool.reset_launches()


def counts(eng) -> dict:
    """The launch counts since ``reset_counts``: this process's, or in
    procs mode the workers' summed (this process launched nothing)."""
    from repro_torch.kernels import native
    if not eng.procs:
        return dict(native.LAUNCHES)
    assert not any(native.LAUNCHES.values()), \
        f"the parent of a procs store launched {native.LAUNCHES}"
    return eng._proc_pool.launches()


def shard_io(eng) -> list:
    """Every shard's ``IOStats`` snapshot (a procs store's from its
    workers' STATS replies)."""
    if eng.procs:
        return [sh.stats_full()["io"] for sh in eng.shards]
    return [sh.tree.io.snapshot() for sh in eng.shards]


def scan_mix(eng, name: str, batches: list, live, card) -> dict:
    """One mix's batches through ``Engine.range_scan_batch``, each held
    to the model; the window's launches must be ``merge_path_sm90`` and
    ``interval_sm90`` only, as many as the gated calls."""
    io0 = shard_io(eng)
    kc0 = eng.kernel_counters
    reset_counts(eng)
    lat, digests, entries = [], [], 0
    for b in batches:
        t0 = time.perf_counter()
        res = eng.range_scan_batch(b)
        lat.append(time.perf_counter() - t0)
        entries += check_scans(res, b, live)
        digests.append(scan_digest(res))
    launches = counts(eng)
    kc1 = eng.kernel_counters
    calls = {"merge_path_sm90": kc1.merge_calls - kc0.merge_calls,
             "interval_sm90": kc1.interval_calls - kc0.interval_calls}
    others = {k: v for k, v in launches.items() if v and k not in calls}
    assert not others, f"scans launched {others}"
    assert all(launches[k] == v for k, v in calls.items()), (launches,
                                                             calls)
    n = sum(len(b) for b in batches)
    total = sum(lat)
    ms = sorted(1e3 * x for x in lat)
    log(f"scans {name}: {len(batches)} batches of {len(batches[0])} "
        f"(width {batches[0][0][1] - batches[0][0][0]}), {entries} entries "
        f"({entries / n:.1f} a scan) in {total:.3f} s = {n / total:.1f} "
        f"scans/s, {entries / total:.1f} entries/s; batch p50 "
        f"{statistics.median(ms):.3f} ms, p99 "
        f"{ms[int(0.99 * (len(ms) - 1))]:.3f} ms; launches a batch "
        f"{json.dumps({k: v / len(batches) for k, v in calls.items()})}; "
        f"merge keys {kc1.merge_keys - kc0.merge_keys}, interval stabs "
        f"{kc1.interval_queries - kc0.interval_queries}; results equal the "
        f"model {card}")
    io1 = shard_io(eng)
    k0 = kc0.snapshot()
    return {"digests": digests, "launches": calls,
            "io": [{k: b[k] - a[k] for k in ("reads", "writes")}
                   for a, b in zip(io0, io1)],
            "kernels": {k: v - k0[k] for k, v in kc1.snapshot().items()
                        if isinstance(v, int)}}


def capture_stabs(eng, ranges) -> list:
    """The interval kernel's inputs of one scan batch, as the executors
    hand them over (outside every counted window)."""
    from repro_torch.engine import executor
    stabs = []
    real = executor.interval_query

    def spy(*args):
        stabs.append(args)
        return real(*args)

    executor.interval_query = spy
    try:
        eng.range_scan_batch(ranges)
    finally:
        executor.interval_query = real
    return stabs


def scan_profile(eng, ranges, top: int = 6) -> str:
    """Where one scan batch's host time goes: the batch run serially on
    this thread under cProfile (which inflates Python calls), the
    functions with the most own time."""
    import cProfile
    import pstats
    from repro_torch.engine import OpBatch
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(lambda: eng.submit(OpBatch.range_scans(ranges),
                                    pipeline=False).scan_results())
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return (f"profiled serial wall {wall:.3f} s; own time: " + "; ".join(
        f"{Path(f).name}:{ln}({fn}) {tt:.3f} s / {nc}"
        for (f, ln, fn), (_, nc, tt, _, _) in rows))


@contextlib.contextmanager
def gates_lowered(eng):
    """The interval gates at 1, as phase 3 sets them, for a while."""
    saved = eng.config.kernel_min_batch, eng.config.kernel_min_areas
    eng.config.kernel_min_batch = eng.config.kernel_min_areas = 1
    try:
        yield
    finally:
        eng.config.kernel_min_batch, eng.config.kernel_min_areas = saved


def scan_phase(eng, live: np.ndarray, card: str) -> dict:
    """Phase 2b: both scan mixes on the store at the default gates (a
    second pass with the gates lowered only if no interval launch came),
    the device's busy share and a host profile of one batch per mix, and
    the interval kernel's captured sub-batches."""
    mixes = {name: make_scans(2000 + i, *spec)
             for i, (name, spec) in enumerate(SCAN_MIXES.items())}
    out = {"mixes": {}, "stabs": [], "batches": mixes,
           "launches": {"merge_path_sm90": 0, "interval_sm90": 0}}
    for name, batches in mixes.items():
        mix = scan_mix(eng, name, batches, live, card)
        out["mixes"][name] = mix
        for k, v in mix["launches"].items():
            out["launches"][k] += v
    lowered = not out["launches"]["interval_sm90"]
    if lowered:
        with gates_lowered(eng):
            for name, batches in mixes.items():
                mix = scan_mix(eng, f"{name}, gates lowered", batches, live,
                               card)
                for k, v in mix["launches"].items():
                    out["launches"][k] += v
        log("the default gates gave interval_sm90 no scan launch; the "
            f"lowered-gate pass launched it "
            f"{out['launches']['interval_sm90']} times")
    for name, batches in mixes.items():
        with gates_lowered(eng) if lowered else contextlib.nullcontext():
            stabs = capture_stabs(eng, batches[0])
        out["stabs"] += stabs
        ns = sorted(x[0].numel() for x in stabs)
        log(f"scans {name}: {len(stabs)} interval sub-batches in batch 0, n "
            f"{ns[:1]}..{ns[-1:]}, areas "
            f"{sorted({x[2].numel() for x in stabs})}")
        log(f"scans {name}, device: " + device_busy(
            eng, batches[1:3], run=lambda e, bs: [e.range_scan_batch(b)
                                                  for b in bs]))
        log(f"scans {name}, host: " + scan_profile(eng, batches[3]))
    assert out["stabs"], "no interval sub-batch to time"
    return out


def scan_interval_times(eng, stabs, card) -> dict:
    """``interval_sm90`` bit-exact against the plain version on every
    captured scan sub-batch, then timed: rotated over them all, and on
    the smallest, median and largest, each beside the launch floor and
    its bytes bound."""
    from repro_torch.kernels.interval import ops as iops
    from repro_torch.kernels.interval.ops import interval_query
    from repro_torch.kernels.interval.ref import interval_query_ref
    for x in stabs:
        assert same(interval_query(*x), interval_query_ref(*x)), \
            "interval_sm90 on a scan"
    order = sorted(stabs, key=lambda x: x[0].numel())
    times = {"rotated": time_kernel_ms(rotate(interval_query, stabs))}
    for tag, x in (("smallest", order[0]), ("median", order[len(order) // 2]),
                   ("largest", order[-1])):
        n, m = x[0].numel(), x[2].numel()
        t = {"ms": time_kernel_ms(lambda: interval_query(*x))}
        t["floor"] = time_kernel_ms(lambda: iops._launch_floor(n, x[0].device))
        by = 12 * n + SECTOR * (min(search_sectors(m, n), m // 8 + 1) + 3 * n)
        t.update(n=n, areas=m, bound=by / HBM_BYTES_PER_S * 1e3)
        times[tag] = t
    ns = [x[0].numel() for x in order]
    log(f"interval_sm90 on the scans' {len(stabs)} captured sub-batches (n "
        f"{ns[0]}..{ns[-1]}, median {ns[len(ns) // 2]}), bit-exact; ms: "
        f"{json.dumps(times)} {card}")
    return times


def scheduler_phase(keys, los, tail, batches, live, inline, scans,
                    card) -> dict:
    """Phase 2c: a second store with ``scheduler=True`` takes the same
    load, lookups, tail deletes and scan mixes; its level shapes,
    ``IOStats``, kernel counters, lookup results and scan results must
    equal the inline store's at each point, and every launch be a Hopper
    kernel, as many as the gated calls.  Returns its launches."""
    from repro_torch.kernels import native
    eng, _, _ = build_slice(len(keys), 8, 0, "cuda", scheduler=True)
    native.reset_launches()
    load_s, put_lat = load(eng, keys, los)
    eng.drain()
    assert_same_snapshot(store_snapshot(eng), inline["load"],
                         "after the load")
    n_ops = len(keys) + los.size
    sched = eng.stats()["sched"]
    log(f"load, scheduler on: {load_s:.3f} s = {n_ops / load_s:.1f} ops/s; "
        f"{latency_ms(put_lat)}; sched {json.dumps(sched)} {card}")
    log(f"load, scheduler off: {inline['load_s']:.3f} s = "
        f"{n_ops / inline['load_s']:.1f} ops/s; "
        f"{latency_ms(inline['put_lat'])} {card}")
    first, _ = lookups(eng, batches)
    for lo in tail:
        range_deletes(eng, lo)
    second, lat = lookups(eng, batches)
    for got, want in zip(first + second, inline["results"][0]
                         + inline["results"][1]):
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), \
            "scheduler store's lookups differ from the inline store's"
    assert_same_snapshot(store_snapshot(eng), inline["lookups"],
                         "after the lookups")
    report_lookups("lookups, scheduler on (results equal the inline "
                   "store's)", lat, card)
    lookup_launches = dict(native.LAUNCHES)  # the load's and lookups'
    for name, mix in scans["mixes"].items():
        got = scan_mix(eng, f"{name}, scheduler on", scans["batches"][name],
                       live, card)
        for key in ("digests", "io", "kernels"):
            assert got[key] == mix[key], \
                f"scheduler store's {name} scans differ in {key}"
    launches = dict(native.LAUNCHES)
    launches = {k: lookup_launches[k] + launches[k] for k in launches}
    kc = eng.kernel_counters
    assert launches["merge_path_sm90"] == kc.merge_calls > 0 and \
        launches["merge_rank"] == 0, (launches, kc)
    assert launches["cascade_sm90"] == kc.cascade_calls, (launches, kc)
    assert not {k: v for k, v in launches.items() if v and k not in (
        "merge_path_sm90", "cascade_sm90", "interval_sm90")}, launches
    sched = eng.stats()["sched"]
    assert sched["flush_jobs"] > 0 and sched["compaction_debt"] == 0, sched
    log(f"scheduler store equals the inline store (level shapes, IOStats, "
        f"kernel counters, lookups, both scan mixes); its launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; sched "
        f"{json.dumps(sched)}")
    eng.close()
    return launches


# ----------------------------------------------------------- durability
def expect_launches(launches: dict, calls: dict, what: str) -> None:
    """A window's launches are exactly the gated calls: the kernels named
    in ``calls``, as many times each, and nothing else."""
    got = {k: v for k, v in launches.items() if v}
    want = {k: v for k, v in calls.items() if v}
    assert got == want, f"{what}: launches {got}, gated calls {want}"


def fs_type(path: str) -> str:
    out = subprocess.run(["df", "-T", path], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out[-1].split()[1]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def tear_last_frame(wal_dir: str, shard: int) -> str:
    """Cut the shard's newest segment that holds a frame in the middle of
    its last frame (a crash mid-append); returns what was cut."""
    from repro_torch.durable.wal import FRAME_HEADER, SEG_HEADER, shard_dir
    sdir = shard_dir(wal_dir, shard)
    for name in sorted(os.listdir(sdir), reverse=True):
        path = os.path.join(sdir, name)
        with open(path, "rb") as f:
            data = f.read()
        at, last = SEG_HEADER.size, None
        while at + FRAME_HEADER.size <= len(data):
            last = at
            at += FRAME_HEADER.size + FRAME_HEADER.unpack_from(data, at)[0]
        if last is not None:
            cut = (last + at) // 2
            with open(path, "r+b") as f:
                f.truncate(cut)
            return (f"{name} cut at byte {cut} of {len(data)} (its last "
                    f"frame spans bytes {last}..{at})")
    raise AssertionError(f"shard {shard} holds no frame")


def durable_store(wal: str, keys, los, tail, batches, inline, card) -> dict:
    """The live durable store: the inline store's stream on a store with a
    WAL (fsync a batch) and a snapshot after the load, held to the inline
    store; returns its launches and its WAL frames a shard."""
    from repro_torch.durable import take_snapshot
    from repro_torch.kernels import native
    eng, _, _ = build_slice(len(keys), 8, 0, "cuda", wal_dir=wal,
                            fsync="batch")
    native.reset_launches()
    load_s, put_lat = load(eng, keys, los)
    assert_same_snapshot(store_snapshot(eng), inline["load"],
                         "after the load", "durable store")
    n_ops = len(keys) + los.size
    log(f"load, durable (fsync a batch, WAL on {fs_type(wal)}): {load_s:.3f} "
        f"s = {n_ops / load_s:.1f} ops/s; {latency_ms(put_lat)}; inline: "
        f"{inline['load_s']:.3f} s = {n_ops / inline['load_s']:.1f} ops/s; "
        f"{latency_ms(inline['put_lat'])} {card}")
    t0 = time.perf_counter()
    snap = take_snapshot(eng)
    snap_s = time.perf_counter() - t0
    snap_frames = [sh.wal.frames_appended for sh in eng.shards]
    log(f"snapshot after the load: {snap_s:.3f} s, {dir_bytes(snap)} B "
        f"({os.path.basename(snap)}, covers {sum(snap_frames)} frames) {card}")
    first, _ = lookups(eng, batches)
    for lo in tail:
        range_deletes(eng, lo)
    second, lat = lookups(eng, batches)
    for got, want in zip(first + second, inline["results"][0]
                         + inline["results"][1]):
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), \
            "durable store's lookups differ from the inline store's"
    assert_same_snapshot(store_snapshot(eng), inline["lookups"],
                         "after the lookups", "durable store")
    report_lookups("lookups, durable store (results equal the inline "
                   "store's)", lat, card)
    kc = eng.kernel_counters
    calls = {"merge_path_sm90": kc.merge_calls,
             "cascade_sm90": kc.cascade_calls}
    expect_launches(native.LAUNCHES, calls, "durable store")
    wal_counters = eng.stats()["wal"]
    frames = [sh.wal.frames_appended for sh in eng.shards]
    eng.close()
    log(f"durable store equals the inline store (level shapes, IOStats, "
        f"kernel counters, lookups); launches {json.dumps(calls)}; wal "
        f"{json.dumps(wal_counters)} (frames a shard {frames}) {card}")
    return {"launches": calls, "frames": frames, "snap_frames": snap_frames,
            "load_s": load_s, "put_lat": put_lat}


def recovered(tag: str, rec, want: dict, batches, scans, live, card,
              model=None) -> dict:
    """A recovered store held to ``want`` (structure and lookup results,
    and with ``scans`` both mixes' digests; with ``model`` the lookups
    also to the plain model): its launches and what it served.  A procs
    store's structure is its workers' "recover" level records."""
    got = proc_structure(rec) if rec.procs else structure(rec)
    assert_same_snapshot(got, want["structure"], "after recovery", tag)
    kc0 = rec.kernel_counters
    reset_counts(rec)
    results, lat = lookups(rec, batches)
    kc1 = rec.kernel_counters
    calls = kc1.cascade_calls - kc0.cascade_calls
    assert calls == rec.num_shards * len(batches), (tag, calls)
    expect_launches(counts(rec), {"cascade_sm90": calls},
                    f"{tag} lookups")
    for (f, v), (wf, wv) in zip(results, want["results"]):
        assert np.array_equal(f, wf) and np.array_equal(v[f], wv[wf]), \
            f"{tag}: lookups differ"
    if model is not None:
        check_results([tuple(np.concatenate(c) for c in zip(*results))],
                      [np.concatenate(batches)], *model)
    log(f"lookups, {tag}: first batch {1e3 * lat[0]:.3f} ms (it re-packs "
        f"the registry: {kc1.cascade_packs - kc0.cascade_packs} packs, "
        f"{kc1.upload_bytes - kc0.upload_bytes} B uploaded over the "
        f"{len(lat)} batches); results equal"
        f"{' the model and' if model is not None else ''} the expected "
        f"store's")
    report_lookups(f"lookups, {tag}, batches 2-{len(lat)}", lat[1:], card)
    out = {"structure": got, "results": results, "cascade_sm90": calls,
           "merge_path_sm90": 0, "interval_sm90": 0}
    for name, mix in (scans["mixes"].items() if scans else ()):
        res = scan_mix(rec, f"{name}, {tag}", scans["batches"][name], live,
                       card)
        assert res["digests"] == mix["digests"], f"{tag}: {name} scans"
        for k, v in res["launches"].items():
            out[k] += v
    return out


def recover_checked(wal: str, tag: str, **kw):
    """``recover`` with the default config (the card), its launches held
    to the gated merges of the replay."""
    from repro_torch.durable import recover
    from repro_torch.kernels import native
    native.reset_launches()
    rec = recover(wal, **kw)
    merges = rec.kernel_counters.merge_calls
    expect_launches(native.LAUNCHES, {"merge_path_sm90": merges}, tag)
    r = rec.recovery
    log(f"recovery, {tag}: {r['wall_s']:.3f} s, {r['frames_replayed']} "
        f"frames replayed = {r['frames_replayed'] / r['wall_s']:.1f} "
        f"frames/s, snapshot loaded {r['snapshot_loaded']}, "
        f"merge_path_sm90 launches {merges}")
    return rec, merges


def first_batches(scans: dict, n: int) -> dict:
    """Phase 2b's scan mixes cut to their first ``n`` batches."""
    return {"batches": {k: b[:n] for k, b in scans["batches"].items()},
            "mixes": {k: {"digests": m["digests"][:n]}
                      for k, m in scans["mixes"].items()}}


def durable_phase(keys, los, tail, batches, live, inline, scans,
                  card) -> tuple[dict, dict]:
    """Phase 2d: the durable store and its three recoveries, in a
    temporary directory removed at the end (also on failure); returns
    the launches by path for each kernel, and the durable store's load
    and full-replay times."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    try:
        out = durable_checks(root, keys, los, tail, batches, live, inline,
                             scans, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 2d: {time.perf_counter() - t0:.3f} s")
    return out


def durable_checks(root, keys, los, tail, batches, live, inline, scans,
                   card) -> dict:
    """The durable store under ``root``, then ``recover`` by full replay,
    from the snapshot plus the tail, and of a copy with a torn frame.
    The recovered stores scan the first ``RECOVERED_SCAN_BATCHES``
    batches of each mix."""
    from repro_torch.durable import WalReader, replay_frame
    from repro_torch.kernels import native
    wal = os.path.join(root, "wal")
    live_store = durable_store(wal, keys, los, tail, batches, inline, card)
    frames, snap_frames = live_store["frames"], live_store["snap_frames"]
    los_all = np.concatenate([los, tail])
    scans = first_batches(scans, RECOVERED_SCAN_BATCHES)

    # The full log, then the snapshot plus the WAL tail.
    rec, full_merges = recover_checked(wal, "full replay",
                                       use_snapshot=False)
    assert rec.recovery["snapshot_loaded"] == 0
    assert rec.recovery["frames_replayed"] == sum(frames)
    replay_s = rec.recovery["wall_s"]
    want = {"structure": {k: inline["lookups"][k]
                          for k in ("levels", "seq", "entries")},
            "results": inline["results"][1]}
    full = recovered("full replay", rec, want, batches, scans, live, card,
                     model=(keys, los_all))
    rec.close()
    rec, snap_merges = recover_checked(wal, "snapshot + tail")
    assert rec.recovery["snapshot_loaded"] == 1
    assert rec.recovery["frames_replayed"] == sum(frames) - sum(snap_frames)
    snap = recovered("snapshot + tail", rec, full, batches, scans, live,
                     card)
    rec.close()

    # A crash mid-append: shard 0 loses half of its last frame.
    torn_dir = os.path.join(root, "torn")
    shutil.copytree(wal, torn_dir)
    log(f"torn tail: shard 0's {tear_last_frame(torn_dir, 0)}")
    rec, torn_merges = recover_checked(torn_dir, "torn tail")
    # The snapshot stands while shard 0's torn frame came after it (a
    # tail delete); one that covers the lost frame is discarded.
    after = snap_frames[0] < frames[0]
    assert rec.recovery["snapshot_loaded"] == int(after)
    assert rec.recovery["frames_replayed"] == \
        sum(frames) - (sum(snap_frames) if after else 0) - 1
    survived = [len(WalReader(torn_dir, s).read_frames())
                for s in range(len(frames))]
    assert survived == [frames[0] - 1] + frames[1:], survived
    native.reset_launches()
    ref = build_engine(1, "cuda")
    t0 = time.perf_counter()
    for fr in WalReader(torn_dir, 0).read_frames():
        replay_frame(ref.shards[0], fr)
    ref_s = time.perf_counter() - t0
    ref_merges = ref.kernel_counters.merge_calls
    expect_launches(native.LAUNCHES, {"merge_path_sm90": ref_merges},
                    "shard 0's reference replay")
    log(f"shard 0's reference: {survived[0]} frames replayed into a "
        f"one-shard store in {ref_s:.3f} s; merge_path_sm90 launches "
        f"{ref_merges}")
    sub_batches = [q[rec.router.shard_of(q) == 0] for q in batches]
    native.reset_launches()
    kc0 = ref.kernel_counters
    ref_results, _ = lookups(ref, sub_batches)
    ref_lookups = ref.kernel_counters.cascade_calls - kc0.cascade_calls
    expect_launches(native.LAUNCHES, {"cascade_sm90": ref_lookups},
                    "shard 0's reference lookups")
    ref_struct = structure(ref)
    want = {"structure": {k: ref_struct[k][:1] + v[1:]
                          for k, v in full["structure"].items()},
            "results": []}
    for q, (f, v), (rf, rv) in zip(batches, full["results"], ref_results):
        m = rec.router.shard_of(q) == 0
        f, v = f.copy(), v.copy()
        f[m], v[m] = rf, rv
        want["results"].append((f, v))
    torn = recovered("torn tail", rec, want, batches, None, live, card)
    rec.close()
    ref.close()
    log("torn tail: shard 0 replayed one frame fewer and equals the "
        "one-shard store of its surviving frames (level shapes, seq, "
        "entries, lookups); shards 1-7 equal the full replay")

    timing = {"load_s": live_store["load_s"],
              "put_lat": live_store["put_lat"], "replay_s": replay_s}
    return {
        "merge_path_sm90": {
            "durable store": live_store["launches"]["merge_path_sm90"],
            "recovery": full_merges + snap_merges + torn_merges,
            "recovered scans": full["merge_path_sm90"]
            + snap["merge_path_sm90"],
            "torn-tail reference": ref_merges},
        "cascade_sm90": {
            "durable store": live_store["launches"]["cascade_sm90"],
            "recovered lookups": sum(x["cascade_sm90"]
                                     for x in (full, snap, torn)),
            "torn-tail reference": ref_lookups},
        "interval_sm90": {
            "recovered scans": full["interval_sm90"]
            + snap["interval_sm90"]}}, timing


# ----------------------------------------------------- worker processes
PROCS = 4  # workers of the procs store: two shards each, all on cuda:0


def level_records(descs: list) -> list:
    """Manifest level records less what differs between processes or
    moves between edits: run uids (a per-process counter) and the
    tree's ``seq`` (recorded at the last structural edit)."""
    out = []
    for d in descs:
        d = {k: v for k, v in d.items() if k != "seq"}
        d["levels"] = [None if l is None else
                       {k: v for k, v in l.items() if k != "uid"}
                       for l in d["levels"]]
        out.append(d)
    return out


def described(eng) -> list:
    """``describe_tree`` of every shard of an in-process store."""
    from repro_torch.durable.manifest import describe_tree
    return [describe_tree(sh.tree) for sh in eng.shards]


def proc_snapshot(eng) -> dict:
    """What the parent of a procs store sees of it: each shard's entries
    and ``IOStats`` from its worker's STATS reply, the kernel counters,
    and the level records the workers shipped into the manifest."""
    fulls = [sh.stats_full() for sh in eng.shards]
    descs = [eng.manifest.shard_record(s) for s in range(eng.num_shards)]
    return {"levels": [[l["n"] if l else 0 for l in d["levels"]]
                       for d in descs],
            "entries": [f["entries"] for f in fulls],
            "io": [f["io"] for f in fulls],
            "kernels": eng.kernel_counters.snapshot(),
            "records": level_records(descs)}


def proc_structure(eng) -> dict:
    """``structure`` of a procs store just recovered: its workers'
    "recover" records are current, ``seq`` included."""
    descs = [eng.manifest.shard_record(s) for s in range(eng.num_shards)]
    return {"levels": [[l["n"] if l else 0 for l in d["levels"]]
                       for d in descs],
            "seq": [d["seq"] for d in descs],
            "entries": [sh.stats_full()["entries"] for sh in eng.shards]}


def inline_view(inline: dict, when: str) -> dict:
    """The inline store at ``when`` ("load" or "lookups") as a procs
    store's parent sees one."""
    snap = inline[when]
    return {**{k: snap[k] for k in ("levels", "entries", "io", "kernels")},
            "records": level_records(inline[f"desc_{when}"])}


def shard_calls(eng) -> list[dict]:
    """Every shard's gated kernel calls so far, by the kernel each one
    launches."""
    return [{"cascade_sm90": k.cascade_calls, "merge_path_sm90": k.merge_calls,
             "interval_sm90": k.interval_calls, "bloom_sm90": k.bloom_calls}
            for k in (sh.kernels for sh in eng.shards)]


def expect_worker_launches(eng, before: list, what: str,
                           rows: list | None = None) -> list[dict]:
    """Each worker's launches since ``reset_counts`` (``rows``, or read
    now) are exactly its shards' gated calls since ``before``: so no PR
    12 kernel, and the parent launched nothing.  Returns them a
    worker."""
    from repro_torch.kernels import native
    assert not any(native.LAUNCHES.values()), \
        f"{what}: the parent of a procs store launched {native.LAUNCHES}"
    pool = eng._proc_pool
    if rows is None:
        rows = pool.launches(per_worker=True)
    after = shard_calls(eng)
    for pw, row in zip(pool.workers, rows):
        calls = {k: sum(after[s][k] - before[s][k] for s in pw.spec.shard_ids)
                 for k in after[0]}
        expect_launches(row, calls, f"{what}, worker {pw.spec.worker_id}")
    return rows


def card_processes() -> str:
    """nvidia-smi's memory a process on the card, or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    rows = out.stdout.strip().replace("\n", "; ")
    return rows if out.returncode == 0 and rows else "not measured"


def nonzero(rows: list[dict]) -> str:
    return json.dumps([{k: v for k, v in r.items() if v} for r in rows])


def procs_phase(keys, los, tail, batches, live, inline, scans, durable,
                card) -> dict:
    """Phase 2e: the procs store and its two recoveries, in a temporary
    directory removed at the end (also on failure); returns the launches
    by path for each kernel."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_procs_")
    try:
        out = procs_checks(os.path.join(root, "wal"), keys, los, tail,
                           batches, live, inline, scans, durable, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 2e: {time.perf_counter() - t0:.3f} s")
    return out


def procs_store(wal, keys, los, tail, batches, live, inline, scans,
                durable, card) -> dict:
    """The live procs store: the inline store's stream through 4 worker
    processes (two shards each, every shard on cuda:0) with a WAL,
    held to the inline store after the load and after the lookups, and
    the first batches of both scan mixes held to its digests."""
    t0 = time.perf_counter()
    eng, _, _ = build_slice(len(keys), 8, 0, "cuda", procs=PROCS, devices=1,
                            wal_dir=wal, fsync="batch")
    try:
        return procs_store_checks(eng, t0, wal, keys, los, tail, batches,
                                  live, inline, scans, durable, card)
    finally:
        eng.close()


def procs_store_checks(eng, t0, wal, keys, los, tail, batches, live, inline,
                       scans, durable, card) -> dict:
    """``procs_store``'s checks on the built store; returns its launches
    by kernel for the load and lookups, and for the scans."""
    up = eng._proc_pool.startup_s
    homes = set(eng.device_map().values())
    assert eng.procs == PROCS and eng.devices is not None and \
        len(homes) == 1, (eng.procs, eng.device_map())
    log(f"procs store: {PROCS} workers (shards "
        f"{[pw.spec.shard_ids for pw in eng._proc_pool.workers]}, every one "
        f"on {homes.pop()}), spawned in {up['spawn']:.3f} s, all ready after "
        f"{up['ready']:.3f} s, engine built in "
        f"{time.perf_counter() - t0:.3f} s {card}")
    reset_counts(eng)
    before = shard_calls(eng)
    load_s, put_lat = load(eng, keys, los)
    rows = expect_worker_launches(eng, before, "procs store load")
    assert_same_snapshot(proc_snapshot(eng), inline_view(inline, "load"),
                         "after the load", "procs store")
    n_ops = len(keys) + los.size
    log(f"load, procs store (fsync a batch, WAL on {fs_type(wal)}): "
        f"{load_s:.3f} s = {n_ops / load_s:.1f} ops/s; {latency_ms(put_lat)}; "
        f"durable inline store (phase 2d): {durable['load_s']:.3f} s = "
        f"{n_ops / durable['load_s']:.1f} ops/s; "
        f"{latency_ms(durable['put_lat'])}; launches a worker {nonzero(rows)} "
        f"{card}")
    reset_counts(eng)
    before = shard_calls(eng)
    first, _ = lookups(eng, batches)
    for lo in tail:
        range_deletes(eng, lo)
    second, lat = lookups(eng, batches)
    lookup_rows = expect_worker_launches(eng, before, "procs store lookups")
    for pw, row in zip(eng._proc_pool.workers, lookup_rows):
        assert row["cascade_sm90"] == \
            2 * len(batches) * len(pw.spec.shard_ids), row
    for got, want in zip(first + second, inline["results"][0]
                         + inline["results"][1]):
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), \
            "procs store's lookups differ from the inline store's"
    assert_same_snapshot(proc_snapshot(eng), inline_view(inline, "lookups"),
                         "after the lookups", "procs store")
    report_lookups("lookups, procs store (results equal the inline "
                   "store's)", lat, card)
    report_lookups("lookups, inline store", inline["lookup_lat"], card)
    cut = first_batches(scans, RECOVERED_SCAN_BATCHES)
    out = {"launches": {"merge_path_sm90": sum(r["merge_path_sm90"]
                                               for r in rows),
                        "cascade_sm90": sum(r["cascade_sm90"]
                                            for r in lookup_rows)},
           "scans": {"merge_path_sm90": 0, "interval_sm90": 0}}
    pool = eng._proc_pool
    for name, mix in cut["mixes"].items():
        before = shard_calls(eng)
        got = scan_mix(eng, f"{name}, procs store", cut["batches"][name],
                       live, card)
        assert got["digests"] == mix["digests"], f"procs store: {name} scans"
        # scan_mix read the workers' counts at its end.
        rows = expect_worker_launches(
            eng, before, f"procs store {name} scans",
            [pool.worker_launches[pw.spec.worker_id]
             for pw in pool.workers])
        log(f"scans {name}, procs store: launches a worker {nonzero(rows)}")
        for k, v in got["launches"].items():
            out["scans"][k] += v
    log("procs store: scans equal the inline store's digests; each "
        "worker's launches are its shards' gated calls")
    t = eng.stats()["proc"]
    dq = t["dequeue_latency_us"]
    pool.launches()  # reads each worker's allocator peak too
    log(f"procs transport: {t['requests']} requests, {t['bytes_sent']} B "
        f"sent, {t['bytes_received']} B received; dequeue p50 "
        f"{dq['p50_us']} us, p99 {dq['p99_us']} us ({dq['count']} "
        f"replies); worker allocator peaks "
        f"{json.dumps(pool.worker_peak_allocated)} B; per process on the "
        f"card (nvidia-smi, context included; worker pids "
        f"{[pw.proc.pid for pw in pool.workers]}, parent {os.getpid()}): "
        f"{card_processes()} {card}")
    log("procs store, device: busy share not measured (the parent's "
        "profiler sees only its own process, and the kernels run in the "
        "workers')")
    return out


def procs_checks(wal, keys, los, tail, batches, live, inline, scans,
                 durable, card) -> dict:
    """The procs store under ``wal``, then ``recover`` of its directory
    with 4 workers (each replays its own streams) and in-process, both
    held to the inline store in structure, lookups and scan digests."""
    from repro_torch.durable import recover
    from repro_torch.engine import EngineConfig
    from repro_torch.kernels import native
    live_store = procs_store(wal, keys, los, tail, batches, live, inline,
                             scans, durable, card)
    cut = first_batches(scans, RECOVERED_SCAN_BATCHES)
    want = {"structure": {k: inline["lookups"][k]
                          for k in ("levels", "seq", "entries")},
            "results": inline["results"][1]}
    native.reset_launches()
    rec = recover(wal, config=EngineConfig(procs=PROCS, devices=1))
    try:
        got, merges, frames = procs_recovery(rec, want, batches, cut, live,
                                             inline, durable, card)
    finally:
        rec.close()
    rec, in_merges = recover_checked(wal, "in-process, of the procs WAL")
    try:
        assert rec.recovery["frames_replayed"] == frames
        assert in_merges == merges, (in_merges, merges)
        inproc = recovered("in-process recovery of the procs WAL", rec, want,
                           batches, cut, live, card)
    finally:
        rec.close()
    log("procs store and both recoveries of its WAL equal the inline store "
        "(IOStats, kernel counters, level records, lookups, scan digests)")
    return {
        "merge_path_sm90": {
            "procs store": live_store["launches"]["merge_path_sm90"]
            + live_store["scans"]["merge_path_sm90"],
            "procs recoveries": merges + in_merges,
            "procs recovered scans": got["merge_path_sm90"]
            + inproc["merge_path_sm90"]},
        "cascade_sm90": {
            "procs store": live_store["launches"]["cascade_sm90"],
            "procs recovered lookups": got["cascade_sm90"]
            + inproc["cascade_sm90"]},
        "interval_sm90": {
            "procs store": live_store["scans"]["interval_sm90"],
            "procs recovered scans": got["interval_sm90"]
            + inproc["interval_sm90"]}}


def procs_recovery(rec, want, batches, cut, live, inline, durable, card):
    """The recovery with 4 workers held to ``want`` and to the inline
    store's level records; returns what it served, its replay's merges
    and its frames."""
    r, up = rec.recovery, rec._proc_pool.startup_s
    assert rec.procs == PROCS and r["frames_replayed"] > 0, r
    # Fresh workers: their counts are the replay's, their shards' merge
    # calls (shipped with READY) the replay's gated merges.
    rows = expect_worker_launches(rec, [dict.fromkeys(c, 0)
                                        for c in shard_calls(rec)],
                                  "procs recovery")
    merges = sum(row["merge_path_sm90"] for row in rows)
    assert merges == rec.kernel_counters.merge_calls > 0, rows
    inside = [{"build_s": round(pw.ready["build_s"], 3),
               "read_s": round(sum(i["read_s"] for i in
                                   pw.ready["shards"].values()), 3),
               "replay_s": round(sum(i["replay_s"] for i in
                                     pw.ready["shards"].values()), 3)}
              for pw in rec._proc_pool.workers]
    log(f"recovery, {PROCS} workers: {r['wall_s']:.3f} s ({up['spawn']:.3f} "
        f"s to spawn, every worker replayed and ready after "
        f"{up['ready']:.3f} s; inside each worker {json.dumps(inside)}), "
        f"{r['frames_replayed']} frames replayed = "
        f"{r['frames_replayed'] / r['wall_s']:.1f} frames/s; in-process full "
        f"replay (phase 2d): {durable['replay_s']:.3f} s; launches a worker "
        f"{nonzero(rows)} {card}")
    assert level_records([rec.manifest.shard_record(s)
                          for s in range(rec.num_shards)]) == \
        level_records(inline["desc_lookups"]), "procs recovery's records"
    got = recovered(f"procs recovery ({PROCS} workers)", rec, want, batches,
                    cut, live, card)
    return got, merges, r["frames_replayed"]


# ------------------------------------------------- a real process death
KILL_ACKED = (120, 240)  # acked batches before the kill, drawn from --seed
KILL_WAIT = 600  # s the child may take to reach them
KILL_SAMPLE = 8192  # range-deleted keys checked absent
ACKED = "acked.log"
CHILD_MODULES = "child_modules.json"  # jax / repro modules the child loaded


def kill_child_main(wal_dir: str, device: str) -> int:
    """The writer of phase 2f, in a process of its own: the cell's
    stream (``make_stream(0, STORE_KEYS)``) into a durable 8-shard store on
    ``device``, each put batch and its range deletes acknowledged by a
    line in ``acked.log`` (written, flushed and fsynced after both calls
    returned).  It runs until the parent kills it."""
    eng = build_engine(8, device, wal_dir=wal_dir, fsync="batch")
    with open(os.path.join(wal_dir, CHILD_MODULES), "w") as f:
        json.dump(sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "repro")), f)
    keys, los = make_stream(0, STORE_KEYS)
    with open(os.path.join(wal_dir, ACKED), "w") as ack:
        for b in range(los.shape[0]):
            k = keys[b * PUT_BATCH:(b + 1) * PUT_BATCH]
            eng.put_batch(k, k + np.uint64(1))
            range_deletes(eng, los[b])
            ack.write(f"{b}\n")
            ack.flush()
            os.fsync(ack.fileno())
    eng.close()
    return 0


def acked_batches(wal_dir: str) -> int:
    """Batches the child acknowledged: the whole lines of ``acked.log``,
    which must count 0, 1, ... in order."""
    try:
        with open(os.path.join(wal_dir, ACKED)) as f:
            lines = f.read().split("\n")[:-1]
    except FileNotFoundError:
        return 0
    assert lines == [str(i) for i in range(len(lines))], lines[-3:]
    return len(lines)


def kill_child(wal_dir: str, target: int, device: str) -> int:
    """Start the writer on ``wal_dir``, SIGKILL it once ``target``
    batches are acknowledged, and return the count read after its
    death.  The child must not end on its own or miss ``KILL_WAIT``."""
    err_path = os.path.join(wal_dir, "child.err")
    with open(err_path, "w") as err:
        child = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--kill-child",
             wal_dir, "--kill-device", device],
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + KILL_WAIT
        while acked_batches(wal_dir) < target:
            if child.poll() is not None:
                with open(err_path) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"the writer exited ({child.returncode})"
                                     f" before the kill: {tail}")
            assert time.monotonic() < deadline, \
                f"fewer than {target} acked batches in {KILL_WAIT} s"
            time.sleep(0.01)
        child.kill()
        child.wait(timeout=60)
        assert child.returncode == -9, child.returncode
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    with open(os.path.join(wal_dir, CHILD_MODULES)) as f:
        assert json.load(f) == [], "the writer loaded jax or repro"
    return acked_batches(wal_dir)


def envelope(keys, los, n: int) -> list[tuple]:
    """The stores a recovery may serve after ``n`` acknowledged batches,
    as (put keys, range-delete bounds) of the plain model: the acked
    prefix, then batch n's puts, its point deletes (the cell's stream has
    none, so that stage equals the one before) and its range deletes.
    Each of those is its own per-shard WAL frame, so any prefix of them
    may be durable on a given shard."""
    stages = [(keys[:n * PUT_BATCH], los[:n])]
    if n < los.shape[0]:
        puts = (keys[:(n + 1) * PUT_BATCH], los[:n])
        stages += [puts, puts, (puts[0], los[:n + 1])]
    return stages


def outside_envelope(found, vals, q, stages) -> np.ndarray:
    """The queries whose served state is no stage's plain-model answer."""
    ok = np.zeros(len(q), bool)
    for k, l in stages:
        mf, mv = model_lookup(k, l, q)
        ok |= (found == mf) & (~found | (vals == mv))
    return ~ok


def deleted_sample(keys, los, n: int, stages, rng) -> tuple:
    """``KILL_SAMPLE`` keys that the acked prefix range-deleted and no
    stage brings back (put keys a range delete killed first, topped up
    with points inside the acked range deletes), and how many of them
    were killed puts."""
    q = keys[:n * PUT_BATCH]
    killed = q[~model_lookup(q, los[:n], q)[0]]
    lo = los[:n].reshape(-1)
    spots = lo[rng.integers(0, len(lo), 2 * KILL_SAMPLE)] + \
        rng.integers(0, RANGE_LEN, 2 * KILL_SAMPLE).astype(np.uint64)
    cand = np.unique(np.concatenate([killed, spots]))
    for k, l in stages:
        cand = cand[~model_lookup(k, l, cand)[0]]
    pick = np.isin(cand, killed)
    cand = np.concatenate([rng.permutation(cand[pick]),
                           rng.permutation(cand[~pick])])
    assert len(cand) >= KILL_SAMPLE, len(cand)
    return cand[:KILL_SAMPLE], int(min(pick.sum(), KILL_SAMPLE))


def cascade_launches(eng, q: np.ndarray) -> int:
    """The cascade launches a ``get_batch`` of ``q`` makes: one a shard,
    less the shards whose memtables hold every key of their sub-batch
    (``LSMTree.get_batch`` calls the cascade only for a key left)."""
    shard = eng.router.shard_of(q)
    n = 0
    for s, sh in enumerate(eng.shards):
        sub = q[shard == s]
        mem = sh.tree._mem_sorted()[0] if sh.tree.mem else sub[:0]
        n += bool(len(sub)) and not np.isin(sub, mem).all()
    return n


def kill_phase(keys, los, seed: int, card: str,
               device: str = "cuda") -> dict:
    """Phase 2f: a durable writer of the cell's stream killed with
    SIGKILL after a seeded number of acknowledged batches, its directory
    recovered on the card and every key of the acked prefix and of the
    in-flight batch held to the envelope; the envelope of two batches
    more must fail.  ``keys, los`` are the cell's stream, which the
    writer draws again.  Returns the launches by path."""
    from repro_torch.kernels import native
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    target = int(rng.integers(KILL_ACKED[0], KILL_ACKED[1] + 1))
    root = tempfile.mkdtemp(prefix="chip_smoke_kill_")
    try:
        t1 = time.perf_counter()
        n = kill_child(root, target, device)
        child_s = time.perf_counter() - t1
        assert target <= n < los.shape[0] - 2, (target, n)
        log(f"writer killed (SIGKILL) after {n} acknowledged batches "
            f"({n * PUT_BATCH} puts, {n * RANGES_PER_BATCH} range deletes; "
            f"target {target} from --seed {seed}) {child_s:.3f} s after "
            f"its start; WAL {dir_bytes(root)} B on {fs_type(root)}")
        rec, merges = recover_checked(root, "killed writer")
        r = structure(rec)
        log(f"killed writer's store: levels a shard {r['levels']}, entries "
            f"{r['entries']}")
        # Lookups: batch b holds put batch b's keys, for b up to n + 2
        # (the planted envelope's), then the range-deleted sample.
        stages = envelope(keys, los, n)
        sample, n_killed = deleted_sample(keys, los, n, stages, rng)
        batches = [keys[b * PUT_BATCH:(b + 1) * PUT_BATCH]
                   for b in range(n + 3)] + [sample]
        want = sum(cascade_launches(rec, q) for q in batches)
        kc0 = rec.kernel_counters
        native.reset_launches()
        t1 = time.perf_counter()
        results, _ = lookups(rec, batches)
        look_s = time.perf_counter() - t1
        calls = rec.kernel_counters.cascade_calls - kc0.cascade_calls
        assert calls == want, (calls, want)
        expect_launches(native.LAUNCHES, {"cascade_sm90": calls},
                        "killed writer's lookups")
        m = rec.stats()["metrics"]
        rec.close()
        found = np.concatenate([f for f, _ in results[:n + 1]])
        vals = np.concatenate([v for _, v in results[:n + 1]])
        q = keys[:(n + 1) * PUT_BATCH]
        bad = outside_envelope(found, vals, q, stages)
        sf = results[-1][0]
        planted = outside_envelope(
            np.concatenate([f for f, _ in results[:n + 3]]),
            np.concatenate([v for _, v in results[:n + 3]]),
            keys[:(n + 3) * PUT_BATCH], envelope(keys, los, n + 2))
        log(f"killed writer: {len(q)} keys of the {n} acked batches and the "
            f"in-flight one checked against the envelope's "
            f"{len(stages)} stages, {int(bad.sum())} outside it; "
            f"{len(sample)} range-deleted keys ({n_killed} of them puts a "
            f"range delete killed), {int(sf.sum())} found; planted fault "
            f"(the envelope of {n + 2} batches): {int(planted.sum())} of "
            f"{(n + 3) * PUT_BATCH} keys outside it; recovery "
            f"{m['recovery.wall_s']:.3f} s, "
            f"{int(m['recovery.frames_replayed'])} frames replayed, "
            f"merge_path_sm90 launches {merges}; {len(batches)} lookup "
            f"batches in {look_s:.3f} s, cascade_sm90 launches {calls} (8 a "
            f"batch less {8 * len(batches) - calls} sub-batches the "
            f"memtables answered), equal to the kernel counters {card}")
        assert not bad.any(), \
            f"acked writes lost or corrupted: keys {q[bad][:5]}"
        assert not sf.any(), f"range-deleted keys served: {sample[sf][:5]}"
        assert planted.sum() >= PUT_BATCH // 2, \
            "the check cannot see writes that were never issued"
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 2f: {time.perf_counter() - t0:.3f} s")
    return {"merge_path_sm90": {"killed writer's recovery": merges},
            "cascade_sm90": {"killed writer's lookups": calls}}


def store_phases(card: str, seed: int) -> list[dict]:
    """Phases 2-4: the store's slice (with the scheduler, durable and
    procs stores), its per-level route and its five kernels against
    their plain versions; returns their records."""
    from repro_torch.kernels import native

    # 2. the slice, cascade on: counts are zeroed just before the load
    # and read just after the lookups.
    shards = 8
    eng, keys, los = build_slice(STORE_KEYS, shards, 0, "cuda")
    batches = make_lookups(0, keys, LOOKUP_BATCHES, LOOKUP_BATCH)
    torch.cuda.reset_peak_memory_stats()
    kc_start = eng.kernel_counters
    native.reset_launches()
    load_s, put_lat = load(eng, keys, los)
    load_launches = dict(native.LAUNCHES)
    snap_load = store_snapshot(eng)
    desc_load = described(eng)
    kc0 = eng.kernel_counters
    results, lat = lookups(eng, batches)
    first_results = results
    main_launches = dict(native.LAUNCHES)
    kc1 = eng.kernel_counters
    n_ops = len(keys) + los.size
    log(f"load: {len(keys)} puts + {los.size} range deletes "
        f"({100 * los.size / n_ops:.3f}% range deletes) in {load_s:.3f} s "
        f"= {n_ops / load_s:.1f} ops/s; {latency_ms(put_lat)}; launches "
        f"{json.dumps(load_launches)} {card}")
    report_lookups("lookups", lat, card)
    check_results(results, batches, keys, los)
    log(f"results equal the model on {LOOKUP_BATCHES * LOOKUP_BATCH} "
        f"lookups ({sum(int(f.sum()) for f, _ in results)} found)")
    views = check_cascade_path(
        eng, kc0, kc1, main_launches["cascade_sm90"]
        - load_launches["cascade_sm90"], shards)
    # One merge_path_sm90 launch a merge_ranks call, none of merge_rank.
    merges = kc1.merge_calls - kc_start.merge_calls
    assert merges > 0 and main_launches["merge_path_sm90"] == merges \
        and main_launches["merge_rank"] == 0, (merges, main_launches)
    log(f"kernel counters: {json.dumps(kc1.snapshot())}")
    log(f"cascade L per shard {[v.state.L for v in views]}, G per shard "
        f"{[v.state.G for v in views]}, level entries "
        f"{[v.state.key_cnt.tolist() for v in views]}, GLORAN areas "
        f"{[v.state.gl_cnt.tolist() for v in views]}")
    log(f"device memory: max allocated "
        f"{torch.cuda.max_memory_allocated()} B, uploads "
        f"{kc1.upload_bytes} B, packs "
        f"{sum(v.state.nbytes for v in views)} B {card}")

    # Bottom-compaction GC empties the DR-tree levels during the load;
    # range deletes continue (82 a batch, no puts) until every shard's
    # index has flushed a level again, and the lookups run once more
    # with the cascade's GLORAN stage over real areas.
    los_all = tail_deletes(eng, los)
    kc2 = eng.kernel_counters
    native.reset_launches()
    results, lat = lookups(eng, batches)
    main2 = dict(native.LAUNCHES)
    kc3 = eng.kernel_counters
    report_lookups(f"lookups after {los_all.size - los.size} more range "
                   "deletes", lat, card)
    check_results(results, batches, keys, los_all)
    views = check_cascade_path(eng, kc2, kc3, main2["cascade_sm90"], shards)
    areas = [v.state.gl_cnt.tolist() for v in views]
    assert all(sum(a) > 0 for a in areas), areas
    main_launches["cascade_sm90"] += main2["cascade_sm90"]
    log(f"results equal the model; GLORAN areas per shard {areas}; "
        f"cascade_sm90 launches {main2['cascade_sm90']}")
    inline = {"load": snap_load, "lookups": store_snapshot(eng),
              "results": (first_results, results), "load_s": load_s,
              "put_lat": put_lat, "lookup_lat": lat, "desc_load": desc_load,
              "desc_lookups": described(eng)}
    log(device_busy(eng, batches[:4]))
    traced = trace_phase(eng, batches, card)

    # 2b. range scans on the same store at the default gates, and 2c.
    # a second store with the background scheduler, held to this one.
    live = live_keys(keys, los_all)
    scans = scan_phase(eng, live, card)
    sched_launches = scheduler_phase(keys, los, los_all[len(los):], batches,
                                     live, inline, scans, card)
    # 2d. a third store with a write-ahead log, and its recoveries; 2e.
    # a fourth with its shards in worker processes, and its recoveries.
    durable_launches, durable = durable_phase(
        keys, los, los_all[len(los):], batches, live, inline, scans, card)
    procs_launches = procs_phase(keys, los, los_all[len(los):], batches,
                                 live, inline, scans, durable, card)
    # 2f. a durable writer of the same stream killed mid-stream.
    kill_launches = kill_phase(keys, los, seed, card)
    path = {"merge_path_sm90": {"load": main_launches["merge_path_sm90"],
                                "scans": scans["launches"]["merge_path_sm90"],
                                "scheduler store": sched_launches[
                                    "merge_path_sm90"]},
            "cascade_sm90": {"lookups": main_launches["cascade_sm90"],
                             "traced lookups": traced["cascade_sm90"],
                             "scheduler store lookups": sched_launches[
                                 "cascade_sm90"]},
            "interval_sm90": {"scans": scans["launches"]["interval_sm90"]}}
    for by_path in (durable_launches, procs_launches, kill_launches):
        for name, n in by_path.items():
            path[name].update(n)

    # 3. the per-level route on the same store: cascade off, and every
    # probe of a level takes a kernel.  The default gates would keep the
    # interval kernel off: GLORAN validity probes reach only the few
    # EVE-positive keys of a sub-batch.
    eng.config.use_cascade_kernel = False
    eng.config.kernel_min_batch = 1
    eng.config.kernel_min_areas = 1
    eng.config.kernel_min_filter = 1
    kc3 = eng.kernel_counters
    native.reset_launches()
    results2, lat2 = lookups(eng, batches)
    route_launches = dict(native.LAUNCHES)
    kc4 = eng.kernel_counters
    for (f0, v0), (f1, v1) in zip(results, results2):
        assert np.array_equal(f0, f1) and np.array_equal(v0, v1)
    assert kc4.cascade_calls == kc3.cascade_calls
    # Every per-level launch is a Hopper kernel, one a gated call.
    bloom_calls = kc4.bloom_calls - kc3.bloom_calls
    interval_calls = kc4.interval_calls - kc3.interval_calls
    assert bloom_calls > 0 and interval_calls > 0, kc4
    assert route_launches["bloom_sm90"] == bloom_calls, route_launches
    assert route_launches["interval_sm90"] == interval_calls, route_launches
    others = {k: v for k, v in route_launches.items()
              if v and k not in ("bloom_sm90", "interval_sm90")}
    assert not others, f"per-level route launched {others}"
    report_lookups("per-level route (results equal)", lat2, card)
    log(f"per-level launches {json.dumps(route_launches)}, equal to the "
        f"gated calls (bloom {bloom_calls}, interval {interval_calls})")

    path["interval_sm90"]["per-level route"] = route_launches["interval_sm90"]

    # 4. each kernel against its plain version at the path's shapes; the
    # launches of a Hopper kernel are those of every path that ran it.
    for name, by_path in path.items():
        launches = main_launches if name != "interval_sm90" \
            else route_launches
        launches[name] = sum(by_path.values())
    records = kernel_checks(eng, views, batches, main_launches,
                            route_launches, card)
    by_name = {r["name"]: r for r in records}
    for name, by_path in path.items():
        by_name[name]["path_launches"] = by_path
    by_name["interval_sm90"]["scan_ms"] = scan_interval_times(
        eng, scans["stabs"], card)
    eng.close()
    return records


def check_kernel(name, launches, kernel, plain, bytes_, card, *, ops=0,
                 tol=0.0, rtol=0.0, library=None) -> dict:
    """One kernel against its plain version on the same inputs (every
    element within ``tol + rtol * |plain|``; both 0 is bit-exact), its
    median device time, the plain version's and a library call's time,
    and its bound: the larger of ``bytes_`` over the HBM rate and
    ``ops`` over the bf16 tensor-core peak.  The counts of the main-path
    windows were read already; these launches fall outside them."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = max_abs_err(got, want)
    used = allowance_used(got, want, tol, rtol)
    if not used <= 1:
        raise AssertionError(f"{name}: kernel differs from plain version "
                             f"(max abs err {err}, tolerance {tol} + "
                             f"{rtol} |plain|: {used} of it used)")
    ms = time_kernel_ms(kernel)
    plain_ms = time_host_ms(plain)
    lib_ms = time_kernel_ms(library) if library else None
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = ops / BF16_TENSOR_FLOPS * 1e3
    bound = max(by_bytes, by_ops)
    src, replaces = KERNEL_SOURCES[name]
    log(f"{name}: max abs err {err} (tolerance {tol} + {rtol} |plain|, "
        f"{used} of it used); {ms:.6f} ms (plain "
        f"{plain_ms:.6f} ms, library {lib_ms}, bound {bound:.6f} ms from "
        f"{bytes_} B and {ops} FLOP) {card}")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": lib_ms}


def same(got, want) -> bool:
    """Bit-exact equality of two kernels' output tensors or tuples."""
    if isinstance(got, tuple):
        return all(same(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def cascade_bytes(st, tree, qh: np.ndarray) -> int:
    """The cascade's bound in bytes for these queries against this pack:
    the queries read and the outputs written once, and the distinct
    sectors of the fence and GLORAN searches, the Bloom probes, the hit
    and the area loads."""
    n = len(qh)
    probes = sum(bloom_probe_counts(
        qh, lvl.bloom.words, lvl.bloom.m_bits, lvl.bloom.seeds)
        for lvl in tree.levels if lvl is not None and len(lvl))
    sectors = (probes + sum(min(search_sectors(c, n) + n, c // 8 + 1)
                            for c in st.key_cnt.tolist())
               + sum(min(search_sectors(c, n), c // 8 + 1) + 3 * n
                     for c in st.gl_cnt.tolist()))
    return 16 * n + (12 + 4 * st.L) * n + SECTOR * sectors


def capture_sub_batches(eng, batch: np.ndarray) -> dict:
    """The cascade's inputs for each shard's sub-batch of one lookup
    batch, as the engine's own partitioner and memtable probe make them
    (request order): {shard: (qkey, qhash, qseq, qres) on the card}."""
    from repro_torch.engine import executor
    from repro_torch.kernels.u32 import to_device
    dev = eng.device
    seen = []
    real = executor.cascade_lookup

    def spy(qkey32, qhash32, qseq32, qres, state):
        seen.append((state, (to_device(qkey32, dev), to_device(qhash32, dev),
                             to_device(qseq32, dev),
                             to_device(np.asarray(qres, bool), dev,
                                       np.int32))))
        return real(qkey32, qhash32, qseq32, qres, state)

    cascade_on = eng.config.use_cascade_kernel
    executor.cascade_lookup = spy
    eng.config.use_cascade_kernel = True
    try:
        eng.get_batch(batch)
    finally:
        executor.cascade_lookup = real
        eng.config.use_cascade_kernel = cascade_on
    shard_of = {id(sh.registry.view(sh.tree).state): s
                for s, sh in enumerate(eng.shards)}
    return {shard_of[id(st)]: q for st, q in seen}


def at_area_starts(q, st, rng):
    """The queries with a quarter of their keys set to the pack's GLORAN
    area starts, resolved by the memtable with the area's smin as seq:
    each such key is covered, and a stab one area to the left is not."""
    from repro_torch.core.eve import fold64to32
    from repro_torch.kernels.u32 import to_device, to_numpy
    dev = q[0].device
    areas = np.concatenate([np.arange(o, o + c) for o, c in
                            zip(st.gl_off.tolist(), st.gl_cnt.tolist())])
    n = q[0].numel()
    k = torch.as_tensor(areas[rng.integers(0, len(areas), n // 4)],
                        device=dev)
    idx = torch.as_tensor(rng.permutation(n)[:n // 4], device=dev)
    qk, _, qs, qr = (t.clone() for t in q)
    qk[idx] = st.glo_lo[k]
    qs[idx] = st.glo_smin[k]
    qr[idx] = 1
    qh = to_device(fold64to32(to_numpy(qk).astype(np.uint64)), dev)
    return qk, qh, qs, qr


def cascade_checks(eng, views, batches, mixed_keys, launches, card,
                   rng) -> list[dict]:
    """``cascade_sm90`` against the plain version on shard 0's
    request-order sub-batch of a real lookup batch; timed there, on the
    same keys sorted, on the earlier runs' batch ``mixed_keys``, and
    rotated over the eight shards' sub-batches and packs as the path
    runs them, beside an empty kernel's launch floor; the planted fault;
    a whole batch of 8192 keys."""
    from repro_torch.core.eve import fold64to32
    from repro_torch.kernels.cascade import ops as cops
    from repro_torch.kernels.cascade.ref import cascade_ref
    from repro_torch.kernels.u32 import to_device
    dev = eng.device
    subs = capture_sub_batches(eng, batches[0])
    states = [v.state for v in views]
    st, tree = states[0], eng.shards[0].tree
    q = subs[0]
    n = q[0].numel()
    order = torch.argsort(q[0].to(torch.int64) & 0xFFFFFFFF)
    inputs = {  # shard 0's pack, other orders and keys
        "sorted": tuple(t[order].contiguous() for t in q),
        "mixed": (to_device(mixed_keys, dev),
                 to_device(fold64to32(mixed_keys), dev),
                 to_device(np.zeros(len(mixed_keys)), dev),
                 to_device(np.zeros(len(mixed_keys)), dev, np.int32))}
    rot = [(subs[s], states[s]) for s in range(len(states))]
    by = cascade_bytes(st, tree, q[1].cpu().numpy().view(np.uint32))
    rec = check_kernel("cascade_sm90", launches["cascade_sm90"],
                       lambda: cops.cascade_masks(*q, st),
                       lambda: cascade_ref(*q, st), by, card)
    for key, x in inputs.items():
        assert same(cops.cascade_masks(*x, st), cascade_ref(*x, st)), key
        rec[f"{key}_ms"] = time_kernel_ms(lambda: cops.cascade_masks(*x, st))
    turn = itertools.count()

    def rotated():
        x, state = rot[next(turn) % len(rot)]
        return cops.cascade_masks(*x, state)
    rec["rotated_ms"] = time_kernel_ms(rotated, reps=8 * len(rot))
    rec["floor_ms"] = time_kernel_ms(lambda: cops._launch_floor(n, st))
    log(f"cascade_sm90, ms a launch: shard 0's request-order sub-batch "
        f"(n = {n}, L = {st.L}, G = {st.G}) {rec['ms']:.6f}; the same keys "
        f"sorted {rec['sorted_ms']:.6f}; the mixed batch (n = "
        f"{len(mixed_keys)}) {rec['mixed_ms']:.6f}; rotated over "
        f"{len(rot)} shards' sub-batches and packs {rec['rotated_ms']:.6f}; "
        f"an empty kernel on its grid (launch floor, a reading) "
        f"{rec['floor_ms']:.6f}; bytes bound {rec['bound_ms']:.6f} {card}")

    # Keys at area starts: the kernel exact, the planted fault caught.
    qa = at_area_starts(q, st, rng)
    want = cascade_ref(*qa, st)
    assert want[2].any(), "no key at an area start is covered"
    assert same(cops.cascade_masks(*qa, st), want)
    wrong = cops._launch_sm90(*qa, st, planted_fault=True)
    diff = int((wrong[2] != want[2]).sum())
    assert diff > 0, "a GLORAN stab at lower_bound passes the check"
    log(f"cascade_sm90 with lower_bound in the GLORAN stab: {diff} of "
        f"{n} coverage masks differ at area starts: rejected")

    # n = 8192: a whole lookup batch against shard 0's pack, in request
    # order (the sub-batch size of ROADMAP A2).
    keys = batches[1]
    m = len(keys)
    big = (to_device(keys, dev), to_device(fold64to32(keys), dev),
           to_device(np.zeros(m), dev), to_device(np.zeros(m), dev, np.int32))
    assert same(cops.cascade_masks(*big, st), cascade_ref(*big, st)), \
        "cascade_sm90 at n = 8192"
    rec["n8192_ms"] = time_kernel_ms(lambda: cops.cascade_masks(*big, st))
    log(f"cascade_sm90 at n = {m}: bit-exact; {rec['n8192_ms']:.6f} ms "
        f"{card}")
    return [rec]


def merge_inputs(rng, na: int, nb: int):
    """Two sorted u32 runs as compaction merges them: b half drawn from a
    (cross-run duplicates), half uniform, and the u32 ceiling key."""
    a = np.sort(rng.integers(0, UNIVERSE, na, dtype=np.uint64))
    b = np.sort(np.concatenate([
        a[rng.integers(0, na, nb // 2)],
        rng.integers(0, UNIVERSE, nb - nb // 2 - 1, dtype=np.uint64),
        np.array([0xFFFFFFFE], np.uint64)]))
    return a.astype(np.uint32), b.astype(np.uint32)


def merge_cases(rng, small: bool = False) -> list:
    """The merge sweep: three sizes ((2^12, 2^16), (2^16, 2^19), (2^19,
    2^22), cut by 2^6 with ``small``) and adversarial runs."""
    cut = 6 if small else 0
    cases = [(f"2^{x - cut}x2^{y - cut}", *merge_inputs(
        rng, 1 << (x - cut), 1 << (y - cut))) for x, y in
        ((12, 16), (16, 19), (19, 22))]
    u32 = np.uint32
    a, b = merge_inputs(rng, 3001, 2047)
    cases += [
        ("equal", np.full(3000, 7, u32), np.full(5000, 7, u32)),
        ("disjoint", np.arange(3000, dtype=u32),
         np.arange(5000, 9000, dtype=u32)),
        ("disjoint-reversed", np.arange(5000, 9000, dtype=u32),
         np.arange(3000, dtype=u32)),
        ("one", a[:1], b),
        ("one-reversed", a, b[:1]),
        ("ragged", a, b),
        ("u32-edges", np.sort(np.r_[a[:1000], [0, 0, 0xFFFFFFFE]]).astype(u32),
         np.sort(np.r_[b[:999], [0, 0xFFFFFFFE]]).astype(u32))]
    return cases


def merge_checks(eng, launches, card, rng) -> list[dict]:
    """The ``merge_rank`` pair and ``merge_path_sm90`` against the plain
    version at runs of 2^19 and 2^16 (``torch.searchsorted`` as the
    yardstick); the planted fault; the sweep."""
    from repro_torch.kernels.merge import ops as mops
    from repro_torch.kernels.merge.ref import merge_positions_ref
    from repro_torch.kernels.u32 import to_device, widen
    dev = eng.device

    def pair(a, b):
        return (mops.merge_rank(a, b, leq=False),
                mops.merge_rank(b, a, leq=True))

    def searchsorted(a64, b64):
        return (torch.searchsorted(b64, a64),
                torch.searchsorted(a64, b64, right=True))

    ka, kb = merge_inputs(rng, 1 << 19, 1 << 16)
    a32, b32 = to_device(ka, dev), to_device(kb, dev)
    a64, b64 = widen(a32), widen(b32)
    old = check_kernel(
        "merge_rank", launches["merge_rank"], lambda: pair(a32, b32),
        lambda: (mops.merge_rank_ref(a32, b32, leq=False),
                 mops.merge_rank_ref(b32, a32, leq=True)),
        8 * (len(ka) + len(kb)), card,
        library=lambda: searchsorted(a64, b64))
    new = check_kernel(
        "merge_path_sm90", launches["merge_path_sm90"],
        lambda: mops.merge_positions(a32, b32),
        lambda: merge_positions_ref(a32, b32), 8 * (len(ka) + len(kb)),
        card, library=lambda: searchsorted(a64, b64))
    new["simt_ms"] = old["ms"]
    new["floor_ms"] = time_kernel_ms(
        lambda: mops._launch_floor(len(ka), len(kb), dev))
    log(f"merge_path_sm90: an empty kernel on its grid (launch floor, a "
        f"reading) {new['floor_ms']:.6f} ms {card}")
    wrong = mops._launch_merge_path(a32, b32, planted_fault=True)
    diff = int((wrong != merge_positions_ref(a32, b32)).sum())
    assert diff > 0, "ties broken b-first pass the check"
    log(f"merge_path_sm90 with ties b-first: {diff} slots differ: rejected")

    fails = []
    for name, ka, kb in merge_cases(rng):
        a32, b32 = to_device(ka, dev), to_device(kb, dev)
        want = merge_positions_ref(a32, b32)
        pa, pb = pair(a32, b32)
        ar_a = torch.arange(len(ka), dtype=torch.int32, device=dev)
        ar_b = torch.arange(len(kb), dtype=torch.int32, device=dev)
        ok = (same(mops.merge_positions(a32, b32), want),
              same(torch.cat([ar_a + pa, ar_b + pb]), want))
        if not all(ok):
            fails.append((name, ok))
        times = ""
        if name.startswith("2^"):
            a64, b64 = widen(a32), widen(b32)
            ms = (time_kernel_ms(lambda: mops.merge_positions(a32, b32)),
                  time_kernel_ms(lambda: pair(a32, b32)),
                  time_kernel_ms(lambda: searchsorted(a64, b64)))
            bound = 8 * (len(ka) + len(kb)) / HBM_BYTES_PER_S * 1e3
            times = (f"; merge_path_sm90 {ms[0]:.6f} ms, merge_rank pair "
                     f"{ms[1]:.6f} ms, searchsorted pair {ms[2]:.6f} ms, "
                     f"bound {bound:.6f} ms {card}")
        log(f"merge sweep {name} ({len(ka)} + {len(kb)}): bit-exact "
            f"(merge_path_sm90, merge_rank pair) {ok}{times}")
    assert not fails, f"merge kernels differ from the plain version: {fails}"
    return [old, new]


def kernel_checks(eng, views, batches, main_launches, route_launches,
                  card) -> list[dict]:
    # The mixed batch of earlier runs, one shard's worth: half uniform
    # keys sorted, half deepest-level keys in random order, and the two
    # u32 edges.
    rng = np.random.default_rng(7)
    sh = eng.shards[0]
    tree = sh.tree
    n = LOOKUP_BATCH // len(eng.shards)
    qk = np.sort(rng.integers(0, UNIVERSE, n, dtype=np.uint64))
    qk[:n // 2] = tree.levels[-1].keys[rng.integers(
        0, len(tree.levels[-1]), n // 2)]
    qk[0], qk[1] = 0, 0xFFFFFFFE
    other = np.random.default_rng(8)
    records = cascade_checks(eng, views, batches, qk, main_launches, card,
                             other)
    records += merge_checks(eng, main_launches, card, other)
    records += filter_checks(eng, batches, qk, route_launches, card, other)
    return records


# ----------------------------------------------- bloom and interval
def disjoint_level(rng, m: int, pad: int | None = None):
    """m key-disjoint areas sorted by lo as u32 columns (lo, hi, smin,
    smax): lo distinct in [0, 2^32 - 2), hi in (lo, next lo], seq windows
    [smin, smax) of width 0 to 2^16 - 1 in [0, 2^20 + 2^16); padded to
    ``pad`` slots with the registry's never-covering sentinels (lo = hi =
    0xFFFFFFFF, smin = smax = 0)."""
    u = np.unique(rng.integers(0, 0xFFFFFFFE, 2 * m + 64, dtype=np.uint64))
    assert len(u) >= m
    lo = np.sort(rng.permutation(u)[:m])
    gaps = np.diff(np.r_[lo, np.uint64(0xFFFFFFFF)])
    hi = lo + np.minimum(rng.integers(1, 1 << 12, m, dtype=np.uint64), gaps)
    smin = rng.integers(0, 1 << 20, m, dtype=np.uint64)
    smax = smin + rng.integers(0, 1 << 16, m, dtype=np.uint64)
    pad = m if pad is None else pad
    fill = (0xFFFFFFFF, 0xFFFFFFFF, 0, 0)
    return tuple(np.r_[c, np.full(pad - m, f, np.uint64)].astype(np.uint32)
                 for c, f in zip((lo, hi, smin, smax), fill))


def stab_queries(rng, cols, n: int):
    """n (key, seq) stabs of a level given as host u32 columns: a quarter
    at area starts with the area's smin as seq (covered where the window
    is not empty), a quarter at an area's last key with a seq at its
    smax (not covered), the rest uniform keys and seqs."""
    lo, hi, smin, smax = (c.astype(np.uint64) for c in cols)
    real = np.flatnonzero(lo < 0xFFFFFFFF)
    keys = rng.integers(0, 0xFFFFFFFF, n, dtype=np.uint64)
    seqs = rng.integers(0, int(smax.max(initial=0)) + 2, n, dtype=np.uint64)
    if len(real):
        q = n // 4
        a = real[rng.integers(0, len(real), q)]
        keys[:q], seqs[:q] = lo[a], smin[a]
        b = real[rng.integers(0, len(real), q)]
        keys[q:2 * q], seqs[q:2 * q] = hi[b] - np.uint64(1), smax[b]
    order = rng.permutation(n)
    return keys[order].astype(np.uint32), seqs[order].astype(np.uint32)


def bloom_cases(rng) -> list:
    """The Bloom sweep: (name, folded u32 keys, u32 words, m_bits, u32
    seeds) with n = 1 and ragged n, H = 0, 9 and 32, bit counts that are
    not multiples of 32, the smallest filter, and the u32 edge keys."""
    from repro_torch.core.eve import BloomBits, fold64to32
    cases = []
    for name, m_bits, hashes, n in (
            ("n=1", 70_001, 6, 1), ("ragged n=1027", 70_001, 6, 1027),
            ("H=0", 4096, 0, 100), ("H=9", 12_345, 9, 333),
            ("H=32", 100_003, 32, 1000), ("m_bits=12280", 12_280, 6, 500),
            ("m_bits=64", 64, 3, 50), ("ragged n=8193", 1 << 20, 6, 8193),
            ("u32 edges", 70_001, 6, 0)):
        bb = BloomBits(m_bits, hashes, seed=len(cases) + 1)
        items = rng.integers(0, 1 << 40, max(8, bb.m_bits // 10),
                             dtype=np.uint64)
        bb.insert(items)
        keys = fold64to32(np.r_[items[:n // 2], rng.integers(
            0, 1 << 40, n - n // 2, dtype=np.uint64)])
        if not n:
            keys = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF, 1], np.uint32)
        cases.append((name, keys.astype(np.uint32), bb.words, bb.m_bits,
                      np.asarray(bb.seeds, np.uint32)))
    return cases


def interval_cases(rng) -> list:
    """The interval sweep: (name, u32 keys, u32 seqs, lo, hi, smin, smax)
    with an empty level, one area probed at and around its lo, hi
    (exclusive), smin and smax, the registry's pow2-padded columns with
    clamped areas, areas at both u32 ends, n = 1, ragged n, levels of
    8192 areas, 8193 and 3 x 8192 + 5 areas and an unpadded level (the
    small levels' directories hold every lo, the others every 2^s-th)."""
    from types import SimpleNamespace
    from repro_torch.engine.registry import clamp_level_u32
    u32 = np.uint32
    cases = []
    empty = (np.zeros(0, u32),) * 4
    keys = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(u32)
    cases.append(("empty level", keys, keys ^ u32(7), *empty))
    one = tuple(np.array([v], u32) for v in (100, 200, 10, 20))
    k, q = np.meshgrid(np.array([0, 99, 100, 150, 199, 200, 0xFFFFFFFE], u32),
                       np.array([0, 9, 10, 19, 20, 0xFFFFFFFE], u32))
    cases.append(("one area", k.ravel(), q.ravel(), *one))
    lo, hi, smin, smax = (c.astype(np.uint64) for c in disjoint_level(rng, 40))
    lo[-2:] = [0xFFFFFFF0, 1 << 33]  # clamp_level_u32 keeps, then drops
    hi[-2:] = [1 << 34, 1 << 35]
    smin[:2] = [1 << 33, 0]
    smax[1] = 1 << 36
    cols = clamp_level_u32(SimpleNamespace(lo=lo, hi=hi, smin=smin,
                                           smax=smax))[:4]
    k, q = stab_queries(rng, cols, 600)
    cases.append(("pow2-padded, clamped", k, q, *cols))
    edge = (np.array([0, 5000, 0xFFFFFF00], u32),
            np.array([10, 6000, 0xFFFFFFFF], u32),
            np.array([0, 3, 0], u32), np.array([0xFFFFFFFF, 9, 0xFFFFFFFF],
                                               u32))
    k = np.array([0, 9, 10, 0xFFFFFF00, 0xFFFFFFFE, 0xFFFFFFFF, 5999], u32)
    cases.append(("u32 ends", k, np.array([0, 0, 0, 0, 0xFFFFFFFE, 5, 3],
                                          u32), *edge))
    for name, m, pad, n in (("n=1", 300, 512, 1), ("ragged n=1027", 700, 1024,
                                                   1027),
                            ("8192 areas", 8000, 8192, 2048),
                            ("8193 areas", 8193, None, 999),
                            ("3 x 8192 + 5 areas", 3 * 8192 + 5, None, 777),
                            ("10000 areas, unpadded", 10_000, None, 513)):
        cols = disjoint_level(rng, m, pad)
        cases.append((name, *stab_queries(rng, cols, n), *cols))
    return cases


def capture_route(eng, batch: np.ndarray):
    """The per-level route's kernel inputs for one lookup batch, as the
    engine's executors hand them over: ([(keys32, words, m_bits, seeds)],
    [(keys32, seqs32, lo, hi, smin, smax)]), all on the card."""
    from repro_torch.engine import executor
    blooms, stabs = [], []
    real_b, real_i = executor.bloom_probe, executor.interval_query

    def spy_bloom(keys32, words, *, m_bits, seeds):
        blooms.append((keys32, words, int(m_bits),
                       tuple(int(x) for x in seeds)))
        return real_b(keys32, words, m_bits=m_bits, seeds=seeds)

    def spy_interval(*args):
        stabs.append(args)
        return real_i(*args)

    cascade_on = eng.config.use_cascade_kernel
    executor.bloom_probe, executor.interval_query = spy_bloom, spy_interval
    eng.config.use_cascade_kernel = False
    try:
        eng.get_batch(batch)
    finally:
        executor.bloom_probe, executor.interval_query = real_b, real_i
        eng.config.use_cascade_kernel = cascade_on
    return blooms, stabs


def rotate(fn, inputs: list):
    """A call of fn that takes the next of ``inputs`` each time."""
    turn = itertools.count()
    return lambda: fn(*inputs[next(turn) % len(inputs)])


def bloom_checks(eng, qk, launches, card, rng, blooms) -> dict:
    """``bloom_sm90`` against the plain version and timed on the route's
    captured sub-batches, on n = 1024 and 8192 keys against the deepest
    level's filter and a 3 M-key filter; the planted fault; the
    sweep."""
    from repro_torch.core.eve import BloomBits, fold64to32
    from repro_torch.kernels.bloom import ops as bops
    from repro_torch.kernels.bloom.ops import bloom_probe
    from repro_torch.kernels.bloom.ref import bloom_probe_ref
    from repro_torch.kernels.u32 import to_device
    dev = eng.device
    sh = eng.shards[0]
    lvl = sh.tree.levels[-1]
    t0 = time.perf_counter()
    big = BloomBits(FILTER_KEYS * BITS_PER_KEY, HASHES, seed=17)
    present = rng.integers(0, 1 << 62, FILTER_KEYS, dtype=np.uint64)
    big.insert(present)
    log(f"a {FILTER_KEYS}-key filter ({big.m_bits} bits, {HASHES} hashes) "
        f"built on the host in {time.perf_counter() - t0:.3f} s")
    filters = {"deepest": (lvl.bloom, sh.registry.bloom_words(lvl),
                           lvl.keys),
               "3M": (big, to_device(big.words, dev), present)}

    def queries(keys, n):
        half = keys[rng.integers(0, len(keys), n // 2)]
        return fold64to32(np.r_[half, rng.integers(
            0, 1 << 62, n - n // 2, dtype=np.uint64)])

    inputs = {}  # name: (host keys, filter, device args)
    for f, (bb, words, keys) in filters.items():
        for n in (1024, 8192):
            qh = fold64to32(qk) if (f, n) == ("deepest", 1024) \
                else queries(keys, n)
            inputs[f"{f} n={n}"] = (qh, bb, (to_device(qh, dev), words,
                                             bb.m_bits, bb.seeds))
    def shipped(k, w, m, s):
        return bloom_probe(k, w, m_bits=m, seeds=s)

    def plain(k, w, m, s):
        return bloom_probe_ref(k, w, m_bits=m, seeds=s)

    for x in blooms:  # every captured sub-batch exact
        assert same(shipped(*x), plain(*x))
    ns = sorted(x[0].numel() for x in blooms)
    times = {"route": time_kernel_ms(rotate(shipped, blooms))}
    log(f"bloom_sm90, the route's {len(blooms)} captured sub-batches (n "
        f"{ns[0]}..{ns[-1]}, median {ns[len(ns) // 2]}), rotated: "
        f"{times['route']:.6f} ms {card}")
    for name, (qh, bb, x) in inputs.items():
        assert same(shipped(*x), plain(*x)), name
        n = len(qh)
        times[name] = {"ms": time_kernel_ms(lambda: shipped(*x))}
        times[name]["floor"] = time_kernel_ms(
            lambda: bops._launch_floor(n, dev))
        times[name]["bound"] = (8 * n + SECTOR * bloom_probe_counts(
            qh, bb.words, bb.m_bits, bb.seeds)) / HBM_BYTES_PER_S * 1e3
        log(f"bloom_sm90, {name} (H = {len(bb.seeds)}, {bb.m_bits} bits): "
            f"bit-exact; {json.dumps(times[name])} ms {card}")

    # The headline input of earlier runs: one shard's mixed batch.
    qh, bb, x = inputs["deepest n=1024"]
    by = 8 * len(qh) + SECTOR * bloom_probe_counts(qh, bb.words, bb.m_bits,
                                                   bb.seeds)
    rec = check_kernel("bloom_sm90", launches["bloom_sm90"],
                       lambda: shipped(*x), lambda: plain(*x), by, card)
    rec["floor_ms"] = times["deepest n=1024"]["floor"]
    rec["inputs_ms"] = times

    # Planted fault: H - 1 seeds pass absent keys the filter rejects.
    qa = to_device(fold64to32(rng.integers(0, 1 << 62, 8192,
                                           dtype=np.uint64)), dev)
    x = (qa, filters["3M"][1], big.m_bits, big.seeds)
    want = plain(*x)
    diff = int((bops._launch_sm90(*x, planted_fault=True) != want).sum())
    assert diff > 0, "bloom_sm90 with H - 1 seeds passes"
    log(f"bloom_sm90 probing H - 1 seeds: {diff} of 8192 absent keys' "
        f"verdicts differ: rejected")

    fails = []
    for name, k, w, m_bits, seeds in bloom_cases(rng):
        x = (to_device(k, dev), to_device(w, dev), m_bits, seeds)
        ok = same(shipped(*x), plain(*x))
        if not ok:
            fails.append(name)
        log(f"bloom_sm90 sweep {name} (n = {len(k)}, H = {len(seeds)}, "
            f"m_bits = {m_bits}): bit-exact {ok}")
    assert not fails, f"bloom_sm90 differs from the plain version: {fails}"
    return rec


def interval_checks(eng, launches, card, rng, stabs) -> dict:
    """``interval_sm90`` against the plain version and timed on the
    route's captured sub-batches, on n = 1024 and 8192 stabs against the
    cell's largest DR-tree level and a level of 2^20 areas; the planted
    fault; the sweep."""
    from repro_torch.kernels.interval import ops as iops
    from repro_torch.kernels.interval.ops import interval_query
    from repro_torch.kernels.interval.ref import interval_query_ref
    from repro_torch.kernels.u32 import to_device, to_numpy
    dev = eng.device
    s, g = max(((s, g) for s, sh in enumerate(eng.shards)
                for g in sh.tree.gloran.level_views()),
               key=lambda x: len(x[1]))
    cell = eng.shards[s].registry.gl_columns(
        g, eng.shards[s].tree.gloran.level_views())
    big = disjoint_level(rng, BIG_LEVEL)
    levels = {f"cell ({len(g)} areas)": (cell, [to_numpy(c) for c in cell]),
              "2^20 areas": (tuple(to_device(c, dev) for c in big), big)}

    for x in stabs:
        assert same(interval_query(*x), interval_query_ref(*x))
    ns = sorted(x[0].numel() for x in stabs)
    times = {"route": time_kernel_ms(rotate(interval_query, stabs))}
    log(f"interval_sm90, the route's {len(stabs)} captured sub-batches (n "
        f"{ns[0]}..{ns[-1]}, areas {sorted({x[2].numel() for x in stabs})})"
        f", rotated: {times['route']:.6f} ms {card}")
    inputs = {}
    for lname, (cols, host) in levels.items():
        m = cols[0].numel()
        for n in (1024, 8192):
            k, q = stab_queries(rng, host, n)
            x = (to_device(k, dev), to_device(q, dev), *cols)
            want = interval_query_ref(*x)
            assert same(interval_query(*x), want), (lname, n)
            name = f"{lname} n={n}"
            inputs[name] = x
            times[name] = {"ms": time_kernel_ms(lambda: interval_query(*x))}
            times[name]["floor"] = time_kernel_ms(
                lambda: iops._launch_floor(n, dev))
            by = 12 * n + SECTOR * (min(search_sectors(m, n), m // 8 + 1)
                                    + 3 * n)
            times[name]["bound"] = by / HBM_BYTES_PER_S * 1e3
            log(f"interval_sm90, {name} (padded to {m}, {int(want.sum())} "
                f"covered): bit-exact; {json.dumps(times[name])} ms {card}")

    name = next(iter(inputs))  # the cell's level at n = 1024
    x = inputs[name]
    n, m = x[0].numel(), x[2].numel()
    by = 12 * n + SECTOR * (min(search_sectors(m, n), m // 8 + 1) + 3 * n)
    rec = check_kernel("interval_sm90", launches["interval_sm90"],
                       lambda: interval_query(*x),
                       lambda: interval_query_ref(*x), by, card)
    rec["floor_ms"] = times[name]["floor"]
    rec["inputs_ms"] = times

    # Planted fault: lower_bound misses keys at area starts.
    lo_h = to_numpy(x[2])
    real = np.flatnonzero(lo_h < 0xFFFFFFFF)
    a = real[rng.integers(0, len(real), n)]
    k = lo_h[a]
    q = to_numpy(x[4])[a]
    xa = (to_device(k, dev), to_device(q, dev), *x[2:])
    want = interval_query_ref(*xa)
    assert want.any(), "no key at an area start is covered"
    diff = int((iops._launch_sm90(*xa, planted_fault=True) != want).sum())
    assert diff > 0, "interval_sm90 at lower_bound passes"
    log(f"interval_sm90 with lower_bound: {diff} of {n} stabs at area "
        f"starts differ: rejected")

    fails = []
    for cname, k, q, *cols in interval_cases(rng):
        x = (to_device(k, dev), to_device(q, dev),
             *(to_device(c, dev) for c in cols))
        want = interval_query_ref(*x)
        ok = same(interval_query(*x), want)
        if not ok:
            fails.append(cname)
        log(f"interval_sm90 sweep {cname} (n = {len(k)}, {len(cols[0])} "
            f"areas, {int(want.sum())} covered): bit-exact {ok}")
    assert not fails, f"interval_sm90 differs from the plain version: {fails}"
    return rec


def filter_checks(eng, batches, qk, launches, card, rng) -> list[dict]:
    """Phase 4's bloom and interval part: the route's sub-batches
    captured from per-level ``get_batch`` calls (outside the counted
    window) until both kernels have some, then both kernels."""
    blooms, stabs = [], []
    for batch in batches:
        b, i = capture_route(eng, batch)
        blooms += b
        stabs += i
        if blooms and stabs:
            break
    assert blooms and stabs, (len(blooms), len(stabs))
    return [bloom_checks(eng, qk, launches, card, rng, blooms),
            interval_checks(eng, launches, card, rng, stabs)]


# ---------------------------------------------------------- model phase
MODEL_ARCH = "zamba2-7b"
CHECK_PREFILL = (2, 128)  # f32 prefill held to teacher-forced decode
SERVE_PREFILL = (4, 2048)  # bf16; prefill_32k's 32 x 32768 is cut
SERVE_PROMPT, SERVE_STEPS = 8, 16
PREFILL_RUNS = 3  # timed bf16 prefills; the median is reported
F32_TOL = 1e-3  # max |prefill - decode| over the decode side's max |.|


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def launch_want(flash: int, ssd: int, variant: str) -> dict:
    """The model kernels' launches of a prefill that runs ``flash``
    attention and ``ssd`` SSD kernels of ``variant`` (the CUDA-core
    kernels "" in f32, the tensor-core ones "_sm90" in bf16), and never
    the other pair."""
    other = "_sm90" if not variant else ""
    return {"ssd" + variant: ssd, "flash_attention" + variant: flash,
            "ssd" + other: 0, "flash_attention" + other: 0}


def cache_shapes(cache: dict) -> dict:
    return {k: tuple(v.shape) for k, v in cache.items()}


def timed_prefills(model, inputs: dict, want: dict, card: str) -> dict:
    """A warm-up prefill (not counted: it grows the allocator's cache,
    so the timed runs measure the prefill and not cudaMalloc), then
    ``PREFILL_RUNS`` timed ones, each launching exactly ``want`` and
    returning finite logits and a cache of ``init_cache``'s shapes; the
    median, the peak memory and one prefill's time by kernel family are
    logged.  Returns one prefill's launches."""
    from repro_torch.kernels import native
    cfg = model.cfg
    b, s = next(iter(inputs.values())).shape[:2]
    kv = cache_shapes(model.init_cache(b, s, device="meta"))
    model.prefill(**inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(PREFILL_RUNS):
        native.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(**inputs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        expect_launches(native.LAUNCHES, want, f"{cfg.name} bf16 prefill")
        assert logits.shape == (b, 1, cfg.vocab), logits.shape
        assert torch.isfinite(logits).all() and all(
            torch.isfinite(v).all() for v in cache.values()), "non-finite"
        assert cache_shapes(cache) == kv, (cache_shapes(cache), kv)
        del logits, cache
    prefill_s = statistics.median(walls)
    log(f"bf16 prefill {b} x {s} tokens: {PREFILL_RUNS} runs of "
        f"{', '.join(f'{w:.6f}' for w in walls)} s, median "
        f"{prefill_s:.6f} s = {b * s / prefill_s:.1f} tokens/s; each "
        f"launched {json.dumps(want)}; peak memory "
        f"{torch.cuda.max_memory_allocated()} B {card}")
    free()
    log("bf16 prefill time by kernel family: " + time_breakdown(
        lambda: model.prefill(**inputs), card))
    free()
    return want


def serve_check(model, rng, card: str, tag: str) -> None:
    """``ServeLoop`` over 4 sessions registered in a ``SessionRegistry``
    on ``cuda`` for ``SERVE_STEPS`` steps (decode ms a step, tokens/s),
    then one decode step's time by kernel family."""
    from repro_torch.kernels import native
    from repro_torch.runtime import ServeLoop, SessionRegistry
    cfg = model.cfg
    b = SERVE_PREFILL[0]
    reg = SessionRegistry(strategy="gloran", device="cuda")
    sessions = np.arange(b, dtype=np.uint64) + 1000
    for sid in sessions:
        reg.register(int(sid), np.arange(8), np.arange(8) + sid)
    loop = ServeLoop(model, batch=b, max_len=SERVE_PROMPT + SERVE_STEPS,
                     registry=reg)
    prompts = rng.integers(0, cfg.vocab, (b, SERVE_PROMPT)).astype(np.int32)
    native.reset_launches()
    out = loop.run(prompts, steps=SERVE_STEPS, session_ids=sessions)
    serve_launches = dict(native.LAUNCHES)
    st = loop.stats
    assert out.shape == (b, SERVE_STEPS) and (out >= 0).all() \
        and (out < cfg.vocab).all(), out
    assert st.registry_lookups == b * SERVE_STEPS, st
    found, vals = reg.lookup(sessions, np.zeros(b, np.uint64))
    assert found.all() and (vals == sessions).all(), (found, vals)
    steps = SERVE_PROMPT + SERVE_STEPS
    log(f"ServeLoop ({tag}): {b} sessions, {SERVE_PROMPT}-token prompts "
        f"fed by decode, {SERVE_STEPS} steps in {st.wall_seconds:.6f} s = "
        f"{1e3 * st.wall_seconds / steps:.3f} ms a decode step, "
        f"{st.tokens_generated / st.wall_seconds:.3f} generated tokens/s; "
        f"registry lookups {st.registry_lookups}, io reads "
        f"{st.registry_io_reads}, stall {st.registry_stall_seconds:.6f} s; "
        f"launches {json.dumps(serve_launches)} {card}")
    cache = model.init_cache(b, 64)
    tok = torch.as_tensor(prompts[:, :1], device="cuda")
    with torch.inference_mode():
        log("bf16 decode step time by kernel family: " + time_breakdown(
            lambda: model.decode_step(tok, cache, 0), card))
    reg.engine.close()
    del cache
    free()


def card_vs_cpu(model, inputs: dict, want: dict, run=None) -> tuple:
    """An f32 model's prefill on the card, launching exactly ``want``,
    then the same model moved to the CPU (``.to``) on the same inputs,
    launching nothing: the largest ``|card - CPU| / max |CPU|`` of the
    logits and of every cache entry must be within ``F32_TOL``.
    ``run(model, **inputs)`` gives (logits, cache, anything else to
    compare), the prefill by default; the model ends on the CPU.
    Returns (the errors, both sides' extras, the CPU side's seconds)."""
    from repro_torch.kernels import native
    run = run or (lambda m, **kw: (*m.prefill(**kw), None))
    cfg = model.cfg
    native.reset_launches()
    logits, cache, card_extra = run(model, **{k: v.cuda() for k, v in
                                              inputs.items()})
    torch.cuda.synchronize()
    expect_launches(native.LAUNCHES, want, f"{cfg.name} f32 prefill")
    on_card = {"logits": logits.cpu(), **{k: v.cpu() for k, v in
                                          cache.items()}}
    del logits, cache
    before = dict(native.LAUNCHES)
    t0 = time.perf_counter()
    model.to("cpu")
    free()
    assert model.device.type == "cpu"
    logits, cache, cpu_extra = run(model, **inputs)
    cpu_s = time.perf_counter() - t0
    assert dict(native.LAUNCHES) == before, "the CPU path launched a kernel"
    on_cpu = {"logits": logits, **cache}
    b = next(iter(inputs.values())).shape[0]
    assert logits.shape == (b, 1, cfg.vocab) and all(
        torch.isfinite(v).all() for v in on_card.values()), "non-finite"
    errs = {k: rel_err(on_card[k], on_cpu[k]) for k in on_cpu}
    bad = {k: e for k, e in errs.items() if not e <= F32_TOL}
    assert not bad, f"{cfg.name}: card vs CPU beyond {F32_TOL}: {bad}"
    return errs, (card_extra, cpu_extra), cpu_s


def time_breakdown(fn, card: str) -> str:
    """Device time of one call by kernel family, from the profiler, and
    the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fams: dict[str, list] = {}
    other: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us <= 0:
            continue
        fam = kernel_family(e.key)
        f = fams.setdefault(fam, [0.0, 0])
        f[0] += us
        f[1] += e.count
        if fam == "other":
            other[e.key[:60]] = us
    if not fams:
        return "device time not measured (the profiler saw no kernels)"
    busy = sum(v[0] for v in fams.values())
    parts = "; ".join(f"{k} {v[0]:.1f} us / {v[1]} launches"
                      for k, v in sorted(fams.items(), key=lambda x: -x[1][0]))
    top = "; ".join(f"{k} {us:.1f} us" for k, us in
                    sorted(other.items(), key=lambda x: -x[1])[:5])
    return (f"wall {wall_us:.1f} us, device busy {busy:.1f} us "
            f"({100 * busy / wall_us:.3f}%): {parts} {card}; largest "
            f"other: {top}")


def kernel_family(name: str) -> str:
    k = name.lower()
    if "ssd_sm90" in k:
        return "ssd_sm90"
    if "flash_sm90" in k:
        return "flash_sm90"
    if "ssd_chunk" in k:
        return "ssd"
    if "flash_kernel" in k:
        return "flash"
    if any(w in k for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas",
                            "sm90_")):
        return "matmul"
    if "memcpy" in k or "memset" in k:
        return "copy"
    if any(w in k for w in ("index", "sort", "topk", "scatter", "gather")):
        return "index/sort"  # MoE routing, dispatch, combine; embeddings
    if "elementwise" in k or "vectorized" in k:
        return "elementwise"
    if "reduce" in k:
        return "reduce"
    if "cat" in k:
        return "cat"
    return "other"


def model_phase(seed: int, card: str) -> dict:
    """Phase 5: zamba2-7b at full width and depth on the card, through
    the port's serving entry points.  Returns the prefill's launches."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import native
    from repro_torch.models import Transformer, count_params, param_specs

    cfg = get_config(MODEL_ARCH)
    n_params = count_params(param_specs(cfg))
    rng = np.random.default_rng(seed)

    # f32: the prefill (through the kernels) against a teacher-forced
    # decode loop over the same tokens (no kernel on that path).
    cfg32 = replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    model = Transformer(cfg32, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"{MODEL_ARCH} f32: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters built in {time.perf_counter() - t0:.3f} s; "
        f"{torch.cuda.memory_allocated()} B allocated {card}")
    b, s = CHECK_PREFILL
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                           device="cuda")
    native.reset_launches()
    logits, cache = model.prefill(toks)
    torch.cuda.synchronize()
    n_attn = cfg.n_layers // cfg.hybrid_attn_every
    got = launch_want(n_attn, cfg.n_layers, "")
    expect_launches(native.LAUNCHES, got, f"{MODEL_ARCH} f32 prefill")
    dcache = model.init_cache(b, s)
    with torch.inference_mode():
        for t in range(s):
            dl, dcache = model.decode_step(toks[:, t:t + 1], dcache, t)
    torch.cuda.synchronize()
    assert all(native.LAUNCHES[k] == v for k, v in got.items()), \
        f"decode launched a model kernel: {native.LAUNCHES}"
    errs = {"logits": rel_err(logits, dl)}
    errs.update({k: rel_err(cache[k], dcache[k]) for k in cache})
    assert logits.shape == (b, 1, cfg.vocab) and all(
        torch.isfinite(v).all() for v in (logits, *cache.values())), \
        "non-finite prefill"
    bad = {k: e for k, e in errs.items() if not e <= F32_TOL}
    assert not bad, f"prefill vs decode beyond {F32_TOL}: {bad}"
    log(f"f32 prefill {b} x {s} launched {json.dumps(got)}; equals the "
        f"teacher-forced decode within {F32_TOL} (max |diff| / max |.|): "
        f"{json.dumps(errs)}")
    del model, logits, cache, dl, dcache
    free()

    # bf16, the config's type: a timed prefill, then the serve loop
    # over four sessions registered in the GLORAN registry on the card.
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"{MODEL_ARCH} bf16 built in {time.perf_counter() - t0:.3f} s; "
        f"{torch.cuda.memory_allocated()} B allocated {card}")
    b, s = SERVE_PREFILL
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                           device="cuda")
    launches = timed_prefills(model, {"tokens": toks},
                              launch_want(n_attn, cfg.n_layers, "_sm90"),
                              card)
    serve_check(model, rng, card, MODEL_ARCH)
    del model
    free()
    return {k: got[k] + launches[k] for k in got}


# ------------------------------------------------------- MoE serve cell
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 24  # of 32: 70.2 GB of bf16 weights (all 32: 93.4 GB)
MOE_CHECK = (2, 2, 128)  # f32 layers, batch, tokens: card against CPU
MOE_RESERVE = 8e9  # bytes left free for the bf16 prefill's activations


def moe_drops(x, router_w, top_k: int, capacity_factor: float) -> list:
    """The (token, expert) pairs ``moe_ffn`` drops for these inputs,
    recomputed in plain torch from the JAX package's steps
    (``src/repro/models/moe.py:34-53``): top-k of the f32 router logits,
    a stable sort by expert, each pair's rank within its expert, and the
    capacity expression."""
    t, e = x.shape[0] * x.shape[1], router_w.shape[-1]
    logits = x.reshape(t, -1).float() @ router_w.float()
    flat_e = torch.topk(logits, top_k, dim=-1).indices.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * top_k, device=x.device) - offsets[flat_e[order]]
    cap = int(max(8, -(-(t * top_k) // e * capacity_factor)))
    cap = -(-cap // 8) * 8
    drop = rank >= cap
    return sorted(zip((order[drop] // top_k).tolist(),
                      flat_e[order][drop].tolist()))


@contextlib.contextmanager
def wrap_moe_ffn(on_call):
    """Wrap the name ``moe_ffn`` that ``repro_torch.models.model`` calls:
    ``on_call(x, router_w, *weights, top_k=, capacity_factor=, shared=)``
    sees each call's inputs before the real function runs."""
    from repro_torch.models import model as model_mod
    real = model_mod.moe_ffn

    def wrapped(*args, **kw):
        on_call(*args, **kw)
        return real(*args, **kw)

    model_mod.moe_ffn = wrapped
    try:
        yield
    finally:
        model_mod.moe_ffn = real


def prefill_dropping(model, toks) -> tuple:
    """(logits, cache, the pairs each layer's capacity dropped)."""
    drops = []
    with wrap_moe_ffn(lambda x, r, *w, top_k, capacity_factor, **kw:
                      drops.append(moe_drops(x, r, top_k, capacity_factor))):
        logits, cache = model.prefill(toks)
    return logits, cache, drops


def moe_check(cfg, seed: int, rng, card: str) -> dict:
    """Phase 5b's f32 check at full width: the card's prefill held to the
    port's CPU path on the same weights (``card_vs_cpu``), with the same
    pairs dropped.  A prefill against a teacher-forced decode does not
    hold for MoE: the capacity depends on the token count, so the two
    may drop different pairs."""
    from dataclasses import replace
    from repro_torch.models import Transformer
    from repro_torch.models.moe import capacity

    n_layers, b, s = MOE_CHECK
    model = Transformer(replace(cfg, n_layers=n_layers, dtype="float32"),
                        device="cuda", seed=seed)
    log(f"{MOE_ARCH} f32 check model: {n_layers} layers at full width, "
        f"{torch.cuda.memory_allocated()} B allocated {card}")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
    want = launch_want(n_layers, 0, "")
    errs, (card_drops, cpu_drops), cpu_s = card_vs_cpu(
        model, {"toks": toks}, want,
        run=lambda m, toks: prefill_dropping(m, toks))
    n_card, n_cpu = [len(d) for d in card_drops], [len(d) for d in cpu_drops]
    m = cfg.moe
    log(f"f32 prefill {b} x {s}, {n_layers} layers: launched "
        f"{json.dumps(want)}; card against the CPU path (moved and run in "
        f"{cpu_s:.3f} s; max |diff| / max |.|): {json.dumps(errs)}; pairs "
        f"dropped a layer: card {n_card}, CPU {n_cpu} (capacity "
        f"{capacity(b * s, m.top_k, m.n_experts, m.capacity_factor)} an "
        f"expert, {b * s * m.top_k} pairs over {m.n_experts} experts)")
    assert n_card == n_cpu, f"dropped pairs differ: {n_card} / {n_cpu}"
    assert card_drops == cpu_drops, "the card and the CPU drop other pairs"
    del model
    free()
    return want


def moe_depth(cfg, card: str) -> int:
    """``MOE_LAYERS``, or fewer if the card's free memory (less
    ``MOE_RESERVE``) cannot hold them in bf16."""
    from dataclasses import replace
    from repro_torch.models import count_params, param_specs
    fixed = count_params(param_specs(replace(cfg, n_layers=0)))
    per_layer = count_params(param_specs(replace(cfg, n_layers=1))) - fixed
    free_b, total_b = torch.cuda.mem_get_info()
    fit = int((free_b - MOE_RESERVE - 2 * fixed) // (2 * per_layer))
    log(f"{MOE_ARCH}: {free_b} B of {total_b} free before the build, "
        f"{torch.cuda.memory_allocated()} B allocated; a layer "
        f"{per_layer} parameters ({2 * per_layer} B in bf16), embed and "
        f"head {fixed}; {fit} layers fit beside {MOE_RESERVE:.0f} B "
        f"{card}")
    assert fit >= 1, "not one layer fits"
    return min(MOE_LAYERS, fit)


def moe_split(inputs: tuple, card: str) -> str:
    """Device time of one MoE layer of the bf16 prefill by step, on the
    inputs it was given: routing (router product, top-k, stable sort,
    ranks), the dispatch scatter, the expert products (three batched
    matmuls and the SiLU), and the combine (gather and scatter-add)."""
    from repro_torch.models import moe
    x, router, wg, wu, wd, top_k, cf = inputs
    t, d = x.shape[0] * x.shape[1], x.shape[-1]
    e = router.shape[-1]
    xf = x.reshape(t, d)
    cap = moe.capacity(t, top_k, e, cf)
    _, gates, top_idx = moe.route(xf, router, top_k)
    order, e_sorted, rank = moe.dispatch_order(top_idx, e)
    tok = order // top_k
    g_sorted = gates.reshape(-1)[order]
    buf, keep, slot = moe.dispatch(xf, e_sorted, tok, rank, cap, e)
    out_buf = moe.experts(buf, wg, wu, wd)
    ms = {"routing": time_kernel_ms(lambda: moe.dispatch_order(
              moe.route(xf, router, top_k)[2], e), 10),
          "dispatch": time_kernel_ms(
              lambda: moe.dispatch(xf, e_sorted, tok, rank, cap, e), 10),
          "experts": time_kernel_ms(
              lambda: moe.experts(buf, wg, wu, wd), 10),
          "combine": time_kernel_ms(lambda: moe.combine(
              out_buf, e_sorted, slot, keep, tok, g_sorted, t), 10)}
    flops = 3 * 2 * e * cap * d * wg.shape[-1]
    return (f"one MoE layer (t = {t}, capacity {cap} of {e} experts, "
            f"{int((~keep).sum())} pairs dropped): "
            + ", ".join(f"{k} {v:.6f} ms" for k, v in ms.items())
            + f"; the expert products' {flops} FLOP bound "
            f"{flops / BF16_TENSOR_FLOPS * 1e3:.6f} ms {card}")


def moe_phase(seed: int, card: str) -> dict:
    """Phase 5b: mixtral-8x7b at full width through the port's serving
    entry points, depth cut to what the card holds.  Returns the
    launches of the f32 check's prefill and of one bf16 prefill."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, count_params, param_specs

    cfg = get_config(MOE_ARCH)
    rng = np.random.default_rng(seed)
    free()
    check = moe_check(cfg, seed, rng, card)

    n_layers = moe_depth(cfg, card)
    cfg = replace(cfg, n_layers=n_layers)
    n_params = count_params(param_specs(cfg))
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"{MOE_ARCH} bf16: {n_layers} of 32 layers, d_model {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
        f"{cfg.moe.d_expert}, {n_params} parameters built in "
        f"{time.perf_counter() - t0:.3f} s; {torch.cuda.memory_allocated()} "
        f"B allocated {card}")
    b, s = SERVE_PREFILL
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                           device="cuda")
    launches = timed_prefills(model, {"tokens": toks},
                              launch_want(n_layers, 0, "_sm90"), card)
    layer_in = []
    with wrap_moe_ffn(lambda x, r, wg, wu, wd, *, top_k, capacity_factor,
                      **kw: layer_in or layer_in.append(
                          (x, r, wg, wu, wd, top_k,
                           capacity_factor))):
        model.prefill(toks)
    log("bf16 prefill, " + moe_split(layer_in[0], card))
    del layer_in
    free()

    serve_check(model, rng, card, f"{MOE_ARCH}, {n_layers} layers")
    del model
    free()
    return {k: check[k] + launches[k] for k in launches}


# ------------------------------------- the other configurations (5d)
ZOO = {  # arch: (flash_attention_sm90, ssd_sm90) launches a bf16 prefill
    "gemma3-1b": (4, 0),  # its global layers; the local ones go banded
    "h2o-danube-3-4b": (24, 0),
    "chatglm3-6b": (28, 0),
    "minitron-8b": (32, 0),
    "mamba2-130m": (0, 24),
    "musicgen-large": (48, 0),
    "paligemma-3b": (18, 0),
}
ZOO_CHECK_LAYERS = 2  # f32, at CHECK_PREFILL: card against CPU


def model_inputs(cfg, rng, b: int, s: int) -> dict:
    """Tokens, or standard-normal embeddings for a stub frontend, on the
    host."""
    if cfg.stub_frontend is not None:
        return {"embeds": torch.as_tensor(rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32))}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))}


def embeds_decode(model, rng, card: str) -> None:
    """A stub-frontend model's decode (the serve CLI and ``ServeLoop``
    take tokens): ``decode_step`` on standard-normal embeddings at
    batch 4 for ``SERVE_STEPS`` steps."""
    from repro_torch.kernels import native
    cfg = model.cfg
    b = SERVE_PREFILL[0]
    x = model_inputs(cfg, rng, b, SERVE_STEPS)["embeds"].cuda()
    cache = model.init_cache(b, SERVE_STEPS)
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SERVE_STEPS):
        logits, cache = model.decode_step(x[:, t:t + 1], cache, t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert logits.shape == (b, 1, cfg.vocab) and \
        torch.isfinite(logits).all(), "non-finite decode"
    log(f"decode_step on embeddings ({cfg.name}): batch {b}, "
        f"{SERVE_STEPS} steps in {wall:.6f} s = "
        f"{1e3 * wall / SERVE_STEPS:.3f} ms a step, "
        f"{b * SERVE_STEPS / wall:.3f} tokens/s; launches "
        f"{json.dumps(dict(native.LAUNCHES))} {card}")
    del cache, logits
    free()


def zoo_config(arch: str, seed: int, card: str) -> dict:
    """One configuration of phase 5d: the f32 check at 2 layers, then
    bf16 at full depth (prefills, decode).  Returns the launches of the
    check and of one bf16 prefill."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, count_params, param_specs

    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    n = ZOO_CHECK_LAYERS
    model = Transformer(replace(cfg, n_layers=n, dtype="float32"),
                        device="cuda", seed=seed)
    attn = 0 if cfg.family == "ssm" else n
    want = launch_want(attn, n - attn, "")
    errs, _, cpu_s = card_vs_cpu(model, model_inputs(cfg, rng,
                                                     *CHECK_PREFILL), want)
    log(f"{arch} f32, {n} layers at full width: prefill "
        f"{CHECK_PREFILL[0]} x {CHECK_PREFILL[1]} launched "
        f"{json.dumps(want)}; card against the CPU path (moved and run in "
        f"{cpu_s:.3f} s; max |diff| / max |.|): {json.dumps(errs)}")
    del model
    free()

    torch.cuda.reset_peak_memory_stats()
    n_params = count_params(param_specs(cfg))
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"{arch} bf16: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params} parameters built in "
        f"{time.perf_counter() - t0:.3f} s; {torch.cuda.memory_allocated()} "
        f"B allocated {card}")
    flash, ssd = ZOO[arch]
    inputs = {k: v.cuda() for k, v in
              model_inputs(cfg, rng, *SERVE_PREFILL).items()}
    launches = timed_prefills(model, inputs, launch_want(flash, ssd, "_sm90"),
                              card)
    del inputs
    if cfg.stub_frontend is not None:
        embeds_decode(model, rng, card)
    else:
        serve_check(model, rng, card, arch)
    log(f"{arch}: {n_params} parameters, peak memory "
        f"{torch.cuda.max_memory_allocated()} B over the bf16 build, "
        f"prefills and decode {card}")
    del model
    free()
    return {k: want.get(k, 0) + launches[k] for k in launches}


def zoo_phase(seed: int, card: str) -> dict:
    """Phase 5d: the seven configurations not served in phases 5 and 5b,
    one at a time, the card's memory freed between them.  Returns the
    model kernels' launches of their checks and bf16 prefills."""
    t0 = time.perf_counter()
    total: dict = {}
    for arch in ZOO:
        free()
        for k, v in zoo_config(arch, seed, card).items():
            total[k] = total.get(k, 0) + v
    log(f"phase 5d: {time.perf_counter() - t0:.3f} s; launches "
        f"{json.dumps(total)}")
    return total


# ------------------------------------------ workload harness (host only)
FIG9_BALANCED = dict(  # benchmarks/fig9_throughput.py: balanced, rd 5%
    lookup=0.5, update=0.45, range_delete=0.05, range_delete_len=128,
    universe=1 << 21)
FIG9_PRELOAD, FIG9_OPS, FIG9_SEED = 150_000, 20_000, 5
STRATEGIES = ("decomp", "lookup_delete", "scan_delete", "lrr", "gloran")
VERSIONS, SAMPLES, PURGED = 8, 100_000, (2, 5)


def workload_phase(seed: int) -> None:
    """Phase 5c, on the host: fig9's balanced mix through the port's
    ``make_tree`` / ``run_workload`` for every strategy (the same op
    stream, so one lookup batch afterwards must answer alike), then a
    ``VersionedSampleStore`` held to a plain model."""
    from repro_torch.baselines import WorkloadMix, make_tree, run_workload
    from repro_torch.data import VersionedSampleStore

    u = FIG9_BALANCED["universe"]
    probe = np.random.default_rng(seed).integers(0, u, LOOKUP_BATCH) \
        .astype(np.uint64)
    answers = {}
    for strat in STRATEGIES:
        tree = make_tree(strat, buffer_capacity=4096, size_ratio=10,
                         universe=u)
        pre = np.random.default_rng(0)  # benchmarks/harness.py's preload
        t0 = time.perf_counter()
        n_pre = 0
        for _ in range(0, FIG9_PRELOAD, PUT_BATCH):
            keys = pre.integers(0, u, size=PUT_BATCH).astype(np.uint64)
            tree.put_batch(keys, keys * np.uint64(31) + np.uint64(7))
            n_pre += PUT_BATCH
        pre_s = time.perf_counter() - t0
        res = run_workload(tree, FIG9_OPS, WorkloadMix(**FIG9_BALANCED),
                           seed=FIG9_SEED)
        answers[strat] = tree.get_batch(probe)
        log(f"fig9 balanced rd5 {strat} (host, not device): {n_pre} "
            f"preloaded in {pre_s:.3f} s; {res.n_ops} ops in "
            f"{res.wall_seconds:.6f} s = {res.ops_per_sec:.1f} ops/s "
            f"(modeled at 20 us an I/O {res.modeled_ops_per_sec():.1f}); "
            f"I/O per op: lookup {res.io_per_op('lookup'):.6f}, range "
            f"delete {res.io_per_op('range_delete'):.6f}, update "
            f"{res.io_per_op('update'):.6f}; reads {res.io_reads}, writes "
            f"{res.io_writes}; ops {json.dumps(res.counts_by_type)}")
    found, vals = answers["gloran"]
    for strat, (f, v) in answers.items():
        assert np.array_equal(f, found), f"{strat}: other keys found"
        assert np.array_equal(v[f], vals[found]), f"{strat}: other values"
    log(f"all {len(STRATEGIES)} strategies answer a lookup batch of "
        f"{len(probe)} alike ({int(found.sum())} found)")

    rng = np.random.default_rng(seed)
    store = VersionedSampleStore(strategy="gloran")
    model = {}
    t0 = time.perf_counter()
    for v in range(VERSIONS):
        ids = rng.permutation(SAMPLES).astype(np.uint64)
        pay = rng.integers(0, 1 << 62, SAMPLES).astype(np.uint64)
        store.publish(v, ids, pay)
        model[v] = pay[np.argsort(ids)]
    publish_s = time.perf_counter() - t0
    reads0 = store.tree.io.reads
    t0 = time.perf_counter()
    for v in PURGED:
        store.purge_version(v)
        del model[v]
    purge_s = time.perf_counter() - t0
    purge_reads = store.tree.io.reads - reads0
    assert store.live_versions == set(model)
    q = rng.integers(0, SAMPLES + SAMPLES // 8, LOOKUP_BATCH)
    for v in range(VERSIONS):
        f, vals = store.get_batch(v, q)
        want = (q < SAMPLES) & (v in model)
        assert np.array_equal(f, want), f"version {v}: found"
        if v in model:
            assert np.array_equal(vals[f], model[v][q[want]]), v
        keys, vals = store.scan_version(v)
        if v in model:
            assert np.array_equal(keys, (np.uint64(v) << np.uint64(40))
                                  | np.arange(SAMPLES, dtype=np.uint64))
            assert np.array_equal(vals, model[v]), f"version {v}: scan"
        else:
            assert len(keys) == 0, f"purged version {v} scans {len(keys)}"
    log(f"VersionedSampleStore (host, not device): {VERSIONS} versions of "
        f"{SAMPLES} samples published in {publish_s:.3f} s; purging "
        f"versions {PURGED} took {purge_s:.6f} s and {purge_reads} block "
        f"reads; lookups and "
        f"scan_version equal the plain model")


# Kernel against plain version.  SSD: f32 sums in another order, within
# SSD_TOL of the output's largest magnitude.  Flash in bf16: both sides
# sum in f32 and round once to bf16, so an element may differ by one
# bf16 ulp, at most 2^-7 of its magnitude; 2^-12 covers outputs near 0.
SSD_TOL = 1e-4
FLASH_BF16_TOL = (2 ** -12, 2 ** -7)  # (atol, rtol), elementwise
FLASH_F32_TOL = 1e-4  # max abs
SSD_SWEEP = [  # (b, s, h, p, n, chunk)
    (1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 128),
    (2, 256, 3, 64, 128, 128), (4, 2048, 112, 64, 64, 128),
    (2, 1024, 24, 64, 128, 128)]  # mamba2-130m's heads and state
FLASH_SWEEP = [  # (b, sq, skv, hq, hkv, d, causal, window)
    (1, 128, 128, 4, 4, 64, True, None), (2, 256, 256, 8, 2, 64, True, None),
    (1, 128, 128, 4, 1, 128, True, 64), (2, 100, 100, 4, 2, 64, True, None),
    (1, 64, 320, 4, 2, 64, True, None), (1, 128, 128, 4, 4, 64, False, None),
    (2, 96, 96, 4, 4, 112, True, None), (1, 130, 130, 4, 2, 112, True, 48),
    (1, 40, 40, 2, 2, 256, True, None), (1, 33, 33, 2, 1, 20, False, 7),
    (1, 8, 5, 2, 2, 16, True, None), (4, 2048, 2048, 32, 32, 112, True, None),
    # the tensor-core kernel's edges: ragged q tiles with Skv > Sq,
    # danube3's D = 120 with GQA 4 and window 4096, gemma3's D = 256 with
    # one kv head and window 512, D = 64 without the mask
    (2, 300, 500, 4, 2, 112, True, None),
    (1, 4608, 4608, 8, 2, 120, True, 4096),
    (1, 1024, 1024, 4, 1, 256, True, 512),
    (2, 512, 512, 4, 4, 64, False, None)]


def ssd_inputs(b, s, h, p, n, q, dtype, g):
    """x, dac, dt, B, C as a Mamba2 layer hands them to the SSD kernel:
    dt in [1e-3, 0.101], A in -[1, 16], dac the per-chunk cumsum."""
    x = torch.randn(b, s, h, p, device="cuda", generator=g).to(dtype)
    Bm, Cm = (torch.randn(b, s, n, device="cuda", generator=g).to(dtype)
              for _ in range(2))
    dt = torch.rand(b, s, h, device="cuda", generator=g) * 0.1 + 1e-3
    A = -(torch.rand(h, device="cuda", generator=g) * 15 + 1)
    dac = torch.cumsum((dt * A).reshape(b, s // q, q, h), 2).reshape(b, s, h)
    return x, dac, dt, Bm, Cm


def model_kernel_checks(launches: dict, seed: int, card: str) -> list:
    """Phase 6: the model kernels against their plain versions at the
    shapes the bf16 prefill gives them: the tensor-core kernels through
    the public wrappers, the CUDA-core kernels on the same inputs through
    their private launch functions; planted faults that the tolerances
    must reject; then a sweep of other shapes in f32 and bf16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import native
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_ref
    from repro_torch.kernels.ssd import ops as ssd_ops

    cfg = get_config(MODEL_ARCH)
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    b, s = SERVE_PREFILL
    h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    p, n, q = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk
    x, dac, dt, Bm, Cm = ssd_inputs(b, s, h, p, n, q, bf, g)
    cells = b * h * (s // q)
    tri = q * (q + 1) // 2
    ssd_bytes = (2 * x.numel() + 4 * 2 * dt.numel() + 2 * 2 * Bm.numel()
                 + 4 * x.numel() + 4 * cells * n * p)
    ssd_ops_n = cells * (2 * tri * n + 2 * tri * p + 2 * q * n * p)
    want = ssd_chunks_ref(x, dac, dt, Bm, Cm, chunk=q)
    tol = SSD_TOL * float(max(want[0].abs().max(), want[1].abs().max()))
    assert ssd_ops.kernel_for(bf, p, n, q) == "ssd_sm90"
    simt = check_kernel(
        "ssd", launches["ssd"],
        lambda: ssd_ops._launch_simt(x, dac, dt, Bm, Cm, q),
        lambda: ssd_chunks_ref(x, dac, dt, Bm, Cm, chunk=q), ssd_bytes,
        card, ops=ssd_ops_n, tol=tol)
    sm90 = check_kernel(
        "ssd_sm90", launches["ssd_sm90"],
        lambda: ssd_chunks(x, dac, dt, Bm, Cm, chunk=q),
        lambda: ssd_chunks_ref(x, dac, dt, Bm, Cm, chunk=q), ssd_bytes,
        card, ops=ssd_ops_n, tol=tol)
    sm90["simt_ms"] = simt["ms"]
    sm90["floor_ms"] = time_kernel_ms(
        lambda: ssd_ops._launch_floor(b, s, h, p, n, q, "cuda"))
    log(f"ssd_sm90's empty kernel on its grid (the launch floor, a "
        f"reading) {sm90['floor_ms']:.6f} ms {card}")
    records = [simt, sm90]
    # A plausible wrong kernel that SSD_TOL must reject: the diagonal
    # u == t left out of the causal mask.
    wrong = ssd_ops._launch_sm90(x, dac, dt, Bm, Cm, q, planted_fault=True)
    used = allowance_used(wrong, want, tol)
    assert used > 1, f"SSD tolerance passes the diagonal left out ({used})"
    log(f"ssd_sm90 with the diagonal left out of the mask: max abs err "
        f"{max_abs_err(wrong, want)}, {used} of the tolerance used: "
        f"rejected")
    del x, Bm, Cm, dt, dac, want, wrong
    free()

    hq, d = cfg.n_heads, cfg.head_dim_
    qq, kk, vv = (torch.randn(b, s, hq, d, device="cuda", generator=g)
                  .to(bf) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qq, kk, vv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_bytes = 2 * 4 * qq.numel()
    flash_ops_n = 4 * d * b * hq * (s * (s + 1) // 2)
    atol, rtol = FLASH_BF16_TOL
    assert flash_ops.kernel_for(bf, d, hq, hq) == "flash_attention_sm90"
    simt = check_kernel(
        "flash_attention", launches["flash_attention"],
        lambda: flash_ops._launch_simt(qq, kk, vv, None, True, None),
        lambda: attention_ref(qq, kk, vv, causal=True), flash_bytes, card,
        ops=flash_ops_n, tol=atol, rtol=rtol,
        library=lambda: sdpa(qt, kt, vt, is_causal=True))
    sm90 = check_kernel(
        "flash_attention_sm90", launches["flash_attention_sm90"],
        lambda: flash_attention(qq, kk, vv, causal=True),
        lambda: attention_ref(qq, kk, vv, causal=True), flash_bytes, card,
        ops=flash_ops_n, tol=atol, rtol=rtol,
        library=lambda: sdpa(qt, kt, vt, is_causal=True))
    sm90["simt_ms"] = simt["ms"]
    sm90["floor_ms"] = time_kernel_ms(
        lambda: flash_ops._launch_floor(b, s, hq, d, "cuda"))
    log(f"flash_attention_sm90's empty kernel on its grid (the launch "
        f"floor, a reading) {sm90['floor_ms']:.6f} ms {card}")
    records += [simt, sm90]
    want = attention_ref(qq, kk, vv, causal=True)
    # SDPA's reading (not a check): how much of the tolerance a library
    # kernel with a bf16 P uses at this shape.
    lib = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
    log(f"scaled_dot_product_attention at this shape: max abs err "
        f"{max_abs_err(lib, want)}, {allowance_used(lib, want, atol, rtol)} "
        f"of the flash tolerance used (a reading, not a check) {card}")
    # The tolerance must reject a plausible wrong kernel: the new kernel
    # itself with the softmax scale of D padded to a power of two.
    padded = 1 << (d - 1).bit_length()
    n0 = native.LAUNCHES["flash_attention_sm90"]
    wrong = flash_attention(qq, kk, vv, causal=True, scale=padded ** -0.5)
    assert native.LAUNCHES["flash_attention_sm90"] == n0 + 1
    used = allowance_used(wrong, want, atol, rtol)
    outside = float(((wrong.float() - want.float()).abs()
                     > atol + rtol * want.float().abs()).float().mean())
    assert padded != d and used > 1, \
        f"flash tolerance passes the scale of D = {padded} ({used})"
    log(f"flash_attention_sm90 with the scale of D = {padded}: max abs err "
        f"{max_abs_err(wrong, want)}, {used} of the tolerance used, "
        f"{100 * outside:.3f}% of elements outside it: rejected")
    del qq, kk, vv, qt, kt, vt, want, wrong, lib
    free()
    sm90["moe_shape"] = flash_moe_check(g, card)
    kernel_sweep(g)
    return records


def flash_moe_check(g, card: str) -> dict:
    """``flash_attention_sm90`` at phase 5b's bf16 prefill shape
    (mixtral-8x7b: 4 x 2048, 32 query heads over 8 KV heads of 128,
    causal, window 4096) against its plain version, beside SDPA and its
    floor, and the planted fault (the scale of another D) rejected."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import native
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as flash_ops

    cfg = get_config(MOE_ARCH)
    b, s = SERVE_PREFILL
    hq, hkv, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.window
    bf = torch.bfloat16
    qq = torch.randn(b, s, hq, d, device="cuda", generator=g).to(bf)
    kk, vv = (torch.randn(b, s, hkv, d, device="cuda", generator=g).to(bf)
              for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qq, kk, vv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = sum(min(i + 1, w) for i in range(s))  # causal, in the window
    atol, rtol = FLASH_BF16_TOL
    assert flash_ops.kernel_for(bf, d, hq, hkv) == "flash_attention_sm90"
    rec = check_kernel(
        "flash_attention_sm90", 0,
        lambda: flash_attention(qq, kk, vv, causal=True, window=w),
        lambda: attention_ref(qq, kk, vv, causal=True, window=w),
        2 * 2 * (qq.numel() + kk.numel()), card,
        ops=4 * d * b * hq * pairs, tol=atol, rtol=rtol,
        library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    rec = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}
    rec["floor_ms"] = time_kernel_ms(
        lambda: flash_ops._launch_floor(b, s, hq, d, "cuda"))
    rec["shape"] = [b, s, hq, hkv, d, w]
    log(f"flash_attention_sm90 at {MOE_ARCH}'s shape {rec['shape']}: "
        f"floor {rec['floor_ms']:.6f} ms, {rec['ms'] / rec['bound_ms']:.3f}"
        f"x its bound, {rec['ms'] / rec['library_ms']:.3f}x SDPA {card}")
    want = attention_ref(qq, kk, vv, causal=True, window=w)
    # The planted fault: at D = 128 the padded D is D itself, so the
    # wrong scale is that of one 64-column box.
    wrong_d = 1 << (d - 1).bit_length()
    wrong_d = wrong_d if wrong_d != d else 64
    n0 = native.LAUNCHES["flash_attention_sm90"]
    wrong = flash_attention(qq, kk, vv, causal=True, window=w,
                            scale=wrong_d ** -0.5)
    assert native.LAUNCHES["flash_attention_sm90"] == n0 + 1
    used = allowance_used(wrong, want, atol, rtol)
    assert used > 1, \
        f"flash tolerance passes the scale of D = {wrong_d} ({used})"
    log(f"flash_attention_sm90 at that shape with the scale of D = "
        f"{wrong_d}: max abs err {max_abs_err(wrong, want)}, {used} of the "
        f"tolerance used: rejected")
    del qq, kk, vv, qt, kt, vt, want, wrong
    free()
    return rec


def kernel_sweep(g) -> None:
    """Both model kernels against their plain versions over
    ``SSD_SWEEP`` and ``FLASH_SWEEP`` in f32 and bf16 (head dims 16 to
    256, GQA, windows, more keys than queries, non-causal); fails after
    logging every case if any is out of tolerance."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import \
        kernel_for as flash_kernel_for
    from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_ref
    from repro_torch.kernels.ssd.ops import kernel_for as ssd_kernel_for

    fails = []
    for shape in SSD_SWEEP:
        q = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(*shape, dtype, g)
            got = ssd_chunks(*args, chunk=q)
            torch.cuda.synchronize()
            want = ssd_chunks_ref(*args, chunk=q)
            used = max(allowance_used(a, w, SSD_TOL * float(w.abs().max()))
                       for a, w in zip(got, want))
            ok = used <= 1 and all(torch.isfinite(a).all() for a in got)
            if not ok:
                fails.append(("ssd", shape, dtype))
            log(f"ssd {shape} {dtype} ({ssd_kernel_for(dtype, *shape[3:])})"
                f": max abs err {max_abs_err(got, want)}, {used} of the "
                f"tolerance used")
    for shape in FLASH_SWEEP:
        b, sq, skv, hq, hkv, d, causal, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            qq = torch.randn(b, sq, hq, d, device="cuda", generator=g)
            kk, vv = (torch.randn(b, skv, hkv, d, device="cuda", generator=g)
                      for _ in range(2))
            qq, kk, vv = (t.to(dtype) for t in (qq, kk, vv))
            got = flash_attention(qq, kk, vv, causal=causal, window=window)
            torch.cuda.synchronize()
            want = attention_ref(qq, kk, vv, causal=causal, window=window)
            tol = ((FLASH_F32_TOL, 0.0) if dtype == torch.float32
                   else FLASH_BF16_TOL)
            used = allowance_used(got, want, *tol)
            ok = used <= 1 and got.dtype == dtype \
                and bool(torch.isfinite(got).all())
            if not ok:
                fails.append(("flash", shape, dtype))
            log(f"flash {shape} {dtype} "
                f"({flash_kernel_for(dtype, d, hq, hkv)}): max abs err "
                f"{max_abs_err(got, want)}, {used} of the tolerance used")
    free()
    assert not fails, f"kernels differ from their plain versions: {fails}"


# -------------------------------------------------------- training phase
TRAIN_CHECK = (2, 128)  # 7b: f32, one group at full width, card vs CPU
TRAIN_SEQ = 4096  # 7c: train_4k's sequence; its global batch 256 cut to 2
TRAIN_BATCH, TRAIN_MICRO = 2, 2  # two microbatches of one sequence
TRAIN_WARMUP, TRAIN_STEPS = 1, 4
TRAIN_RESERVE = 8 << 30  # bytes left beside the weights, at the least
TRAIN_MARGIN = 2 << 30  # beside a step's measured need, for fragmentation
TRAIN_BYTES = 16  # a parameter: bf16 weight and gradient, f32 m, v, sum
STEP_BYTES = 6  # of those, alive only in a step: the gradient and sum
LOOP_STEPS, LOOP_EVERY, LOOP_CRASH = 20, 5, 7  # 7d at the smoke config
LOOP_TOL = 1e-5  # resumed losses against the uninterrupted run's


def grads_of(fn, inputs, weights) -> list:
    """Gradients of ``sum(out * w)`` over ``fn``'s outputs with respect
    to every input; zeros where no gradient reaches an input (an output
    with no graph, as a wrapper that detaches gives)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    if not loss.requires_grad:
        return [torch.zeros_like(t) for t in leaves]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, leaves)]


def grad_used(got, want, rel: float) -> float:
    """The largest share of its tolerance (``rel`` of the plain
    gradient's largest magnitude) that any input's gradient uses."""
    return max(float((g.float() - w.float()).abs().max())
               / (rel * float(w.float().abs().max().clamp_min(1e-30)))
               for g, w in zip(got, want))


def grad_checks(records: list, seed: int, card: str) -> None:
    """Phase 7a: the gradient of ``(out * w).sum()`` through each model
    kernel's autograd Function (the kernel forward, the plain version's
    VJP) equals the gradient through the plain version at phase 6's
    shapes, each input's within the kernel's forward tolerance times
    that gradient's largest magnitude; a wrapper that detaches the
    kernel's output (the graph cut of the wrappers before) is rejected.
    Each kernel's record gains the gradient's error and share used."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_ref
    from repro_torch.kernels.ssd import ops as ssd_ops

    cfg = get_config(MODEL_ARCH)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    bf = torch.bfloat16
    b, s = SERVE_PREFILL
    h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    p, n, q = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk
    by_name = {r["name"]: r for r in records}

    def check(name, fn, plain, detached, inputs, rel):
        want = plain(*inputs)
        want = want if isinstance(want, tuple) else (want,)
        w = [torch.randn(o.shape, device="cuda", generator=g)
             for o in want]
        ref = grads_of(plain, inputs, w)
        got = grads_of(fn, inputs, w)
        used = grad_used(got, ref, rel)
        err = max(float((a.float() - r.float()).abs().max())
                  for a, r in zip(got, ref))
        assert used <= 1, f"{name}: gradient off the plain one ({used})"
        cut = grad_used(grads_of(detached, inputs, w), ref, rel)
        assert cut > 1, f"{name}: a detached output passes ({cut})"
        by_name[name].update(grad_max_abs_err=err, grad_tol_used=used)
        log(f"{name} gradient (kernel forward, plain VJP) against the plain "
            f"version's: max abs err {err}, {used} of {rel} x each "
            f"gradient's max used; a detached output uses {cut}: "
            f"rejected {card}")

    ssd_in = ssd_inputs(b, s, h, p, n, q, bf, g)
    plain = lambda *a: ssd_chunks_ref(*a, chunk=q)
    check("ssd_sm90", lambda *a: ssd_chunks(*a, chunk=q), plain,
          lambda *a: ssd_ops._launch(*(t.detach() for t in a), q),
          ssd_in, SSD_TOL)
    check("ssd", lambda *a: ssd_ops.SSDChunks.apply(
        ssd_ops._launch_simt, q, *a), plain,
        lambda *a: ssd_ops._launch_simt(*(t.detach() for t in a), q),
        ssd_in, SSD_TOL)
    del ssd_in
    free()
    hq, d = cfg.n_heads, cfg.head_dim_
    qkv = [torch.randn(b, s, hq, d, device="cuda", generator=g).to(bf)
           for _ in range(3)]
    plain = lambda *a: attention_ref(*a, causal=True)
    check("flash_attention_sm90",
          lambda *a: flash_attention(*a, causal=True), plain,
          lambda *a: flash_ops._launch(*(t.detach() for t in a), None,
                                       True, None),
          qkv, FLASH_BF16_TOL[1])
    check("flash_attention", lambda *a: flash_ops.FlashAttention.apply(
        flash_ops._launch_simt, None, True, None, *a), plain,
        lambda *a: flash_ops._launch_simt(*(t.detach() for t in a), None,
                                          True, None),
        qkv, FLASH_BF16_TOL[1])
    del qkv
    free()


def train_check(seed: int, card: str) -> dict:
    """Phase 7b: one AdamW ``make_train_step`` of zamba2-7b's first group
    at full width (6 Mamba2 layers and the shared block, no tail) in
    f32 on the card equals the CPU path on the same weights and batch
    within 1e-3 of each tensor's largest magnitude: loss, grad norm,
    every updated parameter and every first moment (0.1 x the clipped
    gradient).  Returns the card step's launches."""
    import copy
    from dataclasses import replace
    from repro_torch.carry import param_leaves
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import native
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Transformer
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.optim.optimizer import _get

    cfg = get_config(MODEL_ARCH)
    cfg = replace(cfg, dtype="float32", n_layers=cfg.hybrid_attn_every)
    b, s = TRAIN_CHECK
    data = TokenPipeline(PipelineConfig(vocab=cfg.vocab, global_batch=b,
                                        seq_len=s, seed=seed)).next()
    opt = OptimizerConfig(name="adamw", warmup_steps=10, decay_steps=1000)
    model = Transformer(cfg, device="cuda", seed=seed)
    cpu = copy.deepcopy(model).to("cpu")
    out = {}
    for side, m in (("cuda", model), ("cpu", cpu)):
        step = make_train_step(m, opt)
        state = adamw_init(param_leaves(m))
        batch = {k: torch.as_tensor(v, device=side) for k, v in data.items()}
        native.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        if side == "cuda":
            torch.cuda.synchronize()
            launches = dict(native.LAUNCHES)
        wall = time.perf_counter() - t0
        out[side] = (metrics, state, m)
        log(f"7b: {side} train step {b} x {s} f32: {wall:.3f} s, loss "
            f"{float(metrics['loss'])}, grad norm "
            f"{float(metrics['grad_norm'])} {card}")
    layers = cfg.n_layers
    want = {"ssd": 2 * layers, "flash_attention": 2, "ssd_sm90": 0,
            "flash_attention_sm90": 0}
    got = {k: launches[k] for k in want}
    assert got == want, (got, want)
    (mc, sc, gm), (mh, sh, hm) = out["cuda"], out["cpu"]
    errs = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
            for k in ("loss", "grad_norm")}
    for la, lb in zip(param_leaves(gm), param_leaves(hm)):
        mu_a = _get(sc["mu"], la.path)
        mu_b = _get(sh["mu"], la.path)
        errs["mu/" + la.path] = rel_err(mu_a.cpu(), mu_b)
        errs[la.path] = max(rel_err(x.detach().cpu(), y.detach())
                            for x, y in zip(la.parts, lb.parts))
    bad = {k: e for k, e in errs.items() if not e <= F32_TOL}
    assert not bad, f"card train step off the CPU path: {bad}"
    log(f"7b: {MODEL_ARCH} first group at full width ({layers} Mamba2 "
        f"layers + the shared block), f32: the card's train step equals "
        f"the CPU path within {F32_TOL} (largest: "
        f"{max(errs.items(), key=lambda kv: kv[1])}); loss "
        f"{errs['loss']}, grad norm {errs['grad_norm']} relative; "
        f"launched {json.dumps(got)} (remat: twice a layer) {card}")
    del out, model, cpu, gm, sc
    free()
    return got


def train_full(seed: int, card: str) -> dict:
    """Phase 7c: zamba2-7b in bf16 at full width and as many groups as
    fit beside the reserve with AdamW state, trained on ``train_4k``'s
    sequence: 1 warm-up and 4 timed steps of 2 x 4096 tokens in two
    microbatches.  Returns the timed steps' launches."""
    from dataclasses import replace
    from repro_torch.carry import param_leaves
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import native
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Transformer, count_params, param_specs
    from repro_torch.optim import (OptimizerConfig, adamw_init,
                                   make_optimizer)

    full = get_config(MODEL_ARCH)
    per = full.hybrid_attn_every
    fixed = count_params(param_specs(replace(full, n_layers=0)))
    group = count_params(param_specs(replace(full, n_layers=per))) - fixed
    opt = OptimizerConfig(name="adamw", warmup_steps=10, decay_steps=1000)
    pipe_cfg = PipelineConfig(vocab=full.vocab, global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, seed=seed)

    def run(groups: int, steps: int, warmup: int, profile: bool = False):
        cfg = replace(full, n_layers=per * groups)
        model = Transformer(cfg, device="cuda", seed=seed)
        leaves = param_leaves(model)
        step = make_train_step(model, opt, microbatch=TRAIN_MICRO)
        state = adamw_init(leaves)
        pipe = TokenPipeline(pipe_cfg)
        sums = [[float(p.detach().double().sum()) for p in leaf.parts]
                for leaf in leaves]
        torch.cuda.synchronize()
        static = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls, metrics, counts = [], [], []
        for i in range(warmup + steps):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in pipe.next().items()}
            native.reset_launches()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            if i >= warmup:
                walls.append(time.perf_counter() - t0)
                counts.append(dict(native.LAUNCHES))
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated()
        changed = [(leaf.path, len(leaf.part_shape),
                    [float(p.detach().double().sum()) != s0
                     for p, s0 in zip(leaf.parts, s)])
                   for leaf, s in zip(leaves, sums)]
        if profile:
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in pipe.next().items()}
            log(f"7c: one more step under the profiler: "
                f"{time_breakdown(lambda: step(state, batch), card)}")
            # The optimizer's share: one AdamW update alone (zero
            # gradients cost what any do).
            grads = [[torch.zeros_like(p) for p in leaf.parts]
                     for leaf in leaves]
            update = make_optimizer(opt)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            update(leaves, grads, state)
            torch.cuda.synchronize()
            log(f"7c: one AdamW update over {groups} groups alone: "
                f"{time.perf_counter() - t0:.6f} s {card}")
        return cfg, model, walls, metrics, counts, static, peak, changed

    # A one-group probe measures what a step needs beside the weights,
    # optimizer state, gradients and their sums (remat keeps it to one
    # group's activations).
    cfg, model, _, _, _, static, peak, _ = run(1, 1, 0)
    act = peak - static - STEP_BYTES * (fixed + group)
    del model
    free()
    free_b, _ = torch.cuda.mem_get_info()
    reserve = max(TRAIN_RESERVE, act + TRAIN_MARGIN)
    groups = min(full.n_layers // per, int(
        (free_b - reserve - TRAIN_BYTES * fixed) // (TRAIN_BYTES * group)))
    assert groups >= 1, f"not one group fits: {free_b} B free"
    n_params = fixed + groups * group
    log(f"7c: a step took {act} B beside weights, state, gradients and "
        f"sums at one group; "
        f"{free_b} B free, reserve {reserve} B, {TRAIN_BYTES} B a "
        f"parameter: {groups} of {full.n_layers // per} groups "
        f"({n_params} parameters) {card}")
    cfg, model, walls, metrics, counts, static, peak, changed = run(
        groups, TRAIN_STEPS, TRAIN_WARMUP, profile=True)
    want = {"ssd_sm90": 2 * TRAIN_MICRO * cfg.n_layers,
            "flash_attention_sm90": 2 * TRAIN_MICRO * groups,
            "ssd": 0, "flash_attention": 0}
    counts = [{k: c[k] for k in want} for c in counts]
    for got in counts:
        assert got == want, f"launches a step {got}, want {want}"
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics), metrics
    moved = sum(c for _, _, ch in changed for c in ch)
    parts = sum(len(ch) for _, _, ch in changed)
    still = [path for path, ndim, ch in changed if ndim >= 2 and not all(ch)]
    assert not still, f"matrices that never changed: {still}"
    med = statistics.median(walls)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = 6 * n_params * tokens / BF16_TENSOR_FLOPS / med
    log(f"7c: {MODEL_ARCH} bf16, d_model {cfg.d_model}, {groups} groups "
        f"({cfg.n_layers} Mamba2 layers, no tail; {n_params} parameters), "
        f"AdamW, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
        f"microbatches: step median {med:.6f} s (steps "
        f"{[round(w, 6) for w in walls]}) = {tokens / med:.1f} tokens/s; "
        f"6 N tokens / 989 TFLOP/s = {100 * share:.3f}% of the step; "
        f"peak {peak} B ({static} B of weights and state); launches "
        f"each timed step {json.dumps(counts)}; losses "
        f"{[m['loss'] for m in metrics]}, grad norms "
        f"{[m['grad_norm'] for m in metrics]}; {moved} of {parts} "
        f"parameter tensors changed (bf16 norm weights at 1.0 move by "
        f"less than half an ulp at lr {metrics[-1]['lr']:.3g}) {card}")
    del model
    free()
    return {k: sum(c[k] for c in counts) for k in want}


def train_loop(seed: int, card: str) -> dict:
    """Phase 7d: ``run_training`` at zamba2-7b's smoke config (f32) on
    the card: 20 steps with a checkpoint every 5, losses falling; a run
    that crashes at step 7 and a new run that resumes from 5, whose
    losses equal the uninterrupted run's within 1e-5; the checkpoint's
    bytes and a save's seconds; and the last checkpoint restored on the
    CPU path bit-identical to the card's parameters."""
    from repro_torch.carry import (jax_params, load_jax_params,
                                   param_leaves, param_template)
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config, smoke
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import native
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import TrainLoopConfig, run_training

    cfg = smoke(get_config(MODEL_ARCH))
    pipe = lambda: TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, global_batch=8, seq_len=128, seed=seed))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        model = Transformer(cfg, device="cuda", seed=seed)
        loop = lambda d: TrainLoopConfig(total_steps=LOOP_STEPS,
                                         checkpoint_every=LOOP_EVERY,
                                         checkpoint_dir=os.path.join(root, d))
        native.reset_launches()
        t0 = time.perf_counter()
        full = run_training(model, pipe(), loop("full"), rng_seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        per_step = {"ssd": 2 * cfg.n_layers, "flash_attention":
                    2 * (cfg.n_layers // cfg.hybrid_attn_every)}
        want = {k: v * LOOP_STEPS for k, v in per_step.items()}
        want.update(ssd_sm90=0, flash_attention_sm90=0)
        got = {k: launches[k] for k in want}
        assert got == want, (got, want)
        first, last = full.losses[:5], full.losses[-5:]
        assert full.final_step == LOOP_STEPS and \
            statistics.mean(last) < statistics.mean(first), full.losses

        def crash(step):
            if step == LOOP_CRASH:
                raise RuntimeError("simulated node loss")
            return False

        try:
            run_training(model, pipe(), loop("crash"), failure_injector=crash,
                         rng_seed=seed)
        except RuntimeError as e:
            assert "simulated node loss" in str(e)
        else:
            raise AssertionError("the injected crash did not happen")
        resumed = run_training(model, pipe(), loop("crash"), rng_seed=seed)
        assert resumed.resumed_from == LOOP_EVERY, resumed.resumed_from
        diff = max(abs(a - b) for a, b in
                   zip(resumed.losses, full.losses[LOOP_EVERY:]))
        assert len(resumed.losses) == LOOP_STEPS - LOOP_EVERY and \
            diff <= LOOP_TOL, f"resumed losses off by {diff}"

        # The resumed run's last checkpoint, restored on the CPU path,
        # holds the card's parameters.
        cpu = Transformer(cfg, device="cpu", seed=seed + 1)
        restored, extra = CheckpointManager(os.path.join(
            root, "crash")).restore({"params": param_template(cpu),
                                     "opt": adamw_init(param_leaves(cpu))})
        load_jax_params(cpu, restored["params"])
        assert extra["step"] == LOOP_STEPS
        for (k, a), (_, b) in zip(cpu.params.named_parameters(),
                                  model.params.named_parameters()):
            assert torch.equal(a, b.detach().cpu()), k
        # Its own optimizer state back on the card, and a blocking save
        # of it timed as the loop takes one on SIGTERM: the parameters
        # off the card and the whole state written.
        on_card = lambda t: {k: on_card(v) if isinstance(v, dict) else
                             v.to(model.device) for k, v in t.items()}
        opt_state = on_card(restored["opt"])
        mgr = CheckpointManager(os.path.join(root, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(LOOP_STEPS, {"params": jax_params(model), "opt": opt_state},
                 extra={"step": LOOP_STEPS}, blocking=True)
        save_s = time.perf_counter() - t0
        size = dir_bytes(os.path.join(root, "timed",
                                      f"step_{LOOP_STEPS:08d}"))
        log(f"7d: run_training at {cfg.name}'s smoke config (f32, "
            f"{cfg.n_layers} layers, d_model {cfg.d_model}) on the card: "
            f"{LOOP_STEPS} steps of 8 x 128 in {wall:.3f} s, loss "
            f"{full.losses[0]:.6f} -> {full.losses[-1]:.6f} (mean of the "
            f"first five {statistics.mean(first):.6f}, last five "
            f"{statistics.mean(last):.6f}); launched {json.dumps(got)}; "
            f"crash at step {LOOP_CRASH}, resumed from "
            f"{resumed.resumed_from}: losses within {diff} of the "
            f"uninterrupted run's; checkpoint {size} B on "
            f"{fs_type(root)}, a blocking save of the resumed run's "
            f"parameters and AdamW state {save_s:.6f} s; the last "
            f"checkpoint restored on the CPU path equals the card's "
            f"parameters bit for bit {card}")
        return got
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_phase(records: list, seed: int, card: str) -> None:
    """Phase 7: gradients through the kernels (7a), the f32 train step
    against the CPU path (7b), bf16 training at full width (7c) and the
    train loop with a crash and a resume (7d).  The kernels' records
    gain the training paths' launches."""
    t0 = time.perf_counter()
    grad_checks(records, seed, card)
    launches = {}
    for part in (train_check(seed, card), train_full(seed, card),
                 train_loop(seed, card)):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    for rec in records:
        if rec["name"] in launches:
            rec["train_launches"] = launches[rec["name"]]
            rec["launches"] += launches[rec["name"]]
    log(f"phase 7: {time.perf_counter() - t0:.3f} s; training launches "
        f"{json.dumps(launches)} {card}")


# ------------------------------------------------- meshes and analysis
MESH_AXES = ("pod", "data", "model")  # the production names, at size 1
MESH_MOE = (2, 2, 128)  # 8a's mixtral prefill: bf16 layers, batch, tokens
COMPRESS_STEPS = 50  # 8c: the error-feedback mean of the reference test
COMPRESS_TOL = 2e-3
COMPRESS_PREFIX = 1 << 20  # values of each leaf held to the CPU (whole blocks)
DRYRUN_CELLS = (("zamba2-7b", "train_4k"), ("mixtral-8x7b", "prefill_32k"))
DRYRUN_TIMEOUT = 300  # s a cell may still take once phase 8 waits for it
TRACE_BATCHES = 3  # 8e: phase 2's lookup batches under the tracer


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def one_rank_mesh():
    """A one-rank NCCL group on the card and the production axis names
    at size 1 on it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    return make_mesh_compat((1, 1, 1), MESH_AXES, device_type="cuda")


def sharded_train_check(mesh, seed: int, card: str) -> tuple[dict, list]:
    """Phase 8a: phase 7b's step (zamba2-7b's first group at full width,
    f32, AdamW, one ``TokenPipeline`` batch) with parameters, AdamW
    state and batch placed as DTensors by ``tree_shardings`` /
    ``opt_state_shardings`` / ``batch_shardings`` on the one-rank mesh,
    against the same step unsharded on the card: loss, grad norm, every
    updated parameter and first moment within 1e-3 of each tensor's
    largest magnitude, and the DTensor branch of the wrappers launching
    ``ssd`` and ``flash_attention`` as often as 7b.  Returns the
    sharded step's launches and its gradients (for 8c)."""
    from dataclasses import replace
    from repro_torch.carry import param_leaves
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import native
    from repro_torch.launch.steps import (batch_shardings, make_train_step,
                                          opt_state_shardings)
    from repro_torch.models import Transformer, distribute_tree
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.optim.optimizer import _get

    cfg = get_config(MODEL_ARCH)
    cfg = replace(cfg, dtype="float32", n_layers=cfg.hybrid_attn_every)
    b, s = TRAIN_CHECK
    data = TokenPipeline(PipelineConfig(vocab=cfg.vocab, global_batch=b,
                                        seq_len=s, seed=seed)).next()
    opt = OptimizerConfig(name="adamw", warmup_steps=10, decay_steps=1000)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    plain = Transformer(cfg, device="cuda", seed=seed)
    state0 = adamw_init(param_leaves(plain))
    state0, m0 = make_train_step(plain, opt)(state0, batch)
    model = Transformer(cfg, device="cuda", seed=seed).shard(mesh)
    bsh = batch_shardings(cfg, SHAPES["train_4k"], mesh, model.rules, model)
    osh = opt_state_shardings("adamw", model.param_specs(), mesh,
                              model.rules)
    state = distribute_tree(adamw_init(param_leaves(model)), osh)
    dbatch = distribute_tree(batch, bsh)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    state, m1 = step(state, dbatch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    want = {"ssd": 2 * cfg.n_layers, "flash_attention": 2, "ssd_sm90": 0,
            "flash_attention_sm90": 0}
    got = {k: launches[k] for k in want}
    assert got == want, (got, want)
    errs = {k: abs(float(m1[k]) - float(m0[k])) / abs(float(m0[k]))
            for k in ("loss", "grad_norm")}
    for la, lb in zip(param_leaves(model), param_leaves(plain)):
        errs["mu/" + la.path] = rel_err(
            _get(state["mu"], la.path).full_tensor(),
            _get(state0["mu"], la.path))
        errs[la.path] = max(rel_err(x.detach().full_tensor(), y.detach())
                            for x, y in zip(la.parts, lb.parts))
    bad = {k: e for k, e in errs.items() if not e <= F32_TOL}
    assert not bad, f"sharded train step off the plain one: {bad}"
    log(f"8a: {MODEL_ARCH} first group at full width, f32, on a one-rank "
        f"NCCL mesh {dict(zip(MESH_AXES, mesh.shape))}: the DTensor train "
        f"step ({wall:.3f} s) equals the unsharded card step within "
        f"{F32_TOL} (largest: {max(errs.items(), key=lambda kv: kv[1])}); "
        f"loss {errs['loss']}, grad norm {errs['grad_norm']} relative; "
        f"launched {json.dumps(got)} through the wrappers' DTensor branch "
        f"{card}")
    # The gradients of the step's batch on the sharded model (8c's).
    with model._mesh_context():
        model.trainable(True)
        loss = cross_entropy_loss(model.forward_train(
            tokens=dbatch["tokens"]), dbatch["labels"])
        loss.full_tensor().backward()
    grads = [p.grad.to_local().detach() for p in model.params.parameters()]
    del plain, model, state, state0
    free()
    return got, grads


def sharded_moe_prefill(mesh, seed: int, card: str) -> dict:
    """Phase 8a (cont.): a bf16 prefill of mixtral-8x7b at 2 layers and
    full width through the same mesh, held to the unsharded prefill of
    the same model, one ``flash_attention_sm90`` launch a layer."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import native
    from repro_torch.launch.steps import batch_shardings
    from repro_torch.models import Transformer, distribute_tree

    layers, b, s = MESH_MOE
    cfg = replace(get_config(MOE_ARCH), n_layers=layers)
    model = Transformer(cfg, device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    toks = torch.randint(0, cfg.vocab, (b, s), device="cuda", generator=g)
    want, _ = model.prefill(tokens=toks)
    model.shard(mesh)
    bsh = batch_shardings(cfg, SHAPES["prefill_32k"], mesh, model.rules,
                          model)
    dtoks = distribute_tree({"tokens": toks}, bsh)["tokens"]
    torch.cuda.synchronize()
    native.reset_launches()
    got, cache = model.prefill(tokens=dtoks)
    torch.cuda.synchronize()
    launches = {k: native.LAUNCHES[k]
                for k in ("flash_attention_sm90", "flash_attention")}
    assert launches == {"flash_attention_sm90": layers,
                        "flash_attention": 0}, launches
    err = rel_err(got.full_tensor(), want)
    assert err <= F32_TOL, f"sharded MoE prefill off by {err}"
    log(f"8a: {MOE_ARCH} bf16 at {layers} layers, full width, {b} x {s} "
        f"tokens, through the mesh: logits within {err} of the unsharded "
        f"prefill's largest magnitude; launched {json.dumps(launches)} "
        f"{card}")
    del model, cache
    free()
    return launches


def compress_checks(mesh, grads: list, card: str) -> None:
    """Phase 8c: ``quantize_roundtrip`` on the card equals the CPU path
    bit for bit on 8a's gradient leaves (the first 2^20 values of each,
    whole 256-value blocks: the CPU's pass over all 0.9 B would take
    minutes), and the reference test's
    50-step error-feedback mean over the one-rank 'pod' group stays
    within 2e-3 of the gradient."""
    from repro_torch.optim import (make_compressed_crosspod_reduce,
                                   quantize_roundtrip)
    n = 0
    for g in grads:
        g = g.reshape(-1)[:COMPRESS_PREFIX]
        y, r = quantize_roundtrip(g)
        cy, cr = quantize_roundtrip(g.cpu())
        assert torch.equal(y.cpu(), cy) and torch.equal(r.cpu(), cr), \
            f"roundtrip of a {g.numel()}-value leaf differs on the card"
        n += g.numel()
    reduce_fn = make_compressed_crosspod_reduce(mesh)
    g = [grads[0].reshape(-1)[:4096].float()]
    g = [g[0] / g[0].abs().max()]  # the reference test's unit scale
    e = [torch.zeros_like(g[0])]
    total = torch.zeros_like(g[0])
    for _ in range(COMPRESS_STEPS):
        red, e = reduce_fn(g, e)
        total += red[0]
    err = float((total / COMPRESS_STEPS - g[0]).abs().max())
    assert err <= COMPRESS_TOL, f"error feedback mean off by {err}"
    log(f"8c: quantize_roundtrip on the card equals the CPU path bit for "
        f"bit on {len(grads)} gradient leaves of 8a's step (their first "
        f"{COMPRESS_PREFIX} values: {n} in all); "
        f"{COMPRESS_STEPS} compressed reductions over the one-rank 'pod' "
        f"group average to the gradient within {err} (limit "
        f"{COMPRESS_TOL}) {card}")


def start_dryrun(out: str) -> list:
    """Phase 8d's cells, each traced by ``python -m repro_torch.launch.
    dryrun`` in a process of its own on this host (niced, one thread,
    no card visible), so that they run while the card takes phases
    5-8c: a list of (arch, shape, start time, process)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
        procs.append((arch, shape, time.perf_counter(), proc))
    return procs


def dryrun_phase(procs: list, out: str) -> None:
    """Phase 8d: two cells of the dry-run on the single 16 x 16 mesh,
    traced on this host over a fake process group (no card) by the
    processes ``start_dryrun`` started: their tables' rows and seconds.
    Model estimates from the H100 data sheet's constants, not
    measurements."""
    from repro_torch.analysis.report import (dryrun_table, load,
                                             roofline_table)
    t0 = time.perf_counter()
    for arch, shape, start, proc in procs:
        text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        assert proc.returncode == 0, \
            f"8d: dry-run {arch} {shape} exited {proc.returncode}:\n{text}"
        log(f"8d: dry-run {arch} {shape} done within "
            f"{time.perf_counter() - start:.3f} s of its start")
    log(f"8d: waited {time.perf_counter() - t0:.3f} s for the dry-run "
        "at phase 8")
    rows = load(out)
    assert sorted((r["arch"], r["shape"]) for r in rows) \
        == sorted(DRYRUN_CELLS), rows
    for res in rows:
        mem = res["memory_per_device"]
        log(f"8d: dry-run {res['arch']} {res['shape']} on the 16 x 16 mesh "
            f"(fake process group of 256, host only): placement "
            f"{res['lower_s']} s, trace {res['compile_s']} s; rank 0 "
            f"holds {mem['argument_bytes']} B of arguments, peak "
            f"{mem['temp_bytes']} B more; fits 80 GB: {res['fits_80g']}")
    log("8d: model estimates from the H100 SXM data sheet (989 TFLOP/s "
        "bf16, 3.35 TB/s HBM, 450 GB/s NVLink a direction), not "
        "measurements:\n" + dryrun_table(rows) + "\n"
        + roofline_table(rows))


def mesh_phase(records: list, seed: int, card: str, dryrun: list,
               dryrun_out: str) -> None:
    """Phase 8: the sharded step on a one-rank NCCL mesh (8a), gradient
    compression on the card (8c) and the dry-run on the host (8d, its
    processes started by ``start_dryrun``).  Two
    ranks on the one card (8b) are not run: NCCL refuses two ranks on
    one GPU, and over gloo the functional collectives DTensor calls on
    CUDA tensors crash (``PERF.md``).  The kernels' records gain the
    mesh path's launches."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = one_rank_mesh()
    try:
        launches, grads = sharded_train_check(mesh, seed, card)
        for k, v in sharded_moe_prefill(mesh, seed, card).items():
            launches[k] += v
        compress_checks(mesh, grads, card)
    finally:
        dist.destroy_process_group()
    del grads
    free()
    dryrun_phase(dryrun, dryrun_out)
    for rec in records:
        n = launches.get(rec["name"], 0)
        if n:
            rec["mesh_launches"] = n
            rec["launches"] += n
    log(f"phase 8: {time.perf_counter() - t0:.3f} s; mesh launches "
        f"{json.dumps(launches)} {card}")


def trace_phase(eng, batches, card: str) -> dict:
    """Phase 8e (on phase 2's store, after its lookups): three lookup
    batches under the tracer, its Chrome trace exported and read back
    through ``analysis.report``; ``cascade_sm90`` launches per lookup
    from the trace equal the kernel counters'."""
    from repro_torch import obs
    from repro_torch.analysis.report import (load_trace, trace_report,
                                             trace_tables)
    from repro_torch.kernels import native
    kc0 = eng.kernel_counters
    native.reset_launches()
    with obs.enabled() as tr:
        lookups(eng, batches[:TRACE_BATCHES])
    kc1 = eng.kernel_counters
    launched = native.LAUNCHES["cascade_sm90"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        tr.export_chrome(path)
        rep = trace_report(load_trace(path))
    calls = kc1.cascade_calls - kc0.cascade_calls
    n = TRACE_BATCHES * LOOKUP_BATCH
    assert rep["lookups"] == n, (rep["lookups"], n)
    assert rep["kernel_launches"] == calls == launched, \
        (rep["kernel_launches"], calls, launched)
    shards = {s: (round(r["busy_us"]), round(r["stall_us"]))
              for s, r in rep["shards"].items()}
    log(f"8e: trace of {TRACE_BATCHES} lookup batches: wall "
        f"{rep['wall_us']:.1f} us, perfect-overlap bound "
        f"{rep['modeled_us']:.1f} us, gap {rep['gap_us']:.1f} us; per "
        f"shard (busy us, stall us) {shards}; {rep['kernel_launches']} "
        f"kernel spans / {rep['lookups']} lookups = "
        f"{rep['launches_per_lookup']:.6f} launches a lookup, equal to "
        f"the kernel counters' {calls} cascade calls and {launched} "
        f"cascade_sm90 launches {card}\n{trace_tables(rep)}")
    return {"cascade_sm90": launched}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-child", metavar="WAL_DIR",
                    help="run as phase 2f's writer on WAL_DIR (started "
                    "by phase 2f itself)")
    ap.add_argument("--kill-device", default="cuda")
    args = ap.parse_args(argv)
    if args.kill_child:
        return kill_child_main(args.kill_child, args.kill_device)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Full f32 in matmuls and convolutions: the checks compare in f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import native

    # 1. environment + build
    smi, kind = environment()
    card = f"[{smi}]"
    t0 = time.perf_counter()
    native.build_all()
    log(f"kernel build {time.perf_counter() - t0:.3f} s "
        f"({len(native.KERNELS)} sources)")

    with timed("phases 2-4"):
        records = store_phases(card, args.seed)
    with tempfile.TemporaryDirectory() as dryrun_out:
        dryrun = start_dryrun(dryrun_out)
        try:
            with timed("phase 5"):
                launches = model_phase(args.seed, card)
            with timed("phase 5b"):
                moe = moe_phase(args.seed, card)
            zoo = zoo_phase(args.seed, card)
            launches = {k: v + moe.get(k, 0) + zoo.get(k, 0)
                        for k, v in launches.items()}
            with timed("phase 5c"):
                workload_phase(args.seed)
            with timed("phase 6"):
                records += model_kernel_checks(launches, args.seed, card)
            train_phase(records, args.seed, card)
            mesh_phase(records, args.seed, card, dryrun, dryrun_out)
        finally:
            for *_, proc in dryrun:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    log(smi)
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
