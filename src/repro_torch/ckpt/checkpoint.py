"""Fault-tolerant checkpointing: atomic, async, in the JAX package's
layout (a port of ``repro.ckpt.checkpoint``).

Layout per step:  <dir>/step_<N>/
    manifest.json   step, extra (pipeline state, ...), leaf keys
    arrays.npz      the leaves ``a0, a1, ...`` in the order of ``keys``

Keys are tree paths (``params/groups/mamba/w_in``, ``opt/mu/...``,
``opt/step``) in ``jax.tree`` flatten order, so each package restores
the other's checkpoints.  A bf16 tensor is saved as f32: exact, since
every bf16 value is an f32, and the reference's restore casts it back
with ``astype``; numpy has no bf16 of its own, so a checkpoint written
with ``ml_dtypes`` holds raw 2-byte words (``|V2``), which ``restore``
reads as bf16 bits.

Guarantees used by the train loop:
  * atomicity — written to step_<N>.tmp, then published by
    ``durable.atomic``; a crash mid-save never corrupts the latest
    checkpoint;
  * async — saves run on a writer thread off the step path (arrays are
    copied to the host, never viewed, before ``save`` returns);
  * keep-last-k — bounded disk;
  * elastic restore — ``restore(..., shardings=)`` places every leaf as
    a DTensor on any mesh, whatever mesh saved it.
"""

from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np
import torch

from ..carry import nest, tree_order
from ..durable.atomic import (atomic_publish_dir, clear_stale_tmp,
                              keep_last_k, list_versions, versioned_name)
from ..models.params import distribute_tree

_PREFIX = "step_"


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) of a nested dict in ``jax.tree`` flatten order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flatten_with_paths(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return sorted(out, key=lambda kv: tree_order(kv[0]))


def _to_host(v) -> np.ndarray:
    """A copy of a leaf as a numpy array; bf16 tensors as f32 (exact).
    Always a copy, never a view: on the CPU ``.cpu()`` and ``.numpy()``
    share the live tensor's memory, which the next step updates in
    place while the writer thread may still be saving it."""
    if isinstance(v, torch.Tensor):
        dtype = torch.float32 if v.dtype == torch.bfloat16 else v.dtype
        return v.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(v, copy=True)


def _from_host(arr: np.ndarray, tmpl):
    """``arr`` in the template leaf's type: a CPU tensor for a tensor
    template, a numpy array for a numpy one."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # bf16 bits: the high half of an f32.
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.array(arr, order="C")).to(tmpl.dtype)
    return arr.astype(tmpl.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        self._error = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: dict, extra: dict | None = None,
             blocking: bool = False) -> None:
        """state: nested dict of tensors or arrays (params/opt); extra:
        JSON-serializable (pipeline state, ...)."""
        # On the host BEFORE queueing: the next step updates the
        # tensors in place.
        leaves = [(k, _to_host(v)) for k, v in _flatten_with_paths(state)]
        job = (step, leaves, extra or {})
        if blocking:
            self._write(job)
        else:
            self._q.put(job)

    def _drain(self):
        while True:
            job = self._q.get()
            try:
                self._write(job)
            except Exception as e:  # surfaced on next wait()
                self._error = e
            self._q.task_done()

    def wait(self):
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, job):
        step, leaves, extra = job
        final = os.path.join(self.dir, versioned_name(_PREFIX, step))
        tmp = final + ".tmp"
        clear_stale_tmp(tmp)
        os.makedirs(tmp)
        arrays = {f"a{i}": v for i, (_, v) in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": [k for k, _ in leaves],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        atomic_publish_dir(tmp, final)
        keep_last_k(self.dir, _PREFIX, self.keep)

    # ------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        return list_versions(self.dir, _PREFIX)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict, step: int | None = None,
                shardings=None) -> tuple[dict, dict]:
        """Restore into the structure of ``template`` (a nested dict
        whose leaves give shape and type: tensors, "meta" ones too, or
        numpy arrays); returns (state, extra), each leaf a CPU tensor
        or a numpy array like its template's.  ``shardings`` (a tree of
        ``NamedSharding`` of the template's structure) re-shards each
        leaf onto its mesh as a DTensor (elastic: any mesh)."""
        if step is None:
            step = self.latest_step()
            assert step is not None, "no checkpoint found"
        d = os.path.join(self.dir, versioned_name(_PREFIX, step))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            by_key = {k: data[f"a{i}"]
                      for i, k in enumerate(manifest["keys"])}
        flat = {}
        for key, tmpl in _flatten_with_paths(template):
            arr = by_key[key]
            assert tuple(arr.shape) == tuple(tmpl.shape), \
                f"{key}: {arr.shape} != {tuple(tmpl.shape)}"
            flat[key] = _from_host(arr, tmpl)
        state = nest(flat)
        if shardings is not None:
            state = distribute_tree(state, shardings)
        return state, manifest["extra"]
