"""Atomic filesystem publication: write-tmp-then-rename + keep-last-k.

Materialize into a ``*.tmp`` sibling, then ``os.rename`` onto the final
name, so a crash mid-write never corrupts the last published version.
The level manifest and store snapshots share this one implementation
(and a checkpoint manager publishes the same way).

POSIX ``rename`` within one filesystem is atomic; readers either see the
complete old version or the complete new one.  ``fsync_dir`` additionally
persists the directory entry itself, which the WAL/manifest recovery
chain needs (a renamed file whose directory entry was never synced can
vanish across a power cut).
"""

from __future__ import annotations

import json
import os
import re
import shutil


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = True) -> None:
    """Publish ``data`` at ``path`` atomically (tmp sibling + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, obj, *, fsync: bool = True) -> None:
    """Publish a JSON document atomically."""
    atomic_write_bytes(path, json.dumps(obj, indent=1).encode(),
                       fsync=fsync)


def atomic_publish_dir(tmp: str, final: str) -> None:
    """Atomically publish a staged directory at its final name.

    ``tmp`` must be a fully-written sibling directory (same parent).  An
    existing ``final`` is removed first — the caller's versioning scheme
    (numbered names + ``keep_last_k``) is what makes that safe.
    """
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def clear_stale_tmp(path: str) -> None:
    """Remove a leftover ``path`` (file or dir) from a crashed writer."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def versioned_name(prefix: str, version: int, suffix: str = "") -> str:
    return f"{prefix}{version:08d}{suffix}"


def list_versions(directory: str, prefix: str,
                  suffix: str = "") -> list[int]:
    """Sorted published versions matching ``<prefix><number><suffix>``
    (tmp siblings and foreign names are ignored)."""
    pat = re.compile(re.escape(prefix) + r"(\d+)" + re.escape(suffix)
                     + r"$")
    out = []
    for name in os.listdir(directory):
        m = pat.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def keep_last_k(directory: str, prefix: str, k: int,
                suffix: str = "") -> list[int]:
    """Drop all but the newest ``k`` published versions; returns the
    versions removed.  Bounded disk for any append-forever publisher."""
    versions = list_versions(directory, prefix, suffix)
    dropped = versions[:-k] if k > 0 else versions
    for v in dropped:
        target = os.path.join(directory, versioned_name(prefix, v, suffix))
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)
        else:
            try:
                os.remove(target)
            except OSError:
                pass
    return dropped
