"""Checkpointing in the JAX package's on-disk format, so that a checkpoint
written by ``repro.train.checkpoint`` restores here bitwise and the other
way round:

* **atomic**: written to ``<dir>/tmp.<step>`` then renamed to
  ``step_<n>`` (ten digits); a crash mid-write never corrupts the latest
  checkpoint.
* **manifest'd**: ``manifest.json`` holds the step, ``extra`` and, per
  leaf path (``core.tree``: the paths of ``jax.tree_util``), the file,
  shape, dtype and SHA-256 of the bytes; leaves are ``leaf_%05d.npy`` in
  sorted-path order.  Restore verifies every checksum.
* **async**: ``save_async`` copies the leaves to host memory now and writes
  on a daemon thread, so the train loop keeps stepping.
* **retention**: keep the last ``keep`` checkpoints.
* **elastic / reshard-on-restore**: leaves are stored whole.  A DTensor
  leaf is gathered on every rank (``save`` / ``save_async`` call the
  gather on every rank before any thread starts) and rank 0 alone
  writes; ``restore(..., shardings=...)`` places each leaf onto ANY mesh
  by slicing this rank's shard (``parallel.sharding.distribute``), so a
  job can resume on another topology or on one device.

Without ``shardings``, ``restore`` places every leaf on ``device``
(default: the device of the target tree's leaf, or, for a DTensor
target, its own mesh and placements).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import tree as T


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()          # a collective: every rank calls
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sharded(tree) -> bool:
    return any(isinstance(x, DTensor) for x in T.leaves(tree))


def _writer() -> bool:
    """Whether this process writes: rank 0 of a started group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _final(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint's directory.  A
    tree of DTensors is gathered on every rank, rank 0 writes, and every
    rank returns once it is written."""
    if not _sharded(tree):
        return _write(ckpt_dir, step, tree, extra, keep)
    host = _gather_host(tree)
    if _writer():
        _write(ckpt_dir, step, host, extra, keep)
    dist.barrier()
    return _final(ckpt_dir, step)


def _gather_host(tree):
    """Every leaf whole on rank 0's host (a copy); every rank takes part
    in the gathers and the others keep nothing."""
    keep = _writer()

    def one(x):
        arr = _host(x)
        return arr.copy() if keep else None
    return T.tree_map(one, tree)


def _write(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict],
           keep: int) -> str:
    flat = dict(T.flatten_with_path(tree))
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = _final(ckpt_dir, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = dict(step=step, extra=extra or {}, leaves={})
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = dict(
            file=fname, shape=list(arr.shape), dtype=str(arr.dtype),
            sha256=hashlib.sha256(arr.tobytes()).hexdigest())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


_PENDING: list = []


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[dict] = None, keep: int = 3):
    """Snapshot to host now, write on a daemon thread (DTensors are
    gathered here, on every rank; rank 0 alone starts the thread and
    returns it, the others return None)."""
    host_tree = _gather_host(tree)
    if not _writer():
        return None
    t = threading.Thread(target=_write, args=(ckpt_dir, step, host_tree,
                                              extra, keep), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


class _Placed:
    """A DTensor's mesh and placements, as a sharding."""

    def __init__(self, t):
        self.mesh, self.placements = t.device_mesh, tuple(t.placements)


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None,
            shardings: Any = None, device=None, verify: bool = True):
    """Restore into the structure of ``target_tree``: ``(tree, step,
    extra)``.  With ``shardings`` (a tree of ``parallel.sharding.
    NamedSharding`` of the same structure, leaf for leaf) each leaf
    becomes a DTensor on its sharding, on any mesh; without, a tensor on
    ``device``, or on the device of ``target_tree``'s leaf at that path
    when ``device`` is None (a DTensor leaf: its own placements)."""
    from repro_torch.launch.mesh import rank_device
    from repro_torch.parallel.sharding import distribute

    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = T.flatten_with_path(target_tree)
    shards = (T.leaves(shardings) if shardings is not None
              else [None] * len(pairs))
    if len(shards) != len(pairs):
        raise ValueError(f"{len(shards)} shardings for {len(pairs)} leaves")
    leaves = []
    for (key, target), sh in zip(pairs, shards):
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        if verify:
            h = hashlib.sha256(arr.tobytes()).hexdigest()
            if h != meta["sha256"]:
                raise IOError(f"checksum mismatch for {key} in {path}")
        if sh is None and device is None and isinstance(target, DTensor):
            sh = _Placed(target)
        if sh is not None:
            dev = device if device is not None else rank_device(sh.mesh)
            leaves.append(distribute(torch.from_numpy(arr).to(dev), sh))
            continue
        dev = device if device is not None else getattr(
            target, "device", "cpu")
        leaves.append(torch.from_numpy(arr).to(dev))
    return T.unflatten(target_tree, leaves), step, manifest.get("extra", {})
