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

``restore`` places every leaf on ``device`` (default: the device of the
target tree's leaf); there is no resharding.
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

from repro_torch.core import tree as T


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint's directory."""
    flat = dict(T.flatten_with_path(tree))
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
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
    """Snapshot to host now, write on a daemon thread."""
    host_tree = T.tree_map(lambda x: _host(x).copy(), tree)
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree),
                         kwargs=dict(extra=extra, keep=keep), daemon=True)
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


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None,
            device=None, verify: bool = True):
    """Restore into the structure of ``target_tree``: ``(tree, step,
    extra)``.  Each leaf becomes a tensor on ``device``, or on the device
    of ``target_tree``'s leaf at that path when ``device`` is None."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for key, target in T.flatten_with_path(target_tree):
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        if verify:
            h = hashlib.sha256(arr.tobytes()).hexdigest()
            if h != meta["sha256"]:
                raise IOError(f"checksum mismatch for {key} in {path}")
        dev = device if device is not None else getattr(
            target, "device", "cpu")
        leaves.append(torch.from_numpy(arr).to(dev))
    return T.unflatten(target_tree, leaves), step, manifest.get("extra", {})
