"""Persistent JSON cache of tuned kernel configs.

The port's copy of ``repro.tune.cache``: one search per (kernel, shapes,
dtype, backend, device kind) for the life of the machine.  The two-stage
search writes its winner here, and every later ``compile_model(...,
tune="auto")`` is answered from the cache without timing anything.  The
path comes from ``REPRO_TUNE_CACHE``, then ``$XDG_CACHE_HOME/repro_torch/
tune.json``, then ``~/.cache/repro_torch/tune.json``: the port has its own
default file, so neither package rewrites the other's.  A missing or
corrupt cache file is treated as empty, never an error; writes are atomic.

Format (one flat JSON object, the reference's):

    { "<kernel>|<shapes>|<dtype>|<backend>|<device>": {
          "<task_key>": {"band_rows": 4, ...}, ... }, ... }

Hit/miss counters live on the cache object (and, with an obs session, in
``tune_cache_total``).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

from repro_torch.obs import runtime as _obs
from repro_torch.tune.config import KernelConfig

DEFAULT_CACHE = "~/.cache/repro_torch/tune.json"


def cache_path() -> str:
    """Resolved cache file path.  Precedence: ``REPRO_TUNE_CACHE`` (explicit
    override), then ``$XDG_CACHE_HOME/repro_torch/tune.json``, then
    ``~/.cache/repro_torch/tune.json``."""
    explicit = os.environ.get("REPRO_TUNE_CACHE")
    if explicit:
        return os.path.expanduser(explicit)
    xdg = os.environ.get("XDG_CACHE_HOME")
    if xdg:
        return os.path.join(os.path.expanduser(xdg), "repro_torch",
                            "tune.json")
    return os.path.expanduser(DEFAULT_CACHE)


def cache_key(kernel: str, shapes, dtype: str, backend: str,
              device_kind: str) -> str:
    """The persistent identity of one tuning problem."""
    shp = "x".join(",".join(str(d) for d in s) for s in shapes)
    return f"{kernel}|{shp}|{dtype}|{backend}|{device_kind}"


class TuneCache:
    """Load-once, save-atomically JSON config store."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else cache_path()
        self.hits = 0
        self.misses = 0
        self._data = self._load()

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            # missing, unreadable, or corrupt -> start empty (the next save
            # rewrites the file whole)
            return {}
        return data if isinstance(data, dict) else {}

    def get(self, key: str) -> Optional[Dict[str, KernelConfig]]:
        """The cached per-task tuning for ``key``, or None.  Malformed
        entries count as misses (same contract as a corrupt file)."""
        entry = self._data.get(key)
        if isinstance(entry, dict):
            try:
                out = {task: KernelConfig.from_dict(d)
                       for task, d in entry.items()}
            except (AttributeError, TypeError, ValueError):
                out = None
            if out is not None:
                self.hits += 1
                self._count("hit")
                return out
        self.misses += 1
        self._count("miss")
        return None

    @staticmethod
    def _count(result: str) -> None:
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "tune_cache_total", "tuning-cache lookups by result").inc(
                    result=result)

    def put(self, key: str, tuning: Dict[str, KernelConfig]) -> None:
        self._data[key] = {task: c.to_dict() for task, c in tuning.items()}

    def save(self) -> None:
        """Atomic write (tmp + rename) so a crashed writer can only ever
        leave the previous cache or a complete new one."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tune-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def stats(self) -> dict:
        return dict(path=self.path, entries=len(self._data),
                    hits=self.hits, misses=self.misses)

    def __len__(self):
        return len(self._data)
