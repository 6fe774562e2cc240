"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration and a traffic mix; each
is a file of its own, found by name: ``configs/<config>.json`` (through the
configuration's ``file``) and ``traffic/<mix>.json``.  A per-layer metric
is a module ``metrics/<name>.py`` with one function ``read(rec)`` that
returns the metric's value, or None where the record holds nothing to
read.  Adding a cell, a mix or a metric adds files and entries; no file
here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: tuple      # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic mix loaded."""
    w = {x["name"]: x for x in bench["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(x['name'] for x in bench['workloads'])}")
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg, mix=mix,
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _applies(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _applies(m, name)))


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
