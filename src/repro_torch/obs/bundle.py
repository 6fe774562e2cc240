"""Debug bundles: one self-contained post-mortem artifact per incident.

The port's copy of ``repro.obs.bundle``: the format, its reader and the
offline ``dump``.  Writing a bundle from a live session (``write_bundle``,
fed by the flight recorder and the alert rules) waits for those, ROADMAP
item A7.

A bundle is a directory (named ``bundle_{seq:03d}_{reason}`` —
deterministic, no wall-clock in the name) holding everything needed to
diagnose an incident offline:

* ``manifest.json`` — reason, injected-clock timestamp, alert count,
  active config/bucket census, recorder stats, file list.
* ``trace.json``    — Chrome ``trace_event`` JSON (the flight-recorder
  ring when one is attached, else the session's full trace).
* ``metrics.txt``   — Prometheus text exposition at dump time.
* ``alerts.jsonl``  — the alert history, one canonical JSON per line.
* ``deltas.jsonl``  — the recorder's metric-delta ring.

:func:`read_bundle` parses a bundle back through the same validators the
``python -m repro_torch.obs`` report CLI uses, so the formats cannot drift
from what the tooling accepts; :func:`assemble_bundle` builds a bundle
from already-exported artifacts (the offline ``dump`` subcommand).
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional

__all__ = ["read_bundle", "assemble_bundle", "BUNDLE_SCHEMA"]

BUNDLE_SCHEMA = 1

_MANIFEST = "manifest.json"
_TRACE = "trace.json"
_METRICS = "metrics.txt"
_ALERTS = "alerts.jsonl"
_DELTAS = "deltas.jsonl"


def _slug(reason: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_.-]+", "-", reason).strip("-") or "bundle"


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")


def read_alert_lines(path: str) -> List[dict]:
    """Parse an ``alerts.jsonl`` file, validating the Alert shape."""
    alerts = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            missing = {"rule", "severity", "t", "message"} - set(d)
            if missing:
                raise ValueError(
                    f"{path}:{i + 1}: alert missing keys {sorted(missing)}")
            alerts.append(d)
    return alerts


def read_bundle(path: str) -> dict:
    """Parse a bundle directory back through the report-CLI validators.
    Returns ``{manifest, trace_events, metrics, alerts, deltas}``."""
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.isfile(manifest_path):
        raise ValueError(f"not a debug bundle (no {_MANIFEST}): {path}")
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"unsupported bundle schema {manifest.get('schema')!r} "
            f"(expected {BUNDLE_SCHEMA}): {path}")

    from repro_torch.obs.__main__ import load_chrome_trace
    from repro_torch.obs.metrics import parse_text

    out = dict(manifest=manifest, trace_events=[], metrics={}, alerts=[],
               deltas=[])
    trace_path = os.path.join(path, _TRACE)
    if os.path.isfile(trace_path):
        out["trace_events"] = load_chrome_trace(trace_path)
    metrics_path = os.path.join(path, _METRICS)
    if os.path.isfile(metrics_path):
        with open(metrics_path) as f:
            out["metrics"] = parse_text(f.read())
    alerts_path = os.path.join(path, _ALERTS)
    if os.path.isfile(alerts_path):
        out["alerts"] = read_alert_lines(alerts_path)
    deltas_path = os.path.join(path, _DELTAS)
    if os.path.isfile(deltas_path):
        with open(deltas_path) as f:
            out["deltas"] = [json.loads(line) for line in f if line.strip()]
    return out


def assemble_bundle(out_dir: str, trace_path: Optional[str] = None,
                    metrics_path: Optional[str] = None,
                    alerts_path: Optional[str] = None,
                    reason: str = "manual") -> str:
    """Build a bundle from already-exported artifacts (``python -m
    repro_torch.obs dump``).  Inputs are validated before they are copied in."""
    name = f"bundle_000_{_slug(reason)}"
    bdir = os.path.join(out_dir, name)
    os.makedirs(bdir, exist_ok=True)

    from repro_torch.obs.__main__ import load_chrome_trace
    from repro_torch.obs.metrics import parse_text

    files = []
    n_alerts = 0
    if trace_path:
        load_chrome_trace(trace_path)                 # validate
        with open(trace_path) as f:
            content = f.read()
        with open(os.path.join(bdir, _TRACE), "w") as f:
            f.write(content)
        files.append(_TRACE)
    if metrics_path:
        with open(metrics_path) as f:
            content = f.read()
        parse_text(content)                           # validate
        with open(os.path.join(bdir, _METRICS), "w") as f:
            f.write(content)
        files.append(_METRICS)
    if alerts_path:
        n_alerts = len(read_alert_lines(alerts_path))  # validate
        with open(alerts_path) as f:
            content = f.read()
        with open(os.path.join(bdir, _ALERTS), "w") as f:
            f.write(content)
        files.append(_ALERTS)

    manifest = dict(schema=BUNDLE_SCHEMA, reason=reason, t=0.0, seq=0,
                    alerts=n_alerts, census={}, recorder=None, files=files)
    _write_json(os.path.join(bdir, _MANIFEST), manifest)
    return bdir
