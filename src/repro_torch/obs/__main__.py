"""``python -m repro_torch.obs`` — render a text report from exported
artifacts (the port's copy of ``python -m repro.obs``).

Reads the files the instrumented CLIs write (``--trace-out`` Chrome
``trace_event`` JSON, ``--metrics-out`` Prometheus text, ``--alerts``
alert-log JSONL or a debug-bundle directory) and prints a summary:
event/track counts, the top-N slowest spans, kernel-profile rows with
their measured-vs-roofline ratios, metric series, and the alert history.
A parse failure exits 1, so the export formats cannot drift silently.

Subcommand ``dump`` assembles a debug bundle offline from already-
exported artifacts:

    python -m repro_torch.obs dump --trace t.json --metrics m.txt --out bundles/

Gate flag ``--assert-no-alerts`` exits nonzero when the alert log is
non-empty — the CI-friendly way to pin "this run stayed healthy".
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.obs.metrics import parse_text


def load_chrome_trace(path: str) -> List[dict]:
    """Load + validate a Chrome trace_event file; returns the event list.
    Raises ``ValueError`` on anything Perfetto would reject outright."""
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(f"{path}: not a Chrome trace_event object "
                         "(missing 'traceEvents')")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError(f"{path}: 'traceEvents' is not a list")
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            raise ValueError(f"{path}: event {i} has no phase: {e!r}")
        if e["ph"] in ("X", "i") and "ts" not in e:
            raise ValueError(f"{path}: event {i} has no timestamp: {e!r}")
    return events


def load_alerts(path: str) -> List[dict]:
    """Load an alert log: either an ``alerts.jsonl`` file or a debug-
    bundle directory (whose ``alerts.jsonl`` is read)."""
    from repro_torch.obs.bundle import read_alert_lines
    if os.path.isdir(path):
        inner = os.path.join(path, "alerts.jsonl")
        if not os.path.isfile(inner):
            raise ValueError(f"{path}: directory has no alerts.jsonl")
        return read_alert_lines(inner)
    return read_alert_lines(path)


def _track_names(events: List[dict]) -> dict:
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[e.get("tid")] = e.get("args", {}).get("name", "?")
    return names


def report_trace(events: List[dict], top: int = 10) -> str:
    tracks = _track_names(events)
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]
    lines = [f"trace: {len(spans)} spans, {len(instants)} instants, "
             f"{len(tracks)} tracks"]
    by_track: dict = {}
    for e in spans:
        row = by_track.setdefault(e.get("tid"), [0, 0.0])
        row[0] += 1
        row[1] += e.get("dur", 0.0)
    for tid in sorted(by_track, key=lambda t: -by_track[t][1]):
        n, total = by_track[tid]
        lines.append(f"  {tracks.get(tid, tid):<12} {n:>6} spans  "
                     f"{total / 1e3:>10.3f} ms total")
    slow = sorted(spans, key=lambda e: -e.get("dur", 0.0))[:top]
    if slow:
        lines.append(f"top {len(slow)} slowest spans:")
        for e in slow:
            args = e.get("args") or {}
            extra = " ".join(f"{k}={args[k]}" for k in sorted(args)
                             if k in ("seq", "batch", "replica", "bucket",
                                      "reason", "kind"))
            lines.append(f"  {e.get('dur', 0.0) / 1e3:>10.3f} ms  "
                         f"{tracks.get(e.get('tid'), '?'):<12} "
                         f"{e.get('name')}  {extra}".rstrip())
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    if kernels:
        lines.append("kernel profiles (measured vs modeled roofline):")
        for e in kernels:
            a = e.get("args") or {}
            lines.append(
                f"  {e.get('name'):<24} wall {a.get('wall_us', 0.0):>12.1f} us"
                f"  hbm {a.get('hbm_modeled_bytes', 0):>10} B"
                f"  {a.get('gbps', 0.0):>8.4f} GB/s"
                f"  {a.get('vs_roofline', 0.0):>8.1f}x roofline")
    return "\n".join(lines)


def report_metrics(parsed: dict, max_series: int = 40) -> str:
    n_series = sum(len(s) for s in parsed.values())
    lines = [f"metrics: {len(parsed)} metrics, {n_series} series"]
    shown = 0
    for name in sorted(parsed):
        for series, value in sorted(parsed[name].items()):
            if shown >= max_series:
                lines.append(f"  ... ({n_series - shown} more series)")
                return "\n".join(lines)
            lines.append(f"  {name}{series} = "
                         f"{int(value) if value == int(value) else value}")
            shown += 1
    return "\n".join(lines)


def report_alerts(alerts: List[dict], max_alerts: int = 20) -> str:
    if not alerts:
        return "alerts: none"
    by_rule: dict = {}
    for a in alerts:
        by_rule[a["rule"]] = by_rule.get(a["rule"], 0) + 1
    lines = [f"alerts: {len(alerts)} fired "
             f"({', '.join(f'{r}={by_rule[r]}' for r in sorted(by_rule))})"]
    for a in alerts[:max_alerts]:
        lines.append(f"  t={a['t']:.4f} [{a['severity']}] "
                     f"{a['rule']}: {a['message']}")
    if len(alerts) > max_alerts:
        lines.append(f"  ... ({len(alerts) - max_alerts} more)")
    return "\n".join(lines)


def report_bundle(bundle: dict) -> str:
    m = bundle["manifest"]
    lines = [f"bundle: reason={m['reason']} t={m['t']:.4f} "
             f"seq={m['seq']} files={len(m['files'])}"]
    servers = (m.get("census") or {}).get("servers") or {}
    for name in sorted(servers):
        s = servers[name]
        lines.append(f"  server {name}: pending={s.get('pending')} "
                     f"in_flight={s.get('in_flight')} "
                     f"active={s.get('active_replicas')}/"
                     f"{s.get('replicas')}")
    rec = m.get("recorder")
    if rec:
        lines.append(f"  recorder: {rec.get('events')} events "
                     f"({rec.get('dropped_events')} evicted), "
                     f"{rec.get('metric_samples')} metric samples")
    return "\n".join(lines)


def _cmd_dump(args) -> int:
    from repro_torch.obs.bundle import assemble_bundle
    if not (args.trace or args.metrics or args.alerts):
        print("error: dump needs at least one of --trace/--metrics/--alerts",
              file=sys.stderr)
        return 1
    try:
        path = assemble_bundle(args.out, trace_path=args.trace,
                               metrics_path=args.metrics,
                               alerts_path=args.alerts, reason=args.reason)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"bundle written: {path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize exported observability artifacts.")
    ap.add_argument("cmd", nargs="?", choices=["dump"],
                    help="optional subcommand: 'dump' assembles a debug "
                         "bundle from exported artifacts")
    ap.add_argument("--trace", help="Chrome trace_event JSON (--trace-out)")
    ap.add_argument("--metrics", help="Prometheus text file (--metrics-out)")
    ap.add_argument("--alerts",
                    help="alert log (.alerts.jsonl) or bundle directory")
    ap.add_argument("--bundle", help="debug-bundle directory to summarize")
    ap.add_argument("--assert-no-alerts", action="store_true",
                    help="exit 1 if the alert log contains any alert")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest spans to list (default 10)")
    ap.add_argument("--out", default="bundles",
                    help="dump: output directory (default: bundles)")
    ap.add_argument("--reason", default="manual",
                    help="dump: bundle reason label (default: manual)")
    ap.add_argument("--json", dest="json_out",
                    help="also write the parsed summary as JSON")
    args = ap.parse_args(argv)

    if args.cmd == "dump":
        return _cmd_dump(args)

    if not (args.trace or args.metrics or args.alerts or args.bundle):
        ap.error("nothing to report: pass --trace, --metrics, --alerts "
                 "and/or --bundle")

    summary = {}
    alerts: List[dict] = []
    try:
        if args.trace:
            events = load_chrome_trace(args.trace)
            print(report_trace(events, top=args.top))
            summary["trace_events"] = len(events)
        if args.metrics:
            with open(args.metrics) as f:
                parsed = parse_text(f.read())
            print(report_metrics(parsed))
            summary["metrics"] = len(parsed)
        if args.bundle:
            from repro_torch.obs.bundle import read_bundle
            bundle = read_bundle(args.bundle)
            print(report_bundle(bundle))
            summary["bundle_files"] = len(bundle["manifest"]["files"])
            if not args.alerts:
                alerts = bundle["alerts"]
                print(report_alerts(alerts))
                summary["alerts"] = len(alerts)
        if args.alerts:
            alerts = load_alerts(args.alerts)
            print(report_alerts(alerts))
            summary["alerts"] = len(alerts)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.assert_no_alerts and alerts:
        print(f"error: --assert-no-alerts but {len(alerts)} alerts fired",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
