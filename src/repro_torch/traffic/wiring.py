"""The pieces that the traffic CLIs build a run from: seeded ResNet weights,
the live pool's devices, the health monitor on the obs session, the export
at the end, and the printed report.

``python -m repro_torch.traffic`` and the SLO path of ``python -m
repro_torch.launch.serve`` both assemble their runs from these, so that the
two cannot drift apart; each CLI keeps only its argument parsing and its
own control flow.
"""
from __future__ import annotations

import os

import torch

from repro_torch.models import resnet as R

RESNET_CFGS = {"resnet8": R.RESNET8, "resnet20": R.RESNET20}


def quantized(arch: str, seed: int):
    """``(cfg, qparams)`` of ``arch`` with random weights from ``seed``:
    ``init_params`` from a seeded ``torch.Generator``, folded and
    quantized."""
    cfg = RESNET_CFGS[arch]
    params = R.init_params(cfg, torch.Generator().manual_seed(seed))
    return cfg, R.quantize_params(R.fold_params(params), cfg)


def pool_devices(device: str, replicas: int):
    """The live engines' devices: ``None`` (every card, one replica a card,
    raising without a GPU) for ``cuda``, else ``replicas`` copies of the
    named device (``cpu``: a pool of CPU replicas)."""
    return None if device == "cuda" else [device] * replicas


def pool_size(device: str, replicas: int) -> int:
    """Replicas a live pool can hold: at most one a card on ``cuda``."""
    if device == "cuda":
        return min(max(replicas, 1), torch.cuda.device_count())
    return max(replicas, 1)


def make_health(classes=None, *, interval_s=None, bundle_dir=None,
                **census):
    """A ``HealthMonitor`` with a ``FlightRecorder`` on the active obs
    session, installed as the session's ``health``: the default rules for
    ``classes`` (``SLOClass`` objects; ``None`` for the rules that need
    none), evaluated every ``interval_s`` (the monitor's default when
    ``None``), dumping bundles into ``bundle_dir`` when one is given.
    ``census`` is stamped on every bundle's manifest.  Returns ``None``
    when no session is active."""
    from repro_torch.obs import FlightRecorder, HealthMonitor, default_rules
    from repro_torch.obs import runtime as _obsrt

    ob = _obsrt.active()
    if ob is None:
        return None
    rec = FlightRecorder()
    rec.attach(ob.trace)
    names = [c.name for c in classes] if classes else None
    kw = {} if interval_s is None else dict(interval_s=interval_s)
    health = HealthMonitor(ob, rules=default_rules(names), recorder=rec,
                           bundle_dir=bundle_dir or None, **kw)
    health.census_extra.update(census)
    ob.health = health
    return health


def finish_obs(ob, *, trace_out="", metrics_out="", jsonl_out="",
               bundle_dir="") -> dict:
    """Export the session's trace, metrics and event log to the paths given,
    uninstall the session, and write the alert log when a monitor ran: into
    ``bundle_dir`` and next to ``metrics_out`` (``alert_log_path``).
    Returns ``{kind: path}`` of everything written."""
    from repro_torch import obs as _o
    from repro_torch.obs import alert_log_path

    written = _o.export(ob, trace_out=trace_out or None,
                        metrics_out=metrics_out or None,
                        jsonl_out=jsonl_out or None)
    _o.disable()
    if ob.health is not None:
        if bundle_dir:
            os.makedirs(bundle_dir, exist_ok=True)
            log = os.path.join(bundle_dir, "alerts.jsonl")
            ob.health.write_alert_log(log)
            written["alerts"] = log
        if metrics_out:
            # the alert log always lands next to the metrics file too
            log = alert_log_path(metrics_out)
            ob.health.write_alert_log(log)
            written["alerts"] = log
    return written


def print_report(report: dict) -> None:
    print(f"\n-- traffic report ({report['duration_s']:.3f}s served time) --")
    for name, c in report["classes"].items():
        print(f"  class {name:<12} submitted={c['submitted']:<5} "
              f"served={c['count']:<5} degraded={c['degraded']:<4} "
              f"dropped={c['dropped']:<4} "
              f"hit-rate={c['deadline_hit_rate']:.3f} "
              f"wait p50/p99 ms={c['queue_wait_ms']['p50']:.2f}/"
              f"{c['queue_wait_ms']['p99']:.2f}")
    t = report["totals"]
    print(f"  totals: {t['submitted']} submitted, {t['served']} served, "
          f"{t['degraded']} degraded, {t['dropped']} dropped, "
          f"hit-rate {t['deadline_hit_rate']:.3f}, "
          f"by variant {t['served_by_variant']}")
    if "autoscaler" in report:
        a = report["autoscaler"]
        print(f"  autoscaler: {a['scale_events']} scale events, "
              f"final active={a['active']}")
        for d in a["decisions"]:
            print(f"    t={d['t']:.3f}s {d['from_replicas']}->"
                  f"{d['to_replicas']} ({d['reason']})")
    if "health" in report:
        h = report["health"]
        print(f"  health: {h['ticks']} ticks, {h['alerts']} alerts "
              f"{h['by_rule']}, {len(h['bundles'])} bundles")
    if "accuracy" in report:
        a = report["accuracy"]
        print(f"  accuracy: effective={a['effective_top1']:.4f} "
              f"primary={a['primary_top1']:.4f} cost={a['accuracy_cost']:.4f}")
    if "measured_accuracy" in report:
        m = report["measured_accuracy"]
        print(f"  measured effective top-1: {m['effective_top1']:.4f} "
              f"({m['correct']}/{m['scored']} scored correct)")
