"""Flight recorder: bounded rings of recent spans and metric deltas.

The port's copy of ``repro.obs.recorder``.  A long-running server cannot
keep its whole trace in memory, but the minutes *before* an incident are
exactly what a post-mortem needs.  The :class:`FlightRecorder` subscribes
to the session's :class:`~repro_torch.obs.trace.Trace`
(``trace.listeners``) and keeps the last ``events_capacity`` events in a
ring; :meth:`record_metrics` (called from the health
monitor's tick) stores *changed-keys-only* metric deltas in a second
ring.  Both rings live on the injected clock — nothing here reads wall
time — and eviction is pure ``deque(maxlen=...)``, so overhead is a
constant append per event.

On alert (or drain-with-missed-deadlines, or ``python -m
repro_torch.obs dump``) the rings are frozen into a debug bundle — see
:mod:`repro_torch.obs.bundle`.
"""
from __future__ import annotations

import collections
from typing import Any, Deque, Dict, List, Tuple

from repro_torch.obs.trace import Trace, TraceEvent

__all__ = ["FlightRecorder", "flatten_snapshot"]


def flatten_snapshot(registry) -> Dict[str, float]:
    """One flat ``metric||series -> number`` map from a registry snapshot:
    counters/gauges contribute their value per label set, histograms their
    ``count`` and ``sum``.  Keys are canonical (snapshot order is sorted),
    so two equal registries flatten byte-identically."""
    flat: Dict[str, float] = {}
    for name, snap in registry.snapshot().items():
        kind, series = snap["kind"], snap["series"]
        for labels, value in series.items():
            key = f"{name}||{labels}"
            if kind == "histogram":
                flat[key + "||count"] = float(value["count"])
                flat[key + "||sum"] = float(value["sum"])
            else:
                flat[key] = float(value)
    return flat


class FlightRecorder:
    """Two bounded rings: raw trace events and metric deltas."""

    def __init__(self, events_capacity: int = 2048,
                 snapshots_capacity: int = 64):
        self.events_capacity = int(events_capacity)
        self.snapshots_capacity = int(snapshots_capacity)
        self.events: Deque[TraceEvent] = \
            collections.deque(maxlen=self.events_capacity)
        self.deltas: Deque[Tuple[float, Dict[str, float]]] = \
            collections.deque(maxlen=self.snapshots_capacity)
        self.dropped_events = 0
        self.seen_events = 0
        self._last_flat: Dict[str, float] = {}

    # -- trace side ---------------------------------------------------------

    def attach(self, trace: Trace) -> None:
        trace.listeners.append(self.on_event)

    def on_event(self, e: TraceEvent) -> None:
        self.seen_events += 1
        if len(self.events) == self.events_capacity:
            self.dropped_events += 1
        self.events.append(e)

    # -- metrics side -------------------------------------------------------

    def record_metrics(self, now: float, registry) -> None:
        """Store the keys that changed since the last call (full values,
        not differences — replaying the ring reconstructs each sampled
        state without needing the pre-ring baseline)."""
        flat = flatten_snapshot(registry)
        changed = {k: v for k, v in flat.items()
                   if self._last_flat.get(k) != v}
        self._last_flat = flat
        if changed:
            self.deltas.append((now, changed))

    # -- export -------------------------------------------------------------

    def chrome(self) -> dict:
        """Chrome ``trace_event`` JSON over the ring contents only (same
        format as ``Trace.chrome`` — Perfetto-loadable)."""
        snap = Trace()
        snap.events = list(self.events)
        return snap.chrome()

    def delta_lines(self) -> List[dict]:
        return [dict(t=t, changed=dict(sorted(changed.items())))
                for t, changed in self.deltas]

    def summary(self) -> dict:
        return dict(events=len(self.events),
                    events_capacity=self.events_capacity,
                    seen_events=self.seen_events,
                    dropped_events=self.dropped_events,
                    metric_samples=len(self.deltas),
                    snapshots_capacity=self.snapshots_capacity)
