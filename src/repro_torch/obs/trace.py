"""Span tracing with Chrome ``trace_event`` and JSONL export.

The port's copy of ``repro.obs.trace``, the same code, so that both
packages export the same trace for the same events.  Spans are recorded
*after the fact*: every call site already knows both endpoints of the
interval it measured (device times around kernels, a clock read around a
build), so there is no begin/end token API to keep balanced, just:

    trace.span("compute", cat="sched", track="requests", t0=a, t1=b, seq=7)
    trace.instant("retrace", cat="compile", track="compile", bucket=8)

Timestamps come from the injected clock domain (any object with a
``now()`` in seconds, e.g. a fake clock in a simulation; ``time.monotonic``
live), so under a seeded simulation the whole event log is deterministic.

Export formats:

* ``chrome()`` — a Chrome ``trace_event`` JSON object (Perfetto /
  chrome://tracing loadable): ``ph:"X"`` complete events with µs ``ts``/
  ``dur``, ``ph:"i"`` instants, plus ``ph:"M"`` metadata naming each track.
  Tracks map to ``pid=1`` and a ``tid`` assigned by sorted track name at
  export time, so the mapping never depends on recording order.
* ``jsonl()`` — one JSON object per event, in recording order.

Volatility: kernel-profile *durations* are measurements and some span args
(``wall_us``, ``gbps``, ``vs_roofline``…) derive from them.  Those fields
are enumerated here (``VOLATILE_ARGS`` / ``VOLATILE_CATS``) and stripped by
``strip_volatile=True`` exports, which is what the trace determinism tests
compare.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "TraceEvent", "Trace", "VOLATILE_ARGS", "VOLATILE_CATS",
    "strip_volatile_events",
]

# Args whose values are wall-clock-derived even in virtual-time runs.
VOLATILE_ARGS = frozenset({
    "wall_us", "wall_ms", "wall_s", "gbps", "vs_roofline", "us_per_call",
})

# Event categories whose ts/dur are wall measurements rather than values in
# the injected clock domain (kernel profiling times real executions).
VOLATILE_CATS = frozenset({"kernel"})


@dataclasses.dataclass
class TraceEvent:
    """One event: ``ph`` is the Chrome phase ("X" complete span, "i"
    instant).  ``ts``/``dur`` are seconds in the trace's clock domain."""

    ph: str
    name: str
    cat: str
    track: str
    ts: float
    dur: float = 0.0
    args: Optional[Dict[str, Any]] = None

    def to_dict(self) -> dict:
        d = dict(ph=self.ph, name=self.name, cat=self.cat, track=self.track,
                 ts=self.ts)
        if self.ph == "X":
            d["dur"] = self.dur
        if self.args:
            d["args"] = self.args
        return d


def _strip_args(args: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not args:
        return args
    kept = {k: v for k, v in args.items() if k not in VOLATILE_ARGS}
    return kept or None


def strip_volatile_events(events: List[TraceEvent]) -> List[TraceEvent]:
    """Copy of ``events`` with the documented volatile content removed:
    volatile args dropped everywhere; ``ts``/``dur`` zeroed for events in
    ``VOLATILE_CATS``.  What remains must be byte-identical across seeded
    ``FakeClock`` runs."""
    out = []
    for e in events:
        wall = e.cat in VOLATILE_CATS
        out.append(TraceEvent(ph=e.ph, name=e.name, cat=e.cat, track=e.track,
                              ts=0.0 if wall else e.ts,
                              dur=0.0 if wall else e.dur,
                              args=_strip_args(e.args)))
    return out


class Trace:
    """An append-only event log bound to an injectable clock."""

    def __init__(self, clock=None):
        self.clock = clock
        self.events: List[TraceEvent] = []

    def now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.monotonic()

    def __len__(self) -> int:
        return len(self.events)

    # -- recording ----------------------------------------------------------

    def span(self, name: str, cat: str = "", track: str = "main",
             t0: Optional[float] = None, t1: Optional[float] = None,
             **args) -> TraceEvent:
        """Record a complete span [t0, t1] (defaults: both = now)."""
        if t1 is None:
            t1 = self.now()
        if t0 is None:
            t0 = t1
        e = TraceEvent(ph="X", name=name, cat=cat, track=track,
                       ts=float(t0), dur=max(float(t1) - float(t0), 0.0),
                       args=dict(args) if args else None)
        self.events.append(e)
        return e

    def instant(self, name: str, cat: str = "", track: str = "main",
                t: Optional[float] = None, **args) -> TraceEvent:
        e = TraceEvent(ph="i", name=name, cat=cat, track=track,
                       ts=float(t) if t is not None else self.now(),
                       args=dict(args) if args else None)
        self.events.append(e)
        return e

    # -- export -------------------------------------------------------------

    def _tids(self) -> Dict[str, int]:
        # sorted-by-name assignment: independent of recording order
        return {t: i + 1
                for i, t in enumerate(sorted({e.track for e in self.events}))}

    def chrome(self, strip_volatile: bool = False) -> dict:
        """Chrome ``trace_event`` JSON object (µs timestamps)."""
        events = strip_volatile_events(self.events) if strip_volatile \
            else self.events
        tids = self._tids()
        out: List[dict] = [
            {"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
             "args": {"name": track}}
            for track, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        for e in events:
            d: Dict[str, Any] = {
                "ph": e.ph, "name": e.name, "cat": e.cat or "default",
                "pid": 1, "tid": tids[e.track],
                "ts": round(e.ts * 1e6, 3),
            }
            if e.ph == "X":
                d["dur"] = round(e.dur * 1e6, 3)
            elif e.ph == "i":
                d["s"] = "t"                      # thread-scoped instant
            if e.args:
                d["args"] = e.args
            out.append(d)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def jsonl(self, strip_volatile: bool = False) -> str:
        """One JSON object per line, recording order, seconds timestamps."""
        events = strip_volatile_events(self.events) if strip_volatile \
            else self.events
        return "".join(json.dumps(e.to_dict(), sort_keys=True) + "\n"
                       for e in events)

    def write_chrome(self, path: str, strip_volatile: bool = False) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(strip_volatile=strip_volatile), f)
            f.write("\n")

    def write_jsonl(self, path: str, strip_volatile: bool = False) -> None:
        with open(path, "w") as f:
            f.write(self.jsonl(strip_volatile=strip_volatile))

    # -- summary ------------------------------------------------------------

    def summary(self) -> dict:
        spans = [e for e in self.events if e.ph == "X"]
        by_track: Dict[str, dict] = {}
        for e in spans:
            row = by_track.setdefault(e.track, dict(spans=0, total_s=0.0))
            row["spans"] += 1
            row["total_s"] += e.dur
        return dict(events=len(self.events), spans=len(spans),
                    instants=sum(1 for e in self.events if e.ph == "i"),
                    tracks={t: by_track[t] for t in sorted(by_track)})
