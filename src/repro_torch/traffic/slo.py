"""SLO classes and per-class serving accounting.

The port's copy of ``repro.traffic.slo``, the same classes and report.

An :class:`SLOClass` names a deadline, a scheduler priority, and what to do
when the primary model cannot meet the deadline (the *overload policy*):

* ``strict``  — never degrade, never drop: always the primary model (the
  high-priority class of the acceptance criteria).
* ``degrade`` — under overload, serve through a cheaper registered variant
  (ResNet8 instead of ResNet20): an answer *now* from the small net beats an
  answer from the big net after the deadline.  The accuracy cost is
  accounted (``repro_torch.traffic.degrade``).
* ``drop``    — under overload, shed the request instead of serving it late.

:class:`ClassStats` extends :class:`repro_torch.serve.sched.LatencyStats`
with the submitted/dropped/degraded counters and the deadline-hit-rate, and
:class:`SLOAccounting` holds one per class plus the cross-class totals —
the ``classes`` block of every traffic report (sim, live and benchmark all
build it here, so the JSON schema has one home).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional

from repro_torch.obs import runtime as _obs
from repro_torch.serve import sched as S

POLICIES = ("strict", "degrade", "drop")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: requests tagged with it inherit the deadline, the
    scheduler priority (lower = more urgent), and the overload policy."""

    name: str
    deadline_ms: float
    priority: int
    policy: str = "strict"

    def __post_init__(self):
        if self.deadline_ms <= 0:
            raise ValueError(
                f"{self.name}: deadline_ms must be positive: "
                f"{self.deadline_ms}")
        if self.policy not in POLICIES:
            raise ValueError(
                f"{self.name}: unknown policy {self.policy!r}; "
                f"choose one of {POLICIES}")

    def to_dict(self) -> dict:
        return dict(name=self.name, deadline_ms=self.deadline_ms,
                    priority=self.priority, policy=self.policy)

    @classmethod
    def from_dict(cls, d: dict) -> "SLOClass":
        return cls(name=str(d["name"]), deadline_ms=float(d["deadline_ms"]),
                   priority=int(d["priority"]),
                   policy=str(d.get("policy", "strict")))


#: the default three-tier mix: a strict interactive tier, a degradable
#: standard tier, and a sheddable bulk tier
DEFAULT_CLASSES = (
    SLOClass("interactive", deadline_ms=25.0, priority=0, policy="strict"),
    SLOClass("standard", deadline_ms=50.0, priority=1, policy="degrade"),
    SLOClass("bulk", deadline_ms=200.0, priority=2, policy="drop"),
)


def parse_classes(spec: Optional[str]) -> List[SLOClass]:
    """Parse ``--slo-classes``: either a JSON file path (a list of
    :meth:`SLOClass.to_dict` objects) or an inline
    ``name:deadline_ms:priority[:policy]`` comma-separated spec, e.g.
    ``interactive:25:0:strict,standard:50:1:degrade,bulk:200:2:drop``.
    ``None``/empty returns :data:`DEFAULT_CLASSES`."""
    if not spec:
        return list(DEFAULT_CLASSES)
    if os.path.isfile(spec):
        with open(spec) as f:
            return [SLOClass.from_dict(d) for d in json.load(f)]
    out = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if len(fields) not in (3, 4):
            raise ValueError(
                f"bad SLO class spec {part!r}: want "
                f"name:deadline_ms:priority[:policy]")
        out.append(SLOClass(
            name=fields[0], deadline_ms=float(fields[1]),
            priority=int(fields[2]),
            policy=fields[3] if len(fields) == 4 else "strict"))
    names = [c.name for c in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO class names: {names}")
    return out


def classes_by_name(classes: Iterable[SLOClass]) -> Dict[str, SLOClass]:
    return {c.name: c for c in classes}


class ClassStats(S.LatencyStats):
    """Per-SLO-class accounting: the scheduler's latency/deadline stats plus
    the admission-side counters (submitted, dropped, degraded)."""

    def __init__(self, slo: SLOClass):
        super().__init__()
        self.slo = slo
        self.submitted = 0
        self.dropped = 0
        self.degraded = 0

    @property
    def served(self) -> int:
        return len(self.queue_wait_s)

    @property
    def deadline_hit_rate(self) -> float:
        """Deadlines met over *submitted* — a dropped or still-unserved
        request counts as a miss, so shedding can never launder the rate."""
        if self.submitted == 0:
            return 1.0
        return (self.deadline_total - self.deadline_misses) / self.submitted

    def summary(self) -> dict:
        base = super().summary()
        base.pop("by_priority", None)      # one class == one priority: noise
        base.update(self.slo.to_dict(), submitted=self.submitted,
                    dropped=self.dropped, degraded=self.degraded,
                    deadline_hit_rate=round(self.deadline_hit_rate, 6))
        return base


class SLOAccounting:
    """One :class:`ClassStats` per SLO class + cross-class totals and the
    served-by-variant tally the accuracy accounting consumes."""

    def __init__(self, classes: Iterable[SLOClass]):
        self.classes = classes_by_name(classes)
        self.stats: Dict[str, ClassStats] = {
            name: ClassStats(c) for name, c in self.classes.items()}
        self.served_by_variant: Dict[str, int] = {}

    def __getitem__(self, name: str) -> ClassStats:
        return self.stats[name]

    def record_submit(self, name: str) -> None:
        self.stats[name].submitted += 1
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "slo_submitted_total", "requests submitted by class").inc(
                    cls=name)

    def record_drop(self, name: str) -> None:
        self.stats[name].dropped += 1
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "slo_dropped_total", "requests shed by class").inc(cls=name)

    def record_served(self, name: str, sreq: S.ScheduledRequest,
                      variant: str, degraded: bool = False) -> None:
        cls = self.stats[name]
        cls.record(sreq)
        if degraded:
            cls.degraded += 1
        self.served_by_variant[variant] = \
            self.served_by_variant.get(variant, 0) + 1
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "slo_served_total", "requests served by class and variant"
            ).inc(cls=name, variant=variant,
                  degraded=str(bool(degraded)).lower())
            if sreq.deadline is not None:
                ob.metrics.counter(
                    "slo_deadline_total",
                    "per-class deadline outcomes").inc(
                        cls=name,
                        outcome="met" if sreq.deadline_met else "missed")

    def totals(self) -> dict:
        submitted = sum(c.submitted for c in self.stats.values())
        served = sum(c.served for c in self.stats.values())
        hit = sum(c.deadline_total - c.deadline_misses
                  for c in self.stats.values())
        return dict(
            submitted=submitted, served=served,
            dropped=sum(c.dropped for c in self.stats.values()),
            degraded=sum(c.degraded for c in self.stats.values()),
            deadline_hit_rate=round(hit / submitted, 6) if submitted else 1.0,
            served_by_variant=dict(sorted(self.served_by_variant.items())))

    def report(self) -> dict:
        return dict(
            classes={name: self.stats[name].summary()
                     for name in sorted(self.stats)},
            totals=self.totals())
