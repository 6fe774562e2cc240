"""Live trace-driven serving: the control plane over ``ShardedResNetEngine``.

The port's copy of ``repro.traffic.live``.  Where
``repro_torch.traffic.sim`` models time, this module spends it: arrivals
are paced on the engine's real clock, batches run on the cards through
the real replica pool (each bucket a CUDA graph), and the router/
autoscaler act on the live scheduler state.  The routing, SLO accounting
and report schema are shared with the simulator (``slo.SLOAccounting`` /
``degrade.OverloadRouter``), so the two paths answer the same questions —
the simulator deterministically in tests, this one against the wall clock
for the CLI.

``variants`` maps variant name -> engine; every engine is an independent
``ShardedResNetEngine`` (own pool, own scheduler) compiled up front, so
degrading a request is *only* an admission-time routing choice — nothing
recompiles under overload.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serve import sched as S
from repro_torch.serve.engine import ImageRequest, ShardedResNetEngine
from repro_torch.traffic.autoscale import Autoscaler
from repro_torch.traffic.degrade import (
    OverloadRouter, ServerSignals, effective_accuracy)
from repro_torch.traffic.loadgen import Arrival
from repro_torch.traffic.slo import SLOAccounting, classes_by_name


@dataclasses.dataclass
class _Tracked:
    """One admitted request: the engine payload + where it was routed."""

    arrival: Arrival
    req: Optional[ImageRequest]       # None when the router dropped it
    sreq: Optional[S.ScheduledRequest]
    variant: Optional[str]
    degraded: bool


class LiveTrafficRunner:
    """Drive a trace through real engines on the primary engine's clock."""

    def __init__(self, variants: Dict[str, ShardedResNetEngine], classes,
                 router: OverloadRouter,
                 autoscaler: Optional[Autoscaler] = None,
                 scale_interval_s: float = 0.02, health=None):
        if router.primary not in variants:
            raise ValueError(
                f"router primary {router.primary!r} not in {list(variants)}")
        self.variants = variants
        self.classes = classes_by_name(classes)
        self.router = router
        self.autoscaler = autoscaler
        self.scale_interval_s = float(scale_interval_s)
        self.clock = variants[router.primary].clock
        self.acct = SLOAccounting(self.classes.values())
        self.tracked: List[_Tracked] = []
        self.health = health
        if health is not None:
            for name, e in variants.items():
                health.attach_server(name, e.sched)

    def _admit(self, a: Arrival, rid: int, images, labels) -> None:
        cls = self.classes[a.slo]
        decision = self.router.route(
            a.slo, {n: ServerSignals.of(e.sched)
                    for n, e in self.variants.items()})
        self.acct.record_submit(a.slo)
        if decision.dropped:
            self.acct.record_drop(a.slo)
            self.tracked.append(_Tracked(a, None, None, None, False))
            return
        eng = self.variants[decision.target]
        req = ImageRequest(rid=rid, image=images[rid % len(images)])
        if labels is not None:
            req.true_label = int(labels[rid % len(labels)])   # scored later
        sreq = eng.submit(req, deadline_ms=cls.deadline_ms,
                          priority=cls.priority)
        self.tracked.append(_Tracked(a, req, sreq, decision.target,
                                     decision.degraded))

    def _autoscale(self) -> None:
        eng = self.variants[self.router.primary]
        busy = sum(1 for r in eng.sched.replicas[:eng.sched.active]
                   if r.in_flight > 0)
        self.autoscaler.observe(busy, eng.queue_depth,
                                slots_per_replica=eng.batch)
        eng.set_active_replicas(self.autoscaler.active,
                                reason=self.autoscaler.last_reason)

    def run(self, arrivals: List[Arrival], images, labels=None,
            accuracy_by_variant: Optional[Dict[str, float]] = None) -> dict:
        unknown = sorted({a.slo for a in arrivals} - set(self.classes))
        if unknown:
            raise ValueError(f"arrivals use undefined SLO classes {unknown}")
        clock = self.clock
        t0 = clock.now()
        i = 0
        next_scale = 0.0
        next_health = 0.0
        while i < len(arrivals) or \
                any(e.outstanding or e._in_flight
                    for e in self.variants.values()):
            now = clock.now() - t0
            while i < len(arrivals) and arrivals[i].t <= now:
                self._admit(arrivals[i], i, images, labels)
                i += 1
            progressed = False
            for e in self.variants.values():
                progressed |= e.tick()
            if self.health is not None and now >= next_health:
                self.health.tick(clock.now())
                next_health = now + self.health.interval_s
            if self.autoscaler is not None and now >= next_scale:
                self._autoscale()
                next_scale = now + self.scale_interval_s
            if not progressed:
                # nothing due anywhere: sleep to the next arrival or the
                # earliest coalescer due time instead of spinning
                waits = [arrivals[i].t - (clock.now() - t0)] \
                    if i < len(arrivals) else []
                for e in self.variants.values():
                    due = e.sched.next_due_at()
                    if due is not None:
                        waits.append(due - clock.now())
                if self.autoscaler is not None:
                    waits.append(next_scale - (clock.now() - t0))
                clock.sleep(min([w for w in waits if w > 0], default=1e-4)
                            if waits else 1e-4)
        # score served requests into the per-class accounting
        for t in self.tracked:
            if t.sreq is not None and t.req is not None and t.req.done:
                self.acct.record_served(t.arrival.slo, t.sreq,
                                        variant=t.variant,
                                        degraded=t.degraded)
        return self._report(t0, labels is not None, accuracy_by_variant)

    def _report(self, t0: float, have_labels: bool,
                accuracy_by_variant: Optional[Dict[str, float]]) -> dict:
        report = dict(duration_s=self.clock.now() - t0,
                      **self.acct.report(),
                      servers={n: e.latency_stats()
                               for n, e in sorted(self.variants.items())})
        if self.autoscaler is not None:
            report["autoscaler"] = self.autoscaler.summary()
        if self.health is not None:
            report["health"] = self.health.summary()
        totals = report["totals"]
        if totals["submitted"] and report["duration_s"] > 0:
            totals["fps"] = round(totals["served"] / report["duration_s"], 1)
        if accuracy_by_variant is not None:
            report["accuracy"] = effective_accuracy(
                self.acct.served_by_variant,
                dropped=totals["submitted"] - totals["served"],
                accuracy_by_variant=accuracy_by_variant,
                primary=self.router.primary)
        if have_labels:
            scored = [t for t in self.tracked
                      if t.req is not None and t.req.done
                      and getattr(t.req, "true_label", None) is not None]
            correct = sum(int(t.req.label == t.req.true_label)
                          for t in scored)
            if totals["submitted"]:
                report["measured_accuracy"] = dict(
                    correct=correct, scored=len(scored),
                    effective_top1=round(
                        correct / totals["submitted"], 6))
        return report
