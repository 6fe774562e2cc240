"""Virtual-time traffic simulation: the whole control plane under FakeClock.

The port's copy of ``repro.traffic.sim``.  The simulator drives the *real*
scheduling stack — ``serve.sched.Scheduler`` (coalescing, priorities,
deadlines, least-loaded replica selection, the EWMA service estimate), the
overload router, and the autoscaler — in fully deterministic virtual time:
no real sleeping, no wall-clock flakiness, the same seed reproducing the
same timeline request for request.  Two things are modeled instead of
executed:

* **time** — a :class:`~repro_torch.serve.sched.FakeClock` advanced
  event-to-event (next arrival, next batch completion, next coalescer due time,
  next autoscaler tick);
* **service** — a :class:`ServiceModel` (``base_s + per_item_s * n`` per
  batch of *n*, per replica, replicas serializing their own batches), with
  :data:`PAPER_FPS` providing Kria KV260 Table-3 defaults so "arrival rate
  exceeds ResNet20 capacity but not ResNet8 capacity" is a statement about
  the paper's measured FPGA envelope (not the GPU's: the card serving the
  real model runs at its own speed, which virtual time does not see).

Arithmetic is NOT modeled: attach a real ``CompiledModel`` per variant and
every simulated dispatch runs the genuine executable on the model's
device (a CUDA graph replay on the GPU; the logits come back to the host
once per dispatch) — the served logits are bitwise those of
``ShardedResNetEngine`` serving the same images (acceptance-pinned in
tests/test_torch_traffic.py), so the simulator doubles as
an end-to-end correctness harness, not just a queueing toy.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve import sched as S
from repro_torch.traffic.autoscale import Autoscaler
from repro_torch.traffic.degrade import (
    OverloadRouter, ServerSignals, effective_accuracy)
from repro_torch.traffic.loadgen import Arrival
from repro_torch.traffic.slo import SLOAccounting, SLOClass, classes_by_name

#: paper Table 3 throughput on the Kria KV260 FPGA (the paper's figures,
#: not a GPU measurement) — the service-model anchor
PAPER_FPS = {"resnet8": 30153.0, "resnet20": 7601.0}


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Per-replica batch service time: ``base_s + per_item_s * n``."""

    base_s: float
    per_item_s: float

    def batch_s(self, n: int) -> float:
        return self.base_s + self.per_item_s * max(int(n), 0)

    @classmethod
    def from_fps(cls, fps: float, base_ms: float = 0.1) -> "ServiceModel":
        """Anchor the marginal per-image cost to a throughput figure (e.g.
        :data:`PAPER_FPS`); ``base_ms`` is the fixed per-dispatch overhead."""
        if fps <= 0:
            raise ValueError(f"fps must be positive: {fps}")
        return cls(base_s=base_ms * 1e-3, per_item_s=1.0 / fps)

    def capacity_fps(self, max_batch: int, replicas: int = 1) -> float:
        """Steady-state throughput ceiling at full batches."""
        return replicas * max_batch / self.batch_s(max_batch)


@dataclasses.dataclass
class SimRequest:
    """The simulator's payload — mirrors ``serve.engine.ImageRequest`` plus
    the SLO/routing tags."""

    rid: int
    slo: str
    image: Optional[np.ndarray] = None
    label: Optional[int] = None
    variant: Optional[str] = None
    degraded: bool = False
    logits: Optional[np.ndarray] = None
    pred: Optional[int] = None
    done: bool = False


class SimServer:
    """One model variant under simulation: a real ``Scheduler`` over
    ``replicas`` virtual devices, each serializing its own dispatches at
    :class:`ServiceModel` speed; logits (optionally) from a real compiled
    model so the arithmetic is the production arithmetic."""

    def __init__(self, name: str, service: ServiceModel, clock: S.FakeClock,
                 replicas: int = 1, max_batch: int = 8,
                 slack_ms: float = 2.0, model=None,
                 active: Optional[int] = None):
        self.name = name
        self.service = service
        self.clock = clock
        self.model = model
        self.sched = S.Scheduler(
            replicas, max_batch=max_batch, slack_s=slack_ms * 1e-3,
            clock=clock, service_estimate_s=service.batch_s(max_batch))
        if active is not None:
            self.sched.set_active(active)
        self._free_at = [0.0] * replicas
        self._completions: List[tuple] = []    # heap: (finish_t, seq, d)
        self._seq = 0

    # -- admission / signals -------------------------------------------------

    def submit(self, req: SimRequest, deadline_in: float,
               priority: int) -> S.ScheduledRequest:
        return self.sched.submit(req, deadline_in=deadline_in,
                                 priority=priority)

    def signals(self) -> ServerSignals:
        return ServerSignals.of(self.sched)

    def has_work(self) -> bool:
        return bool(self.sched.outstanding or self._completions)

    def busy(self, now: float) -> int:
        """Active replicas still executing a batch at ``now``."""
        return sum(1 for f in self._free_at[:self.sched.active] if f > now)

    # -- the two event-loop hooks -------------------------------------------

    def start_due(self, now: float) -> int:
        """Dispatch every due micro-batch: the chosen replica starts it when
        it frees up and finishes one modeled service time later.  Real
        logits are computed at dispatch (the arithmetic is instantaneous in
        virtual time) and attached at completion."""
        n = 0
        while True:
            d = self.sched.poll(now)
            if d is None:
                break
            idx = d.replica.index
            start = max(now, self._free_at[idx])
            finish = start + self.service.batch_s(len(d))
            self._free_at[idx] = finish
            logits = None
            if self.model is not None:
                imgs = np.stack([np.asarray(r.payload.image, np.float32)
                                 for r in d.requests])
                logits = self.model(imgs).cpu().numpy()
            heapq.heappush(self._completions,
                           (finish, self._seq, d, logits))
            self._seq += 1
            n += 1
        return n

    def complete_ready(self, now: float, on_complete=None) -> int:
        """Complete every dispatch whose modeled finish time has passed."""
        n = 0
        while self._completions and self._completions[0][0] <= now + 1e-12:
            finish, _, d, logits = heapq.heappop(self._completions)
            self.sched.complete(d, now=finish)
            for j, r in enumerate(d.requests):
                req: SimRequest = r.payload
                req.variant = self.name
                if logits is not None:
                    req.logits = logits[j]
                    req.pred = int(np.argmax(logits[j]))
                req.done = True
                if on_complete is not None:
                    on_complete(req, r)
            n += 1
        return n

    def next_event(self) -> Optional[float]:
        cands = []
        if self._completions:
            cands.append(self._completions[0][0])
        due = self.sched.next_due_at()
        if due is not None:
            cands.append(due)
        return min(cands) if cands else None


class TrafficSim:
    """The end-to-end control-plane loop in virtual time: arrivals routed
    per SLO-class policy across variant servers, the autoscaler steering the
    primary server's active replica set, per-class accounting throughout."""

    def __init__(self, servers: Dict[str, SimServer], classes,
                 router: OverloadRouter, clock: S.FakeClock,
                 autoscaler: Optional[Autoscaler] = None,
                 scale_interval_s: float = 0.02, health=None):
        if router.primary not in servers:
            raise ValueError(
                f"router primary {router.primary!r} not in {list(servers)}")
        self.servers = servers
        self.classes = classes_by_name(classes)
        self.router = router
        self.clock = clock
        self.autoscaler = autoscaler
        self.scale_interval_s = float(scale_interval_s)
        self.acct = SLOAccounting(self.classes.values())
        self.requests: List[SimRequest] = []
        # optional HealthMonitor ticked at its own cadence in the event
        # loop; the monitor samples queue depth from the attached scheds
        self.health = health
        if health is not None:
            for name, s in servers.items():
                health.attach_server(name, s.sched)

    def _admit(self, a: Arrival, rid: int, images, labels) -> None:
        cls = self.classes[a.slo]
        decision = self.router.route(
            a.slo, {n: s.signals() for n, s in self.servers.items()})
        self.acct.record_submit(a.slo)
        req = SimRequest(
            rid=rid, slo=a.slo,
            image=None if images is None else images[rid % len(images)],
            label=None if labels is None else int(labels[rid % len(labels)]),
            degraded=decision.degraded)
        self.requests.append(req)
        if decision.dropped:
            self.acct.record_drop(a.slo)
            return
        self.servers[decision.target].submit(
            req, deadline_in=cls.deadline_ms * 1e-3, priority=cls.priority)

    def _on_complete(self, req: SimRequest, sreq: S.ScheduledRequest) -> None:
        self.acct.record_served(req.slo, sreq, variant=req.variant,
                                degraded=req.degraded)

    def run(self, arrivals: List[Arrival], images=None, labels=None,
            accuracy_by_variant: Optional[Dict[str, float]] = None,
            max_steps: int = 1_000_000) -> dict:
        unknown = sorted({a.slo for a in arrivals} - set(self.classes))
        if unknown:
            raise ValueError(f"arrivals use undefined SLO classes {unknown}")
        if images is not None:
            images = np.asarray(images, np.float32)
        i = 0
        next_scale = self.clock.now()
        next_health = self.clock.now()
        for step in range(max_steps):
            working = any(s.has_work() for s in self.servers.values())
            if i >= len(arrivals) and not working:
                break
            cands = []
            if i < len(arrivals):
                cands.append(arrivals[i].t)
            for s in self.servers.values():
                e = s.next_event()
                if e is not None:
                    cands.append(e)
            if self.autoscaler is not None and working:
                cands.append(next_scale)
            if self.health is not None and working:
                cands.append(next_health)
            t = max(min(cands), self.clock.now())
            self.clock.advance(t - self.clock.now())
            now = self.clock.now()
            for s in self.servers.values():
                s.complete_ready(now, on_complete=self._on_complete)
            while i < len(arrivals) and arrivals[i].t <= now:
                self._admit(arrivals[i], i, images, labels)
                i += 1
            for s in self.servers.values():
                s.start_due(now)
            if self.health is not None and now >= next_health:
                # health before autoscale: the tick's alerts are visible to
                # this round's scale decision, not the next one's
                self.health.tick(now)
                next_health = now + self.health.interval_s
            if self.autoscaler is not None and now >= next_scale:
                prim = self.servers[self.router.primary]
                self.autoscaler.observe(
                    prim.busy(now), prim.sched.pending,
                    slots_per_replica=prim.sched.coalescer.max_batch)
                prim.sched.set_active(self.autoscaler.active,
                                      reason=self.autoscaler.last_reason)
                next_scale = now + self.scale_interval_s
        else:
            raise RuntimeError(
                f"simulation did not converge in {max_steps} steps "
                f"({i}/{len(arrivals)} admitted)")
        return self._report(labels is not None, accuracy_by_variant)

    def _report(self, have_labels: bool,
                accuracy_by_variant: Optional[Dict[str, float]]) -> dict:
        report = dict(duration_s=round(self.clock.now(), 9),
                      **self.acct.report(),
                      servers={n: s.sched.summary()
                               for n, s in sorted(self.servers.items())})
        if self.autoscaler is not None:
            report["autoscaler"] = self.autoscaler.summary()
        if self.health is not None:
            report["health"] = self.health.summary()
        totals = report["totals"]
        if accuracy_by_variant is not None:
            report["accuracy"] = effective_accuracy(
                self.acct.served_by_variant,
                dropped=totals["submitted"] - totals["served"],
                accuracy_by_variant=accuracy_by_variant,
                primary=self.router.primary)
        if have_labels:
            scored = [r for r in self.requests if r.pred is not None]
            correct = sum(int(r.pred == r.label) for r in scored)
            if totals["submitted"]:
                # direct measurement of effective accuracy under load: every
                # submitted request counts, unserved/dropped score zero
                report["measured_accuracy"] = dict(
                    correct=correct, scored=len(scored),
                    effective_top1=round(
                        correct / totals["submitted"], 6))
        return report
