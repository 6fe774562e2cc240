"""Replica autoscaling: grow/shrink the active replica set from load.

The port's copy of ``repro.traffic.autoscale``.

The policy loop watches two signals on the primary server —

* **queue pressure**: pending requests per active replica batch slot
  (``queue_depth / (active * max_batch)``), the leading indicator; and
* **EWMA utilization**: the fraction of active replicas busy, smoothed so a
  single idle poll does not flap the fleet,

and actuates through ``Scheduler.set_active`` (a deactivated replica keeps
its executables warm and finishes in-flight work — scaling is routing, not
teardown, the analogue of clock-gating a pipeline replica rather than
reconfiguring the fabric).  Two stabilizers:

* **hysteresis** — scale up above ``high_util``, down only below
  ``low_util`` *with an empty queue*; the band between them is dead, so the
  controller cannot oscillate around a single threshold; and
* **cooldown** — at least ``cooldown_s`` between consecutive scaling
  actions (clocked by the injected clock, so a
  :class:`~repro_torch.serve.sched.FakeClock` makes every decision
  unit-testable without wall time).

Every decision is recorded in ``decisions`` (time, from, to, reason) for
reports and tests.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.obs import runtime as _obs
from repro_torch.serve import sched as S


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    high_util: float = 0.75       # scale up when EWMA utilization exceeds
    low_util: float = 0.25        # scale down only below (hysteresis band)
    queue_high: float = 2.0       # pending per active batch slot forcing up
    cooldown_s: float = 0.25      # min seconds between scaling actions
    ewma: float = 0.5             # utilization smoothing step

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas: "
                f"{self.min_replicas}, {self.max_replicas}")
        if not (0.0 <= self.low_util < self.high_util <= 1.0):
            raise ValueError(
                f"need 0 <= low_util < high_util <= 1: "
                f"{self.low_util}, {self.high_util}")
        if self.cooldown_s < 0 or not (0 < self.ewma <= 1):
            raise ValueError("cooldown_s must be >= 0 and 0 < ewma <= 1")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    t: float
    from_replicas: int
    to_replicas: int
    reason: str          # "queue" | "util-high" | "util-low" | "alert:<rule>"
    util_ewma: float
    queue_depth: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Autoscaler:
    """The policy loop.  ``observe`` ingests one load sample and returns the
    (possibly updated) active-replica target; the caller actuates it
    (``Scheduler.set_active`` / ``ShardedResNetEngine.set_active_replicas``).
    """

    def __init__(self, config: Optional[AutoscaleConfig] = None, clock=None,
                 active: Optional[int] = None, health=None):
        self.config = config or AutoscaleConfig()
        self.clock = clock if clock is not None else S.MonotonicClock()
        self.active = int(active) if active is not None \
            else self.config.min_replicas
        self.active = max(self.config.min_replicas,
                          min(self.active, self.config.max_replicas))
        self.util_ewma = 0.0
        self.decisions: List[ScaleDecision] = []
        self._last_change_t: Optional[float] = None
        # optional HealthMonitor signal source: an active overload alert
        # requests a scale-up ahead of the raw queue/util thresholds
        self.health = health

    def observe(self, busy: int, queue_depth: int,
                slots_per_replica: int = 1) -> int:
        """One control step.  ``busy`` = replicas currently executing a
        batch, ``queue_depth`` = admitted-not-dispatched requests,
        ``slots_per_replica`` = the micro-batch size (so queue pressure is
        measured in dispatch rounds, not raw requests)."""
        cfg = self.config
        now = self.clock.now()
        util = busy / max(self.active, 1)
        self.util_ewma += cfg.ewma * (util - self.util_ewma)
        queue_per_slot = queue_depth / max(
            self.active * max(slots_per_replica, 1), 1)

        target, reason = self.active, None
        hint = self.health.scale_hint() if self.health is not None else None
        if hint is not None:
            target, reason = self.active + 1, "alert:" + hint
        elif queue_per_slot >= cfg.queue_high:
            target, reason = self.active + 1, "queue"
        elif self.util_ewma > cfg.high_util:
            target, reason = self.active + 1, "util-high"
        elif self.util_ewma < cfg.low_util and queue_depth == 0:
            target, reason = self.active - 1, "util-low"
        target = max(cfg.min_replicas, min(target, cfg.max_replicas))

        if target != self.active and self._cooled(now):
            self.decisions.append(ScaleDecision(
                t=now, from_replicas=self.active, to_replicas=target,
                reason=reason, util_ewma=round(self.util_ewma, 6),
                queue_depth=queue_depth))
            ob = _obs.active()
            if ob is not None:
                ob.metrics.counter(
                    "autoscale_decisions_total",
                    "policy decisions by trigger").inc(reason=reason)
                ob.trace.instant("autoscale", cat="control", track="control",
                                 t=now, from_replicas=self.active,
                                 to_replicas=target, reason=reason,
                                 queue_depth=queue_depth)
            self.active = target
            self._last_change_t = now
        return self.active

    @property
    def last_reason(self) -> Optional[str]:
        """The most recent decision's trigger (None before any decision) —
        what the actuation call passes to ``set_active(reason=...)``."""
        return self.decisions[-1].reason if self.decisions else None

    def _cooled(self, now: float) -> bool:
        return self._last_change_t is None or \
            now - self._last_change_t >= self.config.cooldown_s

    def summary(self) -> dict:
        return dict(active=self.active,
                    util_ewma=round(self.util_ewma, 6),
                    scale_events=len(self.decisions),
                    last_reason=self.last_reason,
                    decisions=[d.to_dict() for d in self.decisions])
