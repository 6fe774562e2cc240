"""Accuracy-aware graceful degradation: the overload router.

The port's copy of ``repro.traffic.degrade``.

The paper's accuracy/throughput/energy Pareto framing (ResNet8 is ~4x the
FPS of ResNet20 at a few points of top-1) becomes a *runtime* policy here:
when the primary model's predicted completion blows a class's deadline, a
``degrade``-policy request is re-routed to a cheaper registered variant — a
ResNet8 answer now beats a ResNet20 answer after the deadline — and a
``drop``-policy request is shed.  ``strict`` classes always take the
primary, overloaded or not.

The overload signal is *predictive*, not reactive: from a server's queue
state (:class:`ServerSignals`) the router estimates when a request admitted
now would complete — ``ceil((outstanding+1) / (active * max_batch))``
dispatch rounds at the EWMA service estimate — and compares that against
the class deadline.  The same estimate works for the virtual-time simulator
and the live engine because both expose a ``Scheduler``.

The accuracy cost is accounted, not hand-waved: :func:`effective_accuracy`
folds per-variant top-1 (measured by ``repro_torch.quantize.evaluate``'s
harness — :func:`variant_accuracies`) with the served-by-variant tally into
one effective-accuracy-under-load number, where a dropped request scores
zero.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.traffic.slo import SLOClass, classes_by_name

#: sentinel routing target meaning "shed this request"
DROP = "__drop__"


@dataclasses.dataclass(frozen=True)
class ServerSignals:
    """The queue-state snapshot the router prices a server with."""

    outstanding: int              # admitted, not yet completed
    active: int                   # replicas receiving dispatches
    max_batch: int
    service_estimate_s: float     # EWMA per-batch service time

    @classmethod
    def of(cls, sched) -> "ServerSignals":
        """Snapshot a :class:`repro_torch.serve.sched.Scheduler`."""
        return cls(outstanding=sched.outstanding, active=sched.active,
                   max_batch=sched.coalescer.max_batch,
                   service_estimate_s=sched.service_estimate_s)

    def predicted_completion_s(self, extra: int = 1) -> float:
        """Seconds until a request admitted now (plus ``extra - 1`` peers)
        would complete: full dispatch rounds ahead of it times the service
        estimate.  Zero while the estimate is cold — a server that has never
        served is never called overloaded (matching the coalescer's
        cold-start dispatch-at-once rule)."""
        slots = max(self.active, 1) * max(self.max_batch, 1)
        rounds = -(-(self.outstanding + extra) // slots)     # ceil div
        return rounds * max(self.service_estimate_s, 0.0)


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    target: str                   # server name, or :data:`DROP`
    degraded: bool = False
    dropped: bool = False
    overloaded: bool = False      # primary was predicted to miss
    reason: Optional[str] = None  # "predicted" | "alert:<rule>" | None


class OverloadRouter:
    """Admission-time routing across registered model variants.

    ``primary`` is the full-accuracy model every request prefers;
    ``degraded`` (optional) is the cheaper variant that ``degrade``-policy
    classes fall back to under overload.  ``enabled=False`` turns the
    policy off (every request goes primary) — the A/B arm of the overload
    experiments.

    ``health`` (optional) subscribes the router to a
    :class:`~repro_torch.obs.health.HealthMonitor`: while an overload-class
    alert is active, the router degrades *pre-emptively* — before the
    queue-state prediction alone would — and the decision carries
    ``reason="alert:<rule>"`` so every actuation is attributable."""

    def __init__(self, classes: Iterable[SLOClass], primary: str,
                 degraded: Optional[str] = None, enabled: bool = True,
                 health=None):
        self.classes = classes_by_name(classes)
        self.primary = primary
        self.degraded = degraded
        self.enabled = enabled
        self.health = health

    def route(self, class_name: str,
              signals: Dict[str, ServerSignals]) -> RouteDecision:
        cls = self.classes[class_name]
        prim = signals[self.primary]
        deadline_s = cls.deadline_ms * 1e-3
        overloaded = prim.predicted_completion_s() > deadline_s
        reason = "predicted" if overloaded else None
        if not overloaded and self.enabled and self.health is not None:
            rule = self.health.overloaded()
            if rule is not None:
                overloaded, reason = True, "alert:" + rule
        if not (self.enabled and overloaded) or cls.policy == "strict":
            return RouteDecision(self.primary, overloaded=overloaded,
                                 reason=reason)
        if cls.policy == "degrade" and self.degraded is not None \
                and self.degraded in signals:
            # only degrade into a variant that can actually still make the
            # deadline; when even the cheap model is swamped, stay primary
            # (same late answer, better accuracy)
            if signals[self.degraded].predicted_completion_s() <= deadline_s:
                self._note_actuation("degrade", class_name, reason)
                return RouteDecision(self.degraded, degraded=True,
                                     overloaded=True, reason=reason)
            return RouteDecision(self.primary, overloaded=True,
                                 reason=reason)
        if cls.policy == "drop":
            self._note_actuation("drop", class_name, reason)
            return RouteDecision(DROP, dropped=True, overloaded=True,
                                 reason=reason)
        return RouteDecision(self.primary, overloaded=True, reason=reason)

    @staticmethod
    def _note_actuation(kind: str, class_name: str,
                        reason: Optional[str]) -> None:
        if not (reason or "").startswith("alert:"):
            return
        from repro_torch.obs import runtime as _obs
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "health_actuations_total",
                "routing actions taken on an active alert").inc(
                    kind=kind, cls=class_name)


# ---------------------------------------------------------------------------
# Accuracy accounting
# ---------------------------------------------------------------------------


def variant_accuracies(variants: Dict[str, tuple], images, labels,
                       backend: str = "cuda", batch: int = 64,
                       device=None) -> Dict[str, float]:
    """Top-1 of every registered variant on a shared eval set, measured by
    ``repro_torch.quantize.evaluate``'s harness (through the real serving
    engine on ``device``, default ``cuda``, so the number is the one
    production would see).  ``variants`` maps variant name -> ``(cfg,
    qparams)``."""
    from repro_torch.quantize import evaluate_variants

    return evaluate_variants(variants, images, labels,
                             backend=backend, batch=batch, device=device)


def effective_accuracy(served_by_variant: Dict[str, int], dropped: int,
                       accuracy_by_variant: Dict[str, float],
                       primary: str) -> dict:
    """Effective accuracy under load: the expected top-1 of a uniformly
    random submitted request.  A request served by variant *v* scores that
    variant's top-1; a dropped (or never-served) request scores 0 — load
    shedding is an accuracy cost too, not a free action."""
    served = {v: n for v, n in served_by_variant.items() if n > 0}
    unknown = sorted(set(served) - set(accuracy_by_variant))
    if unknown:
        raise ValueError(f"no accuracy reference for variants {unknown}")
    total = sum(served.values()) + dropped
    if total == 0:
        return dict(effective_top1=0.0, primary_top1=0.0, accuracy_cost=0.0,
                    served_by_variant={}, dropped=0)
    eff = sum(n * accuracy_by_variant[v] for v, n in served.items()) / total
    prim = accuracy_by_variant.get(primary, 0.0)
    return dict(
        effective_top1=round(eff, 6),
        primary_top1=round(prim, 6),
        # vs the counterfactual where every request got a primary answer in
        # time — what the degradation/shedding traded away for latency
        accuracy_cost=round(prim - eff, 6),
        accuracy_by_variant={v: round(a, 6)
                             for v, a in sorted(accuracy_by_variant.items())},
        served_by_variant=dict(sorted(served.items())),
        dropped=dropped)
