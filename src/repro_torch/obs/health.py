"""SLO burn-rate alerting and the obs-driven control loop.

The port's copy of ``repro.obs.health``: the same rules, and the same alert
log byte for byte for the same run.  The serving stack already *records*
everything an operator needs — per-class deadline outcomes, queue-wait
histograms, retrace instants, A/B shadow deviations — and nothing else
*reads* the telemetry while the system runs.  :class:`HealthMonitor` closes
that gap: a deterministic, clock-injectable alert engine evaluated at a
fixed cadence over the live
:class:`~repro_torch.obs.metrics.MetricsRegistry`.

Rules
-----

* :class:`BurnRateRule` — multi-window SLO burn rate (SRE style): over a
  fast and a slow window, ``burn = miss_rate / error_budget`` where
  ``error_budget = 1 - objective``.  The alert fires only when BOTH
  windows exceed the threshold: the fast window gives low detection
  latency, the slow window keeps a short blip from paging.
* :class:`QueueGrowthRule` — ``k`` consecutive strictly-increasing queue
  depth samples (sampled by the monitor from attached schedulers each
  tick — pull-based, nothing on the submit hot path).
* :class:`LatencyBandRule` — per-tick mean queue wait (from the histogram
  ``sum``/``count`` deltas) vs an EWMA mean ± ``k`` × EWMA absolute
  deviation band.
* :class:`RetraceStormRule` — windowed delta of the compiler's
  ``compile_retraces_total`` (a bucket re-tracing in steady state means
  an executable was silently rebuilt).
* :class:`BitExactSentinel` — any increase of ``ab_mismatch_total`` (the
  A/B shadow hook in ``serve.engine``) pages immediately: integer
  backends must agree bitwise.

Every firing is a typed :class:`Alert`, recorded three ways at once: an
``alert`` trace instant, a ``health_alerts_total{rule=...}`` counter, and
an entry in the monitor's alert log (``alert_log_jsonl()`` is byte-stable
across same-seed runs — sorted keys, injected-clock timestamps only).

Rules are *edge-triggered with hysteresis*: a rule fires once on the
rising edge and re-arms only after its condition has cleared, so a
sustained overload yields one page, not one per tick.

Closing the loop
----------------

``Autoscaler(health=...)`` and ``OverloadRouter(health=...)`` treat the
monitor as a signal source: :meth:`HealthMonitor.scale_hint` asks for a
scale-up, :meth:`HealthMonitor.overloaded` requests pre-emptive
degradation, and every actuation is recorded with ``reason="alert:..."``.
This is strictly opt-in — a passive monitor (``--alerts``) observes
without perturbing a single routing decision, so served logits stay
bit-identical with alerting on or off.

Stdlib only, like the rest of the obs core.  No wall clock is ever read:
the monitor lives entirely in the session's injected clock domain.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "Alert", "Rule", "BurnRateRule", "QueueGrowthRule", "LatencyBandRule",
    "RetraceStormRule", "BitExactSentinel", "default_rules",
    "HealthMonitor", "alert_log_path",
]


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Alert:
    """One rule firing: ``t`` is in the injected clock domain, ``context``
    a sorted tuple of (key, value) pairs so serialization is canonical."""

    rule: str
    severity: str                      # "page" | "warn"
    t: float
    message: str
    context: Tuple[Tuple[str, Any], ...] = ()

    def to_dict(self) -> dict:
        return dict(rule=self.rule, severity=self.severity, t=self.t,
                    message=self.message, context=dict(self.context))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


def alert_log_path(metrics_out: str) -> str:
    """Where the alert log lands when a CLI writes ``--metrics-out``: the
    same basename with ``.alerts.jsonl`` in place of the extension."""
    import os
    base, _ = os.path.splitext(metrics_out)
    return base + ".alerts.jsonl"


# ---------------------------------------------------------------------------
# registry readers
# ---------------------------------------------------------------------------


def _counter_sum(registry: MetricsRegistry, name: str, **match) -> float:
    """Sum of a counter's labelled series whose labels superset-match
    ``match`` (label-tuple matching, never string parsing)."""
    c = registry.get(name)
    if c is None:
        return 0.0
    want = {k: str(v) for k, v in match.items()}
    total = 0.0
    for key, value in c.labelled():
        labels = dict(key)
        if all(labels.get(k) == v for k, v in want.items()):
            total += value
    return total


def _histogram_sum_count(registry: MetricsRegistry,
                         name: str) -> Tuple[float, float]:
    """(sum, count) aggregated over every labelled series of a histogram."""
    h = registry.get(name)
    if h is None:
        return 0.0, 0.0
    total_sum = total_count = 0.0
    inf_idx = len(h.buckets)
    for _key, row in h.labelled():
        total_count += row[inf_idx]
        total_sum += row[-1]
    return total_sum, total_count


class _WindowedCounter:
    """Samples of a monotone cumulative value on the injected clock;
    ``delta(window, now)`` is the increase over the trailing window.

    Samples older than the horizon (the longest window any rule asks
    about) are pruned, so memory stays bounded no matter how long the
    process runs."""

    def __init__(self, horizon_s: float):
        self.horizon_s = float(horizon_s)
        self.samples: Deque[Tuple[float, float]] = collections.deque()

    def push(self, t: float, value: float) -> None:
        self.samples.append((float(t), float(value)))
        cutoff = t - self.horizon_s
        # keep one sample at/below the cutoff as the window's base value
        while len(self.samples) > 2 and self.samples[1][0] <= cutoff:
            self.samples.popleft()

    def delta(self, window_s: float, now: float) -> float:
        if not self.samples:
            return 0.0
        newest = self.samples[-1][1]
        cutoff = now - window_s
        base = self.samples[0][1]
        for t, v in self.samples:
            if t <= cutoff:
                base = v
            else:
                break
        return max(newest - base, 0.0)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


class Rule:
    """Base: edge-triggered with hysteresis.  Subclasses implement
    :meth:`check` returning ``(condition, context)``; the base fires an
    :class:`Alert` on the rising edge and re-arms when the condition
    clears."""

    name = "rule"
    severity = "warn"

    def __init__(self):
        self.active = False
        self.fired = 0

    def check(self, monitor: "HealthMonitor",
              now: float) -> Tuple[bool, Dict[str, Any]]:
        raise NotImplementedError

    def message(self, context: Dict[str, Any]) -> str:
        return self.name

    def evaluate(self, monitor: "HealthMonitor",
                 now: float) -> Optional[Alert]:
        condition, context = self.check(monitor, now)
        if condition and not self.active:
            self.active = True
            self.fired += 1
            return Alert(rule=self.name, severity=self.severity, t=now,
                         message=self.message(context),
                         context=tuple(sorted(context.items())))
        if not condition:
            self.active = False
        return None


class BurnRateRule(Rule):
    """Multi-window SLO burn rate over a ``...deadline_total{outcome}``
    counter, optionally restricted to one SLO class.

    ``burn(window) = (missed / (missed + met)) / (1 - objective)`` over the
    trailing window; fires when both the fast and the slow window burn at
    ``threshold`` or more and the fast window saw ``min_samples``
    outcomes (so an empty system never divides by nothing)."""

    severity = "page"

    def __init__(self, cls: Optional[str] = None,
                 counter: str = "slo_deadline_total",
                 objective: float = 0.95, threshold: float = 2.0,
                 fast_s: float = 1.0, slow_s: float = 30.0,
                 min_samples: int = 5):
        super().__init__()
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0,1), got {objective}")
        self.cls = cls
        self.counter = counter
        self.objective = float(objective)
        self.budget = 1.0 - float(objective)
        self.threshold = float(threshold)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.min_samples = int(min_samples)
        self.name = f"burn_rate:{cls}" if cls else "burn_rate"
        self._met = _WindowedCounter(self.slow_s)
        self._missed = _WindowedCounter(self.slow_s)

    def _burn(self, window_s: float, now: float) -> Tuple[float, float]:
        missed = self._missed.delta(window_s, now)
        total = missed + self._met.delta(window_s, now)
        if total <= 0:
            return 0.0, 0.0
        return (missed / total) / self.budget, total

    def check(self, monitor, now):
        match = dict(cls=self.cls) if self.cls else {}
        reg = monitor.registry
        self._met.push(now, _counter_sum(reg, self.counter,
                                         outcome="met", **match))
        self._missed.push(now, _counter_sum(reg, self.counter,
                                            outcome="missed", **match))
        fast_burn, fast_n = self._burn(self.fast_s, now)
        slow_burn, _ = self._burn(self.slow_s, now)
        condition = (fast_n >= self.min_samples
                     and fast_burn >= self.threshold
                     and slow_burn >= self.threshold)
        return condition, dict(cls=self.cls or "*",
                               fast_burn=round(fast_burn, 4),
                               slow_burn=round(slow_burn, 4),
                               fast_samples=fast_n,
                               threshold=self.threshold,
                               objective=self.objective)

    def message(self, c):
        return (f"SLO burn rate {c['fast_burn']}x budget over "
                f"{self.fast_s}s (and {c['slow_burn']}x over "
                f"{self.slow_s}s) for class {c['cls']}")


class QueueGrowthRule(Rule):
    """``k`` consecutive strictly-increasing total-queue-depth samples,
    the last at ``min_depth`` or more.  Depth is sampled by the monitor
    from attached schedulers each tick."""

    severity = "warn"
    name = "queue_growth"

    def __init__(self, k: int = 4, min_depth: int = 4):
        super().__init__()
        self.k = int(k)
        self.min_depth = int(min_depth)

    def check(self, monitor, now):
        depths = [d for _, d in monitor.queue_samples]
        recent = depths[-(self.k + 1):]
        growing = (len(recent) == self.k + 1
                   and all(b > a for a, b in zip(recent, recent[1:]))
                   and recent[-1] >= self.min_depth)
        return growing, dict(depth=recent[-1] if recent else 0,
                             k=self.k, samples=recent)

    def message(self, c):
        return (f"queue depth grew {self.k} consecutive ticks to "
                f"{c['depth']}")


class LatencyBandRule(Rule):
    """Per-tick mean latency vs an EWMA band.  The tick mean comes from
    the histogram's aggregate ``sum``/``count`` deltas; the band is
    ``ewma_mean + k * ewma_absdev``, both updated only on ticks that saw
    samples.  Needs ``warmup`` sampled ticks before it can fire."""

    severity = "warn"

    def __init__(self, metric: str = "sched_queue_wait_ms",
                 ewma: float = 0.2, k: float = 4.0, warmup: int = 8,
                 min_band_ms: float = 0.05):
        super().__init__()
        self.metric = metric
        self.ewma = float(ewma)
        self.k = float(k)
        self.warmup = int(warmup)
        self.min_band_ms = float(min_band_ms)
        self.name = f"latency_band:{metric}"
        self._last = (0.0, 0.0)        # (sum, count)
        self._mean: Optional[float] = None
        self._dev = 0.0
        self._ticks = 0

    def check(self, monitor, now):
        s, n = _histogram_sum_count(monitor.registry, self.metric)
        ds, dn = s - self._last[0], n - self._last[1]
        self._last = (s, n)
        if dn <= 0:
            return self.active, dict(mean_ms=None)    # hold current state
        tick_mean = ds / dn
        if self._mean is None:
            self._mean, self._ticks = tick_mean, 1
            return False, dict(mean_ms=round(tick_mean, 4))
        band = self._mean + self.k * max(self._dev, self.min_band_ms)
        self._ticks += 1
        breach = self._ticks > self.warmup and tick_mean > band
        if not breach:
            # only track the baseline while inside the band, so an excursion
            # does not drag the band up after it
            a = self.ewma
            self._dev = (1 - a) * self._dev + a * abs(tick_mean - self._mean)
            self._mean = (1 - a) * self._mean + a * tick_mean
        return breach, dict(mean_ms=round(tick_mean, 4),
                            band_ms=round(band, 4),
                            ewma_ms=round(self._mean, 4))

    def message(self, c):
        return (f"{self.metric} tick mean {c['mean_ms']}ms above band "
                f"{c['band_ms']}ms")


class RetraceStormRule(Rule):
    """``storm_n`` or more compiler retraces inside ``window_s`` — the
    AOT bucket discipline exists to keep this at zero in steady state."""

    severity = "page"
    name = "retrace_storm"

    def __init__(self, counter: str = "compile_retraces_total",
                 window_s: float = 1.0, storm_n: int = 3):
        super().__init__()
        self.counter = counter
        self.window_s = float(window_s)
        self.storm_n = int(storm_n)
        self._wc = _WindowedCounter(window_s)

    def check(self, monitor, now):
        self._wc.push(now, _counter_sum(monitor.registry, self.counter))
        delta = self._wc.delta(self.window_s, now)
        return delta >= self.storm_n, dict(retraces=delta,
                                           window_s=self.window_s)

    def message(self, c):
        return (f"{c['retraces']:.0f} compiler retraces in "
                f"{self.window_s}s")


class BitExactSentinel(Rule):
    """Any increase of ``ab_mismatch_total`` — an integer shadow backend
    disagreeing bitwise with the primary — pages immediately."""

    severity = "page"
    name = "bit_exact"

    def __init__(self, counter: str = "ab_mismatch_total"):
        super().__init__()
        self.counter = counter
        self._seen = 0.0

    def check(self, monitor, now):
        total = _counter_sum(monitor.registry, self.counter)
        fresh = total > self._seen
        context = dict(mismatches=total, new=total - self._seen)
        self._seen = total
        # rising-edge per increase: condition clears as soon as the count
        # stops moving, so every new mismatch re-fires
        return fresh, context

    def message(self, c):
        return (f"A/B shadow bitwise mismatch: {c['new']:.0f} new "
                f"({c['mismatches']:.0f} total)")


def default_rules(class_names: Optional[Sequence[str]] = None,
                  objective: float = 0.95,
                  fast_s: float = 1.0, slow_s: float = 30.0) -> List[Rule]:
    """The standard rule set: one burn-rate rule per SLO class (or one
    aggregate rule over the scheduler's ``sched_deadline_total`` when no
    classes are in play) plus the four anomaly detectors."""
    rules: List[Rule] = []
    if class_names:
        for cls in class_names:
            rules.append(BurnRateRule(cls=cls, objective=objective,
                                      fast_s=fast_s, slow_s=slow_s))
    else:
        rules.append(BurnRateRule(counter="sched_deadline_total",
                                  objective=objective,
                                  fast_s=fast_s, slow_s=slow_s))
    rules.append(QueueGrowthRule())
    rules.append(LatencyBandRule())
    rules.append(RetraceStormRule())
    rules.append(BitExactSentinel())
    return rules


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


class HealthMonitor:
    """Evaluates rules over the session's registry at a fixed cadence and
    keeps the alert log.  Attach it to the session (``ob.health = hm``)
    so ``Scheduler.drain`` can trigger a post-mortem bundle; runners call
    :meth:`tick` from their event loops at :attr:`interval_s`.

    The monitor never reads a wall clock — ``tick(now)`` timestamps come
    from the caller's (injected) clock domain, which is what makes the
    alert log byte-identical across same-seed simulations."""

    def __init__(self, ob, rules: Optional[List[Rule]] = None,
                 interval_s: float = 0.05, recorder=None,
                 bundle_dir: Optional[str] = None, max_bundles: int = 8):
        self.ob = ob
        self.rules = list(rules) if rules is not None else default_rules()
        self.interval_s = float(interval_s)
        self.recorder = recorder
        self.bundle_dir = bundle_dir
        self.max_bundles = int(max_bundles)
        self.alerts: List[Alert] = []
        self.bundles: List[str] = []
        self.ticks = 0
        self.queue_samples: Deque[Tuple[float, float]] = \
            collections.deque(maxlen=64)
        self.servers: Dict[str, Any] = {}       # name -> Scheduler
        self.census_extra: Dict[str, Any] = {}
        self._bundle_seq = 0

    @property
    def registry(self) -> MetricsRegistry:
        return self.ob.metrics

    # -- wiring -------------------------------------------------------------

    def attach_server(self, name: str, sched) -> None:
        """Register a scheduler whose queue depth the monitor samples each
        tick (pull-based: zero cost on the submit path)."""
        self.servers[name] = sched

    # -- evaluation ---------------------------------------------------------

    def tick(self, now: float) -> List[Alert]:
        """Sample, evaluate every rule, record new alerts.  Returns the
        alerts that fired on this tick (usually empty)."""
        self.ticks += 1
        depth = float(sum(s.pending for s in self.servers.values()))
        self.queue_samples.append((now, depth))
        if self.recorder is not None:
            self.recorder.record_metrics(now, self.registry)
        fired: List[Alert] = []
        for rule in self.rules:
            alert = rule.evaluate(self, now)
            if alert is not None:
                fired.append(alert)
                self._record(alert)
        if fired and self.bundle_dir:
            self.dump_bundle("alert:" + fired[0].rule, now)
        return fired

    def _record(self, alert: Alert) -> None:
        self.alerts.append(alert)
        ob = self.ob
        ob.metrics.counter(
            "health_alerts_total", "alerts fired by rule").inc(
                rule=alert.rule, severity=alert.severity)
        ob.trace.instant("alert", cat="health", track="health", t=alert.t,
                         rule=alert.rule, severity=alert.severity,
                         message=alert.message)

    # -- control-loop signals ----------------------------------------------

    def _active_overload_rules(self) -> List[str]:
        kinds = (BurnRateRule, QueueGrowthRule, LatencyBandRule)
        return [r.name for r in self.rules
                if r.active and isinstance(r, kinds)]

    def overloaded(self) -> Optional[str]:
        """Name of an active overload-class rule, or None — the router's
        pre-emptive degradation signal."""
        names = self._active_overload_rules()
        return names[0] if names else None

    def scale_hint(self) -> Optional[str]:
        """Rule name if an active alert argues for more replicas."""
        return self.overloaded()

    # -- post-mortems -------------------------------------------------------

    def on_drain(self, missed: int, dispatches: int = 0) -> None:
        """Scheduler drain finished with missed deadlines: dump a bundle
        (when a bundle dir is configured)."""
        if missed and self.bundle_dir:
            self.dump_bundle("drain_missed_deadlines", self.ob.now())

    def dump_bundle(self, reason: str, now: float) -> Optional[str]:
        if not self.bundle_dir or len(self.bundles) >= self.max_bundles:
            return None
        from repro_torch.obs.bundle import write_bundle
        path = write_bundle(self.bundle_dir, self.ob, reason=reason,
                            now=now, seq=self._bundle_seq,
                            recorder=self.recorder, alerts=self.alerts,
                            census=self.census())
        self._bundle_seq += 1
        self.bundles.append(path)
        return path

    def census(self) -> dict:
        """Active-config snapshot for the bundle manifest: per-server
        scheduler state plus whatever the runner registered."""
        servers = {}
        for name in sorted(self.servers):
            s = self.servers[name]
            servers[name] = dict(
                pending=s.pending, in_flight=s.in_flight,
                active_replicas=getattr(s, "active", len(s.replicas)),
                replicas=len(s.replicas))
        return dict(servers=servers, **self.census_extra)

    # -- the alert log ------------------------------------------------------

    def alert_log_jsonl(self) -> str:
        """One canonical JSON object per alert, firing order — the
        byte-stable artifact the determinism tests compare."""
        return "".join(a.to_json() + "\n" for a in self.alerts)

    def write_alert_log(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.alert_log_jsonl())

    def summary(self) -> dict:
        by_rule: Dict[str, int] = {}
        for a in self.alerts:
            by_rule[a.rule] = by_rule.get(a.rule, 0) + 1
        return dict(ticks=self.ticks, alerts=len(self.alerts),
                    by_rule={k: by_rule[k] for k in sorted(by_rule)},
                    bundles=list(self.bundles))
