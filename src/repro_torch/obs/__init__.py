"""``repro_torch.obs`` — zero-dependency observability for the port.

The port's copy of ``repro.obs``, one switch over these pieces:

* :mod:`repro_torch.obs.metrics` — labelled counters/gauges/histograms with
  deterministic snapshot + Prometheus text exposition (stdlib only).
* :mod:`repro_torch.obs.trace`  — span tracing on the injected clock
  domain, exported as Chrome ``trace_event`` JSON (Perfetto) or JSONL.
* :mod:`repro_torch.obs.profile` — per-task kernel device time paired with
  the modeled HBM/VMEM bytes of ``core.dataflow`` (imports torch and the
  compile stack, so it loads on first use).
* :mod:`repro_torch.obs.health` — deterministic SLO burn-rate/anomaly
  alert rules evaluated over the live registry, plus the control-loop
  signals the autoscaler/router can subscribe to.
* :mod:`repro_torch.obs.recorder` / :mod:`repro_torch.obs.bundle` —
  flight-recorder rings of recent spans + metric deltas, frozen into
  self-contained debug bundles on alert, drain-with-missed-deadlines, or
  demand (the offline ``dump`` of ``python -m repro_torch.obs``).

``python -m repro_torch.obs`` prints a report of exported artifacts.

Nothing records unless :func:`instrument` has installed a session — every
call site in ``compile``, ``serve`` and ``traffic`` checks
``obs.active()`` first, so the disabled cost is one global read.

Not ported yet: the LM leg of ``profile``, ROADMAP item A8.3.
"""
from repro_torch.obs.metrics import (                  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, DEFAULT_BUCKETS)
from repro_torch.obs.trace import (                    # noqa: F401
    Trace, TraceEvent, VOLATILE_ARGS, VOLATILE_CATS, strip_volatile_events)
from repro_torch.obs.runtime import (                  # noqa: F401
    Observability, active, install, instrument, disable, instrumented,
    export)
from repro_torch.obs.health import (                   # noqa: F401
    Alert, Rule, BurnRateRule, QueueGrowthRule, LatencyBandRule,
    RetraceStormRule, BitExactSentinel, default_rules, HealthMonitor,
    alert_log_path)
from repro_torch.obs.recorder import FlightRecorder    # noqa: F401
from repro_torch.obs.bundle import (                   # noqa: F401
    write_bundle, read_bundle, assemble_bundle)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "Trace", "TraceEvent", "VOLATILE_ARGS", "VOLATILE_CATS",
    "strip_volatile_events",
    "Observability", "active", "install", "instrument", "disable",
    "instrumented", "export",
    "Alert", "Rule", "BurnRateRule", "QueueGrowthRule", "LatencyBandRule",
    "RetraceStormRule", "BitExactSentinel", "default_rules",
    "HealthMonitor", "alert_log_path",
    "FlightRecorder", "write_bundle", "read_bundle", "assemble_bundle",
    # lazy (imports torch): profile_tasks, TaskProfile, REFERENCE_HBM_GBPS
]


def __getattr__(name):
    # keep `import repro_torch.obs` torch-free: the profiler loads on use
    if name in ("profile_tasks", "TaskProfile", "REFERENCE_HBM_GBPS"):
        from repro_torch.obs import profile as _p
        return getattr(_p, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
