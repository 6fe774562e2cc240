"""repro_torch.traffic — trace-driven load, SLO classes, autoscaling,
degradation.

The port's copy of ``repro.traffic``: the control plane over the serving
data plane, where the paper's steady-state FPS numbers meet realistic
traffic.

    loadgen    seeded arrival processes (Poisson / bursty on-off / diurnal /
               JSON trace replay), requests tagged with an SLO class
    slo        class definitions (deadline_ms, priority, strict|degrade|drop
               policy) + per-class accounting over serve.sched.LatencyStats
    autoscale  grow/shrink the active replica set from queue depth and EWMA
               utilization (hysteresis + cooldown, FakeClock-testable)
    degrade    overload router: re-route degradable classes to a cheaper
               compiled variant (ResNet8 for ResNet20), shed droppable ones,
               and account the accuracy cost via repro_torch.quantize
    sim        deterministic virtual-time end-to-end simulation (FakeClock +
               ServiceModel; real CompiledModel arithmetic, bitwise)
    live       the same control plane on real clocks over ShardedResNetEngine

CLI: ``python -m repro_torch.traffic`` (see ``--help``); also wired
through ``python -m repro_torch.launch.serve --trace/--slo-classes/
--autoscale``.
"""
from repro_torch.traffic.loadgen import (         # noqa: F401
    Arrival, ArrivalProcess, DiurnalProcess, OnOffProcess, PoissonProcess,
    TraceReplay, load_trace, make_process, save_trace)
from repro_torch.traffic.slo import (             # noqa: F401
    DEFAULT_CLASSES, ClassStats, SLOAccounting, SLOClass, classes_by_name,
    parse_classes)
from repro_torch.traffic.autoscale import (       # noqa: F401
    AutoscaleConfig, Autoscaler, ScaleDecision)
from repro_torch.traffic.degrade import (         # noqa: F401
    DROP, OverloadRouter, RouteDecision, ServerSignals, effective_accuracy,
    variant_accuracies)
from repro_torch.traffic.sim import (             # noqa: F401
    PAPER_FPS, ServiceModel, SimRequest, SimServer, TrafficSim)
from repro_torch.traffic.live import LiveTrafficRunner  # noqa: F401
