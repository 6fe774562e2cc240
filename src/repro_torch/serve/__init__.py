"""``repro_torch.serve`` — serving engines and the scheduling layer.

* ``engine``: :class:`~repro_torch.serve.engine.Engine` (continuous
  batching of the float LMs), :class:`~repro_torch.serve.engine.
  ResNetEngine` (one device,
  compiled image and LM serving), :class:`~repro_torch.serve.engine.
  ShardedResNetEngine` (replica pool + deadline-based batch coalescing).
* ``sched``: the execution-agnostic scheduling core — injectable clocks,
  :class:`~repro_torch.serve.sched.BatchCoalescer`,
  :class:`~repro_torch.serve.sched.Scheduler`,
  :class:`~repro_torch.serve.sched.ReplicaPool`.
"""
from repro_torch.serve.engine import (                   # noqa: F401
    Engine, ImageRequest, Request, ResNetEngine, ShardedResNetEngine)
from repro_torch.serve.sched import (                    # noqa: F401
    Backpressure, BatchCoalescer, Dispatch, DrainResult, FakeClock,
    LatencyStats, MonotonicClock, ReplicaPool, ReplicaState,
    ScheduledRequest, Scheduler, SchedulerClosed, least_loaded)
