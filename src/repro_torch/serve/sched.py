"""Deadline-based batch coalescing + replica scheduling for ResNet serving.

The port's copy of ``repro.serve.sched``.  The paper's throughput numbers
(Table 3: 12971/3254 FPS ResNet8/20 on the Ultra96) come from keeping
every compute unit saturated under streaming traffic.  The software
analogue splits into two orthogonal mechanisms, both here:

* **Batch coalescing** (:class:`BatchCoalescer`): a micro-batch is held open
  until either a bucket fills or the *oldest* request's deadline slack is
  exhausted — the classic latency/throughput dial.  Requests carry an
  ``arrival`` timestamp and an optional absolute ``deadline``; the coalescer
  dispatches a batch no later than ``deadline - service_estimate`` so the
  compute itself still fits before the deadline (when capacity suffices).

* **Replica scheduling** (:class:`Scheduler` + :class:`ReplicaPool`): the
  compiled model is instantiated once per device (the analogue of the
  paper's replicated accelerator pipelines); each dispatch goes to the
  least-loaded replica, with per-replica in-flight accounting.  Results are
  bitwise the single-device path's — replication never changes the
  arithmetic, only where it runs.  The pool's devices are CUDA devices
  (``torch.cuda``); a list naming one device twice gives two replicas on
  it (on the CPU, the counterpart of the reference's forced host devices;
  on one card it is legal but never overlaps).

Everything in this module is driven by an injectable :class:`Clock`, so the
scheduling policy is testable under a :class:`FakeClock` simulation with no
real model, no real time, and no flakiness (tests/test_torch_sched.py).
The engine (``serve.engine.ShardedResNetEngine``) wires a real clock, a
real :class:`ReplicaPool`, and the dispatch loop around this core.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.obs import runtime as _obs


# ---------------------------------------------------------------------------
# Clocks — injectable time source so scheduling is simulable
# ---------------------------------------------------------------------------


class MonotonicClock:
    """Wall clock: ``time.monotonic`` + real ``time.sleep``."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class FakeClock:
    """Deterministic simulation clock: ``sleep`` advances time instantly."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0
        self._t += dt

    def sleep(self, dt: float) -> None:
        self.advance(max(dt, 0.0))


# ---------------------------------------------------------------------------
# Requests and dispatches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScheduledRequest:
    """One admitted request moving through arrive → coalesce → dispatch →
    complete.  ``payload`` is opaque to the scheduler (the engine stores its
    ``ImageRequest`` there)."""

    payload: Any
    seq: int                          # admission order (FIFO tiebreak)
    arrival: float                    # clock.now() at submit
    deadline: Optional[float] = None  # absolute; None = best-effort
    priority: int = 0                 # lower value = more urgent class
    dispatch_t: Optional[float] = None
    complete_t: Optional[float] = None
    replica: Optional[int] = None

    @property
    def queue_wait(self) -> Optional[float]:
        if self.dispatch_t is None:
            return None
        return self.dispatch_t - self.arrival

    @property
    def compute_time(self) -> Optional[float]:
        if self.complete_t is None or self.dispatch_t is None:
            return None
        return self.complete_t - self.dispatch_t

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.deadline is None:
            return None
        if self.complete_t is None:
            return False
        return self.complete_t <= self.deadline


@dataclasses.dataclass
class Dispatch:
    """One micro-batch bound to one replica."""

    requests: List[ScheduledRequest]
    replica: "ReplicaState"
    dispatch_t: float

    def __len__(self) -> int:
        return len(self.requests)


class DrainResult(int):
    """``Scheduler.drain``'s return value: still the flushed-dispatch count
    (an ``int``, so every existing ``n == k`` consumer is untouched), plus
    ``missed_deadline`` — how many of the drained *requests* had already
    blown their deadline by the time the drain dispatched them.  Overload
    experiments use the split to distinguish "served late" from "served in
    time" in the tail that shutdown flushes."""

    def __new__(cls, dispatches: int, missed_deadline: int = 0):
        obj = super().__new__(cls, dispatches)
        obj.missed_deadline = int(missed_deadline)
        return obj


class Backpressure(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_pending`` —
    the caller must retry later (``submit_async`` awaits instead)."""


class SchedulerClosed(RuntimeError):
    """Raised by ``submit`` after ``shutdown()``: draining, not admitting."""


# ---------------------------------------------------------------------------
# Batch coalescer
# ---------------------------------------------------------------------------


class BatchCoalescer:
    """Hold a micro-batch open until a bucket fills or slack runs out.

    A request must be *dispatched* by

        ``deadline - service_estimate``    (it has a deadline), or
        ``arrival + slack``                (best-effort coalescing window)

    ``due(now)`` is True as soon as the batch is full or any pending request
    has reached its dispatch-by time; ``take()`` then pops up to
    ``max_batch`` requests, FIFO within each priority class (lower priority
    value first — stable, so same-class requests keep admission order).
    """

    def __init__(self, max_batch: int, slack_s: float = 0.005):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive: {max_batch}")
        self.max_batch = int(max_batch)
        self.slack_s = float(slack_s)
        self.pending: List[ScheduledRequest] = []

    def __len__(self) -> int:
        return len(self.pending)

    def add(self, sreq: ScheduledRequest) -> None:
        self.pending.append(sreq)

    def dispatch_by(self, sreq: ScheduledRequest,
                    service_estimate_s: float = 0.0) -> float:
        if sreq.deadline is not None:
            if service_estimate_s <= 0.0:
                # cold start: with no service-time observation yet, a
                # deadline cannot be budgeted against — dispatch at once
                # rather than holding until the deadline and guaranteeing
                # a miss (the first completion seeds the EWMA)
                return sreq.arrival
            return sreq.deadline - service_estimate_s
        return sreq.arrival + self.slack_s

    def due(self, now: float, service_estimate_s: float = 0.0) -> bool:
        if len(self.pending) >= self.max_batch:
            return True
        return any(self.dispatch_by(r, service_estimate_s) <= now
                   for r in self.pending)

    def next_due_at(self, service_estimate_s: float = 0.0) -> Optional[float]:
        """Earliest dispatch-by time over pending requests (None if empty) —
        how long a driver may sleep before anything can become due."""
        if not self.pending:
            return None
        return min(self.dispatch_by(r, service_estimate_s)
                   for r in self.pending)

    def take(self) -> List[ScheduledRequest]:
        """Pop up to ``max_batch`` requests: most urgent priority class
        first, FIFO (admission order) inside each class."""
        batch = sorted(self.pending,
                       key=lambda r: (r.priority, r.seq))[:self.max_batch]
        taken = {id(r) for r in batch}
        self.pending = [r for r in self.pending if id(r) not in taken]
        return batch


# ---------------------------------------------------------------------------
# Replica state + least-loaded selection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplicaState:
    """Bookkeeping for one model replica (one device)."""

    index: int
    device: Any = None                # torch.device for real pools; None in sims
    in_flight: int = 0                # requests dispatched, not yet complete
    dispatched: int = 0               # lifetime request count
    served: int = 0                   # lifetime completed count
    failed: int = 0                   # lifetime failed-dispatch count

    @property
    def load(self) -> int:
        return self.in_flight


def least_loaded(replicas: Sequence[ReplicaState]) -> ReplicaState:
    """Fewest in-flight requests; ties broken by fewest lifetime dispatches,
    then lowest index (deterministic)."""
    return min(replicas, key=lambda r: (r.in_flight, r.dispatched, r.index))


# ---------------------------------------------------------------------------
# Latency accounting
# ---------------------------------------------------------------------------


class LatencyStats:
    """Per-request queue-wait and compute samples with percentile summary.

    Samples are also bucketed by the request's ``priority`` class so SLO
    layers (``repro.traffic.slo``) can report per-class percentiles and
    deadline accounting; the flat top-level summary keys are unchanged —
    existing consumers never see a different shape, only the additional
    ``by_priority`` breakdown."""

    def __init__(self):
        self.queue_wait_s: List[float] = []
        self.compute_s: List[float] = []
        self.deadline_misses = 0
        self.deadline_total = 0
        self.failed = 0                   # requests whose dispatch errored
        self._by_priority: dict = {}      # priority -> per-class sample store

    def _class(self, priority: int) -> dict:
        return self._by_priority.setdefault(
            priority, dict(queue_wait_s=[], compute_s=[],
                           deadline_misses=0, deadline_total=0))

    def record(self, sreq: ScheduledRequest) -> None:
        self.queue_wait_s.append(sreq.queue_wait)
        self.compute_s.append(sreq.compute_time)
        cls = self._class(sreq.priority)
        cls["queue_wait_s"].append(sreq.queue_wait)
        cls["compute_s"].append(sreq.compute_time)
        if sreq.deadline is not None:
            self.deadline_total += 1
            cls["deadline_total"] += 1
            if not sreq.deadline_met:
                self.deadline_misses += 1
                cls["deadline_misses"] += 1

    @staticmethod
    def _pct(xs: List[float]) -> dict:
        if not xs:
            return dict(p50=0.0, p99=0.0, max=0.0)
        a = np.asarray(xs, np.float64) * 1e3          # -> milliseconds
        return dict(p50=float(np.percentile(a, 50)),
                    p99=float(np.percentile(a, 99)),
                    max=float(a.max()))

    def priority_summary(self) -> dict:
        """Per-priority-class breakdown: same keys as the flat summary,
        keyed by the priority value (lower = more urgent)."""
        return {p: dict(count=len(c["queue_wait_s"]),
                        queue_wait_ms=self._pct(c["queue_wait_s"]),
                        compute_ms=self._pct(c["compute_s"]),
                        deadline_misses=c["deadline_misses"],
                        deadline_total=c["deadline_total"])
                for p, c in sorted(self._by_priority.items())}

    def summary(self) -> dict:
        return dict(count=len(self.queue_wait_s),
                    queue_wait_ms=self._pct(self.queue_wait_s),
                    compute_ms=self._pct(self.compute_s),
                    deadline_misses=self.deadline_misses,
                    deadline_total=self.deadline_total,
                    failed=self.failed,
                    by_priority=self.priority_summary())


# ---------------------------------------------------------------------------
# The scheduler: coalescer + replicas + clock
# ---------------------------------------------------------------------------


class Scheduler:
    """Deadline-aware dispatch over a set of replicas.

    Execution-agnostic: ``poll`` hands out a :class:`Dispatch` (requests +
    chosen replica) and the caller runs it however it likes — the engine on
    real compiled executables, the tests against a fake service time — then
    reports back via ``complete``.  The service-time estimate used for
    deadline headroom is an EWMA over observed per-batch compute times,
    seeded by ``service_estimate_s``.
    """

    def __init__(self, replicas, max_batch: int, slack_s: float = 0.005,
                 clock=None, max_pending: Optional[int] = None,
                 service_estimate_s: float = 0.0, ewma: float = 0.25):
        if isinstance(replicas, int):
            replicas = [ReplicaState(i) for i in range(replicas)]
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas: List[ReplicaState] = list(replicas)
        self.coalescer = BatchCoalescer(max_batch, slack_s=slack_s)
        self.clock = clock if clock is not None else MonotonicClock()
        self.max_pending = max_pending
        self.service_estimate_s = float(service_estimate_s)
        self.ewma = float(ewma)
        self.closed = False
        self.stats = LatencyStats()
        self._seq = 0
        self._in_flight_reqs = 0
        # dispatches go to the least-loaded replica among the first
        # ``active`` — the autoscaling hook (repro.traffic.autoscale):
        # shrinking never cancels in-flight work on a deactivated replica,
        # it only stops routing new batches there
        self.active = len(self.replicas)
        self.drained_missed_deadline = 0
        # autoscaler actuation record, surfaced by summary() so scale
        # activity is reachable from every CLI/benchmark JSON
        self.scale_events = 0
        self.last_scale_reason: Optional[str] = None

    # -- admission ----------------------------------------------------------

    def submit(self, payload, deadline: Optional[float] = None,
               deadline_in: Optional[float] = None,
               priority: int = 0) -> ScheduledRequest:
        """Admit one request.  ``deadline`` is absolute (clock domain);
        ``deadline_in`` is relative to now.  Raises :class:`Backpressure`
        when the pending queue is full and :class:`SchedulerClosed` after
        ``shutdown()``."""
        if self.closed:
            raise SchedulerClosed("scheduler is shut down; draining only")
        if self.max_pending is not None and \
                len(self.coalescer) >= self.max_pending:
            ob = _obs.active()
            if ob is not None:
                ob.metrics.counter(
                    "sched_backpressure_total",
                    "submits rejected at max_pending").inc()
            raise Backpressure(
                f"pending queue at max_pending={self.max_pending}")
        now = self.clock.now()
        if deadline_in is not None:
            if deadline is not None:
                raise ValueError("pass deadline or deadline_in, not both")
            deadline = now + deadline_in
        sreq = ScheduledRequest(payload=payload, seq=self._seq, arrival=now,
                                deadline=deadline, priority=priority)
        self._seq += 1
        self.coalescer.add(sreq)
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "sched_submitted_total", "requests admitted").inc(
                    priority=str(priority))
        return sreq

    # -- dispatch -----------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self.coalescer)

    @property
    def in_flight(self) -> int:
        return self._in_flight_reqs

    @property
    def outstanding(self) -> int:
        """Requests admitted but not yet completed."""
        return self.pending + self._in_flight_reqs

    def poll(self, now: Optional[float] = None) -> Optional[Dispatch]:
        """Return the next due micro-batch bound to the least-loaded replica,
        or None when nothing is due yet.  After ``shutdown()`` every pending
        request is due immediately (graceful drain)."""
        if not self.coalescer.pending:
            return None
        if now is None:
            now = self.clock.now()
        if not self.closed and \
                not self.coalescer.due(now, self.service_estimate_s):
            return None
        batch = self.coalescer.take()
        rep = least_loaded(self.replicas[:self.active])
        for r in batch:
            r.dispatch_t = now
            r.replica = rep.index
        rep.in_flight += len(batch)
        rep.dispatched += len(batch)
        self._in_flight_reqs += len(batch)
        ob = _obs.active()
        if ob is not None:
            first = min(r.arrival for r in batch)
            ob.trace.span("coalesce_hold", cat="sched", track="coalesce",
                          t0=first, t1=now, batch=len(batch),
                          replica=rep.index)
            ob.metrics.counter(
                "sched_dispatches_total", "micro-batches dispatched").inc(
                    replica=str(rep.index))
            ob.metrics.histogram(
                "sched_coalesce_hold_ms",
                "oldest-request hold time per dispatched batch").observe(
                    (now - first) * 1e3)
        return Dispatch(requests=batch, replica=rep, dispatch_t=now)

    def next_due_at(self) -> Optional[float]:
        return self.coalescer.next_due_at(self.service_estimate_s)

    def set_active(self, n: int, reason: Optional[str] = None) -> int:
        """Restrict dispatch to the first ``n`` replicas (clamped to
        ``[1, len(replicas)]``); returns the applied value.  The autoscaler's
        actuation point — replicas beyond ``active`` keep their executables
        warm and finish what they hold, they just stop receiving work.

        An actual change counts as a scale event (``scale_events`` /
        ``last_scale_reason``, surfaced by :meth:`summary`); ``reason`` is
        the caller's policy trigger (the autoscaler passes its
        ``ScaleDecision.reason``)."""
        applied = max(1, min(int(n), len(self.replicas)))
        if applied != self.active:
            prev, self.active = self.active, applied
            self.scale_events += 1
            if reason is not None:
                self.last_scale_reason = reason
            ob = _obs.active()
            if ob is not None:
                ob.trace.instant("scale", cat="control", track="control",
                                 from_replicas=prev, to_replicas=applied,
                                 reason=reason)
                ob.metrics.counter(
                    "sched_scale_events_total",
                    "applied active-replica changes").inc(
                        reason=str(reason))
                ob.metrics.gauge(
                    "sched_active_replicas",
                    "replicas currently receiving work").set(applied)
        return self.active

    def complete(self, dispatch: Dispatch, now: Optional[float] = None,
                 failed: bool = False) -> None:
        """Report a dispatch finished: releases the replica's in-flight
        slots and, on success, stamps completion times, records latency and
        updates the service-time EWMA.  ``failed=True`` (the dispatch
        errored) only releases the accounting — failed requests must never
        appear as served, met deadlines, or service-time observations."""
        if now is None:
            now = self.clock.now()
        rep = dispatch.replica
        rep.in_flight -= len(dispatch)
        self._in_flight_reqs -= len(dispatch)
        ob = _obs.active()
        if failed:
            rep.failed += len(dispatch)
            self.stats.failed += len(dispatch)
            if ob is not None:
                ob.metrics.counter(
                    "sched_failed_total",
                    "requests whose dispatch errored").inc(
                        len(dispatch), replica=str(rep.index))
            return
        for r in dispatch.requests:
            r.complete_t = now
            self.stats.record(r)
        rep.served += len(dispatch)
        if ob is not None:
            ob.trace.span("batch", cat="sched", track=f"replica{rep.index}",
                          t0=dispatch.dispatch_t, t1=now, n=len(dispatch))
            for r in dispatch.requests:
                ob.trace.span("queue_wait", cat="sched", track="requests",
                              t0=r.arrival, t1=r.dispatch_t, seq=r.seq,
                              priority=r.priority, replica=rep.index)
                ob.trace.span("compute", cat="sched", track="requests",
                              t0=r.dispatch_t, t1=now, seq=r.seq,
                              priority=r.priority, replica=rep.index,
                              **({} if r.deadline is None
                                 else dict(deadline_met=bool(r.deadline_met))))
                ob.metrics.histogram(
                    "sched_queue_wait_ms",
                    "admit-to-dispatch wait per request").observe(
                        r.queue_wait * 1e3, priority=str(r.priority))
                ob.metrics.histogram(
                    "sched_compute_ms",
                    "dispatch-to-complete time per request").observe(
                        r.compute_time * 1e3, priority=str(r.priority))
                if r.deadline is not None:
                    ob.metrics.counter(
                        "sched_deadline_total",
                        "deadline-carrying completions by outcome").inc(
                            outcome="met" if r.deadline_met else "missed",
                            priority=str(r.priority))
            ob.metrics.counter(
                "sched_served_total", "requests completed").inc(
                    len(dispatch), replica=str(rep.index))
        observed = now - dispatch.dispatch_t
        if self.service_estimate_s <= 0.0:
            self.service_estimate_s = observed
        else:
            self.service_estimate_s += self.ewma * \
                (observed - self.service_estimate_s)

    # -- shutdown -----------------------------------------------------------

    def shutdown(self) -> None:
        """Stop admitting; everything already pending becomes due and drains
        through the normal poll/complete cycle."""
        self.closed = True

    def drain(self, execute: Callable[[Dispatch], None]) -> DrainResult:
        """Graceful shutdown helper: close admission, then run every
        remaining dispatch through ``execute`` (which must call
        ``complete``).  Returns a :class:`DrainResult` — the number of
        dispatches flushed (an ``int``, back-compatible) carrying
        ``missed_deadline``: how many drained requests had already missed
        their deadline at dispatch time (served late vs served in time)."""
        self.shutdown()
        n = 0
        missed = 0
        while True:
            d = self.poll()
            if d is None:
                break
            missed += sum(1 for r in d.requests
                          if r.deadline is not None
                          and r.deadline < d.dispatch_t)
            execute(d)
            n += 1
        self.drained_missed_deadline += missed
        ob = _obs.active()
        if ob is not None:
            ob.trace.instant("drain", cat="sched", track="control",
                             dispatches=n, missed_deadline=missed)
            ob.metrics.counter(
                "sched_drained_dispatches_total",
                "dispatches flushed by drain()").inc(n)
            if missed and ob.health is not None:
                # drain finished late: freeze a post-mortem debug bundle
                ob.health.on_drain(missed, dispatches=n)
        return DrainResult(n, missed)

    def summary(self) -> dict:
        return dict(replicas=[dict(index=r.index, served=r.served,
                                   dispatched=r.dispatched,
                                   in_flight=r.in_flight, failed=r.failed)
                              for r in self.replicas],
                    active_replicas=self.active,
                    service_estimate_ms=self.service_estimate_s * 1e3,
                    drained_missed_deadline=self.drained_missed_deadline,
                    scale_events=self.scale_events,
                    last_scale_reason=self.last_scale_reason,
                    **self.stats.summary())


# ---------------------------------------------------------------------------
# Replica pool — one compiled executable set per device
# ---------------------------------------------------------------------------


class ReplicaPool:
    """A :class:`~repro_torch.compile.CompiledModel` instantiated once per
    device.

    The model is *lowered* once; each replica then gets its own weights,
    lowering and per-bucket CUDA graphs on its device via
    ``CompiledModel.device_executable`` — the software analogue of stamping
    N copies of the accelerator pipeline onto the fabric, each with its own
    weight copy in BRAM.  ``run`` pins a batch to one replica's device
    (``CompiledModel.run_placed``) and is bitwise the single-device path
    (replication does not touch the arithmetic).

    ``devices=None`` takes every CUDA device, ``cuda:0 .. cuda:{n-1}``, and
    raises when there is none: the pool never falls back to the CPU.  Pass
    ``devices=["cpu", ...]`` to run the plain versions there.
    """

    def __init__(self, model, devices: Optional[Sequence] = None,
                 replicas: Optional[int] = None):
        self.model = model
        self.devices = pool_devices(devices, replicas)
        self.replicas = [ReplicaState(i, device=d)
                         for i, d in enumerate(self.devices)]

    def __len__(self) -> int:
        return len(self.replicas)

    def run(self, index: int, images):
        """Run one batch on replica ``index``'s device.  Returns the logits
        on that device; on a GPU the replay is enqueued, not waited for."""
        return self.model.run_placed(images, self.devices[index])

    def warmup(self) -> "ReplicaPool":
        """Build every (device, bucket) executable, the largest bucket first,
        so serving never pays a capture on the hot path."""
        for d in self.devices:
            for b in reversed(self.model.batch_sizes):
                self.model.device_executable(b, d)
        return self


def pool_devices(devices: Optional[Sequence] = None,
                 replicas: Optional[int] = None) -> List:
    """The devices of a replica pool: ``devices`` resolved (a bare ``cuda``
    is the current card; a CUDA device raises without a GPU), or every
    CUDA device; the first ``replicas`` of them.  Raises when there is no
    device or fewer than ``replicas``."""
    import torch

    from repro_torch.compile.compiler import resolve_device

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; a replica pool runs on the "
                "GPU unless the caller passes devices=['cpu', ...]")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if replicas is not None:
        if len(devices) < replicas:
            raise ValueError(
                f"asked for {replicas} replicas but only {len(devices)} "
                f"devices are available: {[str(d) for d in devices]}")
        devices = devices[:replicas]
    if not devices:
        raise ValueError("need at least one device")
    return devices
