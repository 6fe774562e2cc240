"""Image-classification serving over the integer ResNet pipeline.

``ResNetEngine`` serves the paper's workload — integer ResNet8/20 image
classification — through :class:`repro_torch.compile.CompiledModel`: the
optimized graph is lowered once, weights live on the engine's device, and a
tick only selects a bucket, zero-pads and runs.  The default backend is
``cuda``, the hand-written per-block kernel pipeline; ``cuda-stream`` runs
each ResNet forward as one streamed ``block_chain`` launch.  The same
engine serves the int8 LMs (``compile.lm_params.lm_config``): a request
then carries a ``(seq_len,)`` token vector and gets back the ``(vocab,)``
logits of its last position.

``ShardedResNetEngine`` serves at scale: the model instantiated once per
device (``serve.sched.ReplicaPool``), fed by the deadline-based batch
coalescer (``serve.sched.Scheduler``).
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.obs import runtime as _obs
from repro_torch.serve import sched as S

# backends whose logits come from the same integer datapath: on a conv
# config a shadow on one of them must agree with a primary on another
# bitwise.  An LM's attention and scan are float, so there these backends
# agree only within the per-task tolerances (tests/test_torch_lm.py,
# chip_smoke.py): its deviation is recorded, never counted as a mismatch.
_INT_BACKENDS = frozenset({"cuda", "cuda-stream", "torch-int"})


@dataclasses.dataclass
class ImageRequest:
    rid: int
    image: np.ndarray                     # (H, W, 3) float image, or an LM
                                          # (seq_len,) int token vector
    logits: Optional[np.ndarray] = None   # (num_classes | vocab,) once served
    label: Optional[int] = None
    done: bool = False


def _input_contract(cfg):
    """Per-request payload (shape, numpy dtype) of one config: the model's
    input batch minus the batch dim — float images for conv configs, int32
    token vectors for LM configs."""
    if hasattr(cfg, "seq_len"):
        return (cfg.seq_len,), np.int32
    return (cfg.img, cfg.img, 3), np.float32


def _validate_image(cfg, req: ImageRequest) -> None:
    """Every bucket has a fixed shape, so a mismatched payload can never be
    batched; rejecting at submit keeps the tick loop total."""
    expect, _ = _input_contract(cfg)
    shape = tuple(np.shape(req.image))
    if shape != expect:
        raise ValueError(
            f"request {req.rid}: payload shape {shape} does not match the "
            f"compiled input shape {expect} for {cfg.name}")


class ResNetEngine:
    """Image-classification engine serving through ``CompiledModel``.

    Backends come from the ``repro_torch.compile`` registry: ``cuda``
    (default; ``conv_stem`` + one ``resblock_fused`` launch per block),
    ``cuda-stream`` (the blocks as chains, one ``block_chain`` launch each,
    the stem fused) and ``torch-int`` (the reference integer graph); all
    three give bit-identical u8 maps.  ``device=None`` means ``cuda`` and
    raises without a GPU; pass ``device="cpu"`` to run the kernels' plain
    versions.

    ``ab_backends`` compiles shadow models on further backends; every tick
    replays the primary batch through each shadow and records the max
    absolute logit deviation in ``ab_stats`` (and, with an obs session
    installed, in ``ab_checks_total``, the ``ab_max_abs_dev`` gauge and,
    between two integer backends on a conv config, ``ab_mismatch_total``)
    — a live parity
    probe for a new backend against the serving one, e.g.
    ``ResNetEngine(cfg, qp, backend="cuda-stream",
    ab_backends=("torch-int",))``.

    ``tune`` engages the ``repro_torch.tune`` design-space layer (a
    per-task config dict / TuneResult, or ``"auto"``/``"analytic"``/
    ``"device"``): the primary model serves with the tuned kernel
    decomposition, while the shadows stay untuned so the A/B probe also
    guards the tuner."""

    def __init__(self, cfg, qparams, batch: int = 8, backend: str = "cuda",
                 batch_sizes=None, ab_backends=(), device=None, tune=None):
        from repro_torch.compile import compile_model

        self.cfg, self.batch = cfg, batch
        self.backend = backend
        if batch_sizes is None:
            batch_sizes = (batch,)
        if batch not in batch_sizes:
            raise ValueError(
                f"max batch {batch} must be one of batch_sizes {batch_sizes}")
        self.model = compile_model(cfg, qparams, backend=backend,
                                   batch_sizes=batch_sizes, device=device,
                                   tune=tune)
        self.tuning = self.model.tuning
        self.device = self.model.device
        self.shadows = {name: compile_model(cfg, qparams, backend=name,
                                            batch_sizes=batch_sizes,
                                            device=self.device)
                        for name in ab_backends}
        self.ab_stats = {name: [] for name in self.shadows}
        # shadows whose logits must equal the primary's bitwise
        self._bitwise = {
            name for name in self.shadows
            if not hasattr(cfg, "seq_len") and backend in _INT_BACKENDS
            and name in _INT_BACKENDS}
        self.queue: List[ImageRequest] = []
        self.served = 0

    def submit(self, req: ImageRequest):
        """Enqueue one request (shape-validated at admission)."""
        _validate_image(self.cfg, req)
        self.queue.append(req)

    def tick(self) -> bool:
        """Serve one batch; returns False when the queue is empty."""
        if not self.queue:
            return False
        reqs = self.queue[:self.batch]
        del self.queue[:len(reqs)]
        dtype = _input_contract(self.cfg)[1]
        imgs = np.stack([np.asarray(r.image, dtype) for r in reqs])
        out = self.model(imgs)
        for name, shadow in self.shadows.items():
            dev = float((shadow(imgs) - out).abs().max())
            self.ab_stats[name].append(dev)
            ob = _obs.active()
            if ob is not None:
                ob.metrics.counter(
                    "ab_checks_total", "A/B shadow replays").inc(shadow=name)
                ob.metrics.gauge(
                    "ab_max_abs_dev",
                    "last max |shadow - primary| logit deviation").set(
                        dev, shadow=name)
                if dev > 0 and name in self._bitwise:
                    ob.metrics.counter(
                        "ab_mismatch_total",
                        "integer shadow disagreed bitwise with primary").inc(
                            shadow=name)
        logits = out.cpu().numpy()
        for i, r in enumerate(reqs):
            r.logits = logits[i]
            r.label = int(np.argmax(logits[i]))
            r.done = True
        self.served += len(reqs)
        return True

    def run(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while self.queue and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks



# ---------------------------------------------------------------------------
# Scale-out serving: replica pool + deadline-based batch coalescing
# ---------------------------------------------------------------------------


def _to_host(out: torch.Tensor, event) -> np.ndarray:
    """Wait for a dispatch's logits (its ``torch.cuda.Event``, or none on
    the CPU) and copy them to the host."""
    if event is not None:
        event.synchronize()
    return out.cpu().numpy()


class ShardedResNetEngine:
    """Multi-replica image serving: the ``CompiledModel`` lowered once and
    instantiated per device (``serve.sched.ReplicaPool``), fed by a
    deadline-based batch coalescer (``serve.sched.Scheduler``).

    Request lifecycle:

        submit (arrival stamped, optional deadline/priority)
          -> coalesce (micro-batch held open until a bucket fills or the
             oldest request's slack is exhausted: ``slack_ms`` best-effort
             window, or ``deadline - service_estimate`` with a deadline)
          -> dispatch (least-loaded replica; the bucket's CUDA graph replay
             is enqueued on the replica device's current stream and a
             ``torch.cuda.Event`` recorded behind it, so replicas on
             several cards overlap)
          -> harvest (wait on the event, copy the logits to the host, stamp
             completion, record the queue-wait vs compute latency split)

    Bitwise the single-device :class:`ResNetEngine` path: replication and
    coalescing change *where and when* a batch runs, never the arithmetic
    (tests/test_torch_serve_sharded.py).  A batch goes to the card from
    pageable host memory, which blocks the host for the copy, so replicas
    on several cards overlap their compute but not their copies.

    ``devices`` (default: every CUDA device; raises without one) and
    ``replicas`` pick the pool; the model is compiled on the first device.
    ``clock`` is injectable (``sched.FakeClock``) so scheduling behavior is
    simulable; ``max_pending`` bounds admission (``submit`` raises
    ``sched.Backpressure`` when full; ``submit_async`` awaits instead).

    ``dispatch_listeners`` holds callables ``fn(dispatch, logits)``, called
    for each micro-batch once its replica has been handed it: the
    ``sched.Dispatch`` (its requests, their payloads) and the logits on the
    replica's device, enqueued and not yet waited for.  A checker records
    what each dispatch computed through it; the list is empty by default.
    """

    def __init__(self, cfg, qparams, batch: int = 8, backend: str = "cuda",
                 replicas: Optional[int] = None, devices=None,
                 batch_sizes=None, slack_ms: float = 5.0, clock=None,
                 max_pending: Optional[int] = None, tune=None,
                 service_estimate_ms: float = 0.0):
        from repro_torch.compile import compile_model

        self.cfg, self.batch = cfg, batch
        self.backend = backend
        if batch_sizes is None:
            batch_sizes = (batch,)
        if batch not in batch_sizes:
            raise ValueError(
                f"max batch {batch} must be one of batch_sizes {batch_sizes}")
        devices = S.pool_devices(devices, replicas)
        # lowered ONCE; the pool only adds per-device lowerings and graphs
        self.model = compile_model(cfg, qparams, backend=backend,
                                   batch_sizes=batch_sizes, tune=tune,
                                   device=devices[0])
        self.tuning = self.model.tuning
        self.pool = S.ReplicaPool(self.model, devices=devices)
        self.sched = S.Scheduler(
            self.pool.replicas, max_batch=batch, slack_s=slack_ms * 1e-3,
            clock=clock, max_pending=max_pending,
            service_estimate_s=service_estimate_ms * 1e-3)
        self.clock = self.sched.clock
        self.served = 0
        self._in_flight: List[tuple] = []     # (Dispatch, logits, event)
        self.dispatch_listeners: List = []

    # -- admission ----------------------------------------------------------

    def submit(self, req: ImageRequest, deadline_ms: Optional[float] = None,
               priority: int = 0) -> S.ScheduledRequest:
        """Admit one request.  ``deadline_ms`` is relative to now; omit it
        for best-effort coalescing under the ``slack_ms`` window.  Raises
        ``sched.Backpressure`` at ``max_pending``."""
        _validate_image(self.cfg, req)
        deadline_in = None if deadline_ms is None else deadline_ms * 1e-3
        return self.sched.submit(req, deadline_in=deadline_in,
                                 priority=priority)

    async def submit_async(self, req: ImageRequest,
                           deadline_ms: Optional[float] = None,
                           priority: int = 0,
                           retry_s: float = 1e-3) -> S.ScheduledRequest:
        """``submit`` with backpressure-as-await: when the pending queue is
        full, yield to the event loop (letting ``run_async`` drain) and
        retry instead of raising."""
        while True:
            try:
                return self.submit(req, deadline_ms=deadline_ms,
                                   priority=priority)
            except S.Backpressure:
                await asyncio.sleep(retry_s)

    # -- dispatch loop ------------------------------------------------------

    @property
    def outstanding(self) -> int:
        return self.sched.outstanding

    def tick(self) -> bool:
        """One scheduler round: dispatch every due micro-batch (enqueued,
        not waited for, so replicas overlap), then harvest the in-flight
        results.  Returns True if any work was done."""
        dispatched = self._dispatch_due()
        harvested = self._harvest()
        return bool(dispatched or harvested)

    def _dispatch_due(self) -> int:
        n = 0
        dtype = _input_contract(self.cfg)[1]
        while True:
            d = self.sched.poll()
            if d is None:
                break
            imgs = np.stack([np.asarray(r.payload.image, dtype)
                             for r in d.requests])
            try:
                out = self.pool.run(d.replica.index, imgs)
                event = None
                if out.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(out.device))
            except Exception:
                # a launch that raised must not leak in-flight slots
                self.sched.complete(d, failed=True)
                raise
            self._in_flight.append((d, out, event))
            for fn in self.dispatch_listeners:
                fn(d, out)
            n += 1
        return n

    def _next_ready_index(self) -> Optional[int]:
        """Index of a dispatch whose result is already computed (its event
        has completed, or it ran on the CPU), else None.  Harvesting
        ready-first matters twice: waiting strictly FIFO would stamp a fast
        replica's completion with a slow replica's wait (inflating
        compute_ms and the deadline EWMA), and would hold the loop hostage
        to the slowest replica while due batches could be dispatching to
        idle ones."""
        for i, (_, _, event) in enumerate(self._in_flight):
            if event is None or event.query():
                return i
        return None

    def _harvest(self, block: bool = True) -> int:
        """Complete every dispatch whose result is ready; when ``block`` and
        nothing at all was ready, wait on the oldest so the caller always
        makes progress.  Returns between harvests as soon as the remainder
        is still computing — the drive loops interleave ``_dispatch_due``
        so idle replicas never wait head-of-line on a slow one.  Only event
        waits, host copies and bookkeeping run here (``run_async`` calls it
        off the loop's thread): every dispatch, and with it every graph
        replay, stays on the thread whose current CUDA stream it uses."""
        n = 0
        while self._in_flight:
            i = self._next_ready_index()
            if i is None:
                if not block or n > 0:
                    break         # let the caller dispatch more work first
                i = 0             # nothing ready anywhere: wait on the oldest
            d, out, event = self._in_flight[i]
            try:
                logits = _to_host(out, event)
            except Exception:
                # a dispatch whose device execution errored must not jam the
                # head of the line or leak in-flight slots: evict it, release
                # the scheduler accounting (its requests stay done=False so
                # callers can see the failure), then surface the error
                self._in_flight.pop(i)
                self.sched.complete(d, failed=True)
                raise
            self._in_flight.pop(i)
            self.sched.complete(d)
            for j, r in enumerate(d.requests):
                r.payload.logits = logits[j]
                r.payload.label = int(np.argmax(logits[j]))
                r.payload.done = True
            self.served += len(d)
            n += 1
        return n

    def run(self, max_ticks: int = 100_000) -> int:
        """Drive until everything admitted so far is served.  When nothing
        is due yet (the coalescer is holding a batch open), sleeps the clock
        to the next dispatch-by time instead of spinning."""
        ticks = 0
        while self.outstanding and ticks < max_ticks:
            if not self.tick():
                self._sleep_until_due()
            ticks += 1
        return ticks

    def _sleep_until_due(self) -> None:
        due_at = self.sched.next_due_at()
        if due_at is None:
            return
        self.clock.sleep(max(due_at - self.clock.now(), 1e-4))

    async def run_async(self, idle_sleep_s: float = 1e-3) -> int:
        """Async dispatch loop: serve until the engine is shut down *and*
        drained.  Producers ``submit``/``submit_async`` concurrently; call
        ``shutdown()`` to let the loop finish the tail and return.  The
        wait on device results runs off the event loop, so producers keep
        filling the next micro-batch during compute; dispatches stay on the
        loop's thread."""
        ticks = 0
        while not (self.sched.closed and not self.outstanding
                   and not self._in_flight):
            progressed = self._dispatch_due() > 0
            if self._in_flight:
                progressed |= bool(
                    await asyncio.to_thread(self._harvest))
            if progressed:
                await asyncio.sleep(0)           # yield to producers
            else:
                await asyncio.sleep(idle_sleep_s)
            ticks += 1
        return ticks

    def shutdown(self) -> None:
        """Stop admission; pending requests become due immediately and drain
        through the normal dispatch path (graceful drain)."""
        self.sched.shutdown()

    # -- autoscaling hooks --------------------------------------------------

    @property
    def active_replicas(self) -> int:
        """Replicas currently receiving new dispatches (autoscaler-set)."""
        return self.sched.active

    def set_active_replicas(self, n: int, reason: str = None) -> int:
        """Actuate an autoscaling decision: route new dispatches to the
        first ``n`` replicas only (clamped to the pool size).  Deactivated
        replicas finish their in-flight work and keep their graphs, so
        scaling back up is instant.  ``reason`` (the policy trigger) is
        recorded on the scheduler's scale-event accounting."""
        return self.sched.set_active(n, reason=reason)

    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet dispatched — the autoscaler's
        primary pressure signal."""
        return self.sched.pending

    # -- introspection ------------------------------------------------------

    def latency_stats(self) -> dict:
        """p50/p99 queue-wait vs compute split, deadline accounting, and
        per-replica served/dispatched counts."""
        return self.sched.summary()

    def stats(self) -> dict:
        # latency_stats() already carries the per-replica breakdown under
        # 'replicas'; only add what it doesn't have
        return dict(model=self.model.stats(), pool_size=len(self.pool),
                    served=self.served, **self.latency_stats())
