"""The port's scheduler (``repro_torch.serve.sched``): the cases of
tests/test_sched.py — the deadline-based batch coalescer and the replica
scheduler driven entirely by a FakeClock, no model, no real time — then
the same FakeClock scripts through the JAX package's ``Scheduler`` and the
port's, compared dispatch by dispatch, and the port's ``ReplicaPool`` over
torch devices."""
import numpy as np
import pytest
import torch

from repro.serve import sched as JS
from repro_torch.serve import sched as PS
from repro_torch.serve.sched import (Backpressure, BatchCoalescer, Dispatch,
                                     FakeClock, ReplicaPool, ReplicaState,
                                     ScheduledRequest, Scheduler,
                                     SchedulerClosed, least_loaded)


def make(n_replicas=1, max_batch=4, slack_s=0.005, **kw):
    clock = FakeClock()
    sched = Scheduler(n_replicas, max_batch=max_batch, slack_s=slack_s,
                      clock=clock, **kw)
    return sched, clock


def run_sim(sched, clock, service_s, idle_step=1e-4, max_steps=100_000):
    """Single-worker simulation: every dispatch computes for ``service_s``
    simulated seconds, then completes.  Returns the dispatches in order."""
    dispatches = []
    steps = 0
    while sched.outstanding and steps < max_steps:
        d = sched.poll()
        if d is None:
            clock.advance(idle_step)
        else:
            clock.advance(service_s)
            sched.complete(d)
            dispatches.append(d)
        steps += 1
    assert steps < max_steps, "simulation did not converge"
    return dispatches


# ---------------------------------------------------------------------------
# coalescing policy
# ---------------------------------------------------------------------------


def test_full_bucket_dispatches_immediately():
    sched, clock = make(max_batch=3, slack_s=10.0)
    for i in range(3):
        sched.submit(f"r{i}")
    d = sched.poll()                      # full batch: no waiting
    assert d is not None and len(d) == 3
    assert [r.payload for r in d.requests] == ["r0", "r1", "r2"]


def test_partial_batch_held_until_slack_expires():
    sched, clock = make(max_batch=4, slack_s=0.010)
    sched.submit("a")
    assert sched.poll() is None           # held open: slack not exhausted
    clock.advance(0.009)
    assert sched.poll() is None
    clock.advance(0.002)                  # 11ms > 10ms window
    d = sched.poll()
    assert d is not None and len(d) == 1


def test_deadline_overrides_slack_window():
    """A tight deadline makes the batch due long before the best-effort
    window would close."""
    sched, clock = make(max_batch=8, slack_s=1.0,
                        service_estimate_s=0.002)
    sched.submit("urgent", deadline_in=0.005)
    assert sched.poll() is None           # 5ms deadline - 2ms service = 3ms
    clock.advance(0.0035)
    d = sched.poll()
    assert d is not None
    assert d.requests[0].payload == "urgent"


def test_deadline_with_cold_service_estimate_dispatches_immediately():
    """With no service-time observation yet (estimate 0), a deadline cannot
    be budgeted against: the request is due at once instead of being held
    until the deadline (which would guarantee a miss)."""
    sched, clock = make(max_batch=8, slack_s=1.0, service_estimate_s=0.0)
    r = sched.submit("cold", deadline_in=0.050)
    d = sched.poll()                      # immediately due, not at t=50ms
    assert d is not None
    clock.advance(0.010)
    sched.complete(d)
    assert r.deadline_met
    assert sched.service_estimate_s > 0   # first completion seeds the EWMA


def test_deadline_never_violated_when_capacity_suffices():
    """Acceptance: with enough capacity (service time well under deadline
    spacing), every deadline is met — the coalescer dispatches early enough
    to leave room for the compute itself."""
    service = 0.004
    sched, clock = make(max_batch=4, slack_s=0.5, service_estimate_s=service)
    reqs = []
    for i in range(16):
        reqs.append(sched.submit(f"r{i}", deadline_in=0.050))
        clock.advance(0.002)              # staggered arrivals
        while True:                       # serve anything due right away
            d = sched.poll()
            if d is None:
                break
            clock.advance(service)
            sched.complete(d)
    run_sim(sched, clock, service)
    assert all(r.deadline_met for r in reqs)
    assert sched.stats.deadline_misses == 0
    assert sched.stats.deadline_total == 16


def test_fifo_within_priority_class():
    sched, clock = make(max_batch=8, slack_s=0.001)
    for i in range(6):
        sched.submit(f"r{i}")
    clock.advance(0.002)
    d = sched.poll()
    assert [r.payload for r in d.requests] == [f"r{i}" for i in range(6)]


def test_urgent_priority_class_jumps_the_queue_but_stays_fifo_inside():
    sched, clock = make(max_batch=3, slack_s=0.001)
    sched.submit("bulk0", priority=1)
    sched.submit("bulk1", priority=1)
    sched.submit("hot0", priority=0)
    sched.submit("hot1", priority=0)
    clock.advance(0.002)
    d = sched.poll()
    # urgent class first (FIFO inside), then the oldest bulk request
    assert [r.payload for r in d.requests] == ["hot0", "hot1", "bulk0"]
    d2 = sched.poll()
    assert [r.payload for r in d2.requests] == ["bulk1"]


# ---------------------------------------------------------------------------
# replica selection + in-flight accounting
# ---------------------------------------------------------------------------


def test_least_loaded_prefers_fewest_in_flight():
    reps = [ReplicaState(0, in_flight=2), ReplicaState(1, in_flight=0),
            ReplicaState(2, in_flight=1)]
    assert least_loaded(reps).index == 1


def test_least_loaded_tie_breaks_on_dispatched_then_index():
    reps = [ReplicaState(0, dispatched=8), ReplicaState(1, dispatched=4),
            ReplicaState(2, dispatched=4)]
    assert least_loaded(reps).index == 1


def test_dispatches_spread_across_replicas_when_busy():
    """Two back-to-back batches with no completion in between land on two
    different replicas; after the first completes, it is chosen again."""
    sched, clock = make(n_replicas=2, max_batch=2, slack_s=0.001)
    for i in range(4):
        sched.submit(f"r{i}")
    d0 = sched.poll()
    d1 = sched.poll()
    assert d0.replica.index == 0 and d1.replica.index == 1
    assert sched.in_flight == 4
    sched.complete(d0)
    assert sched.in_flight == 2
    sched.submit("r4"); sched.submit("r5")
    d2 = sched.poll()
    assert d2.replica.index == 0          # freed replica is least-loaded
    sched.complete(d1); sched.complete(d2)
    assert sched.in_flight == 0
    assert [r.served for r in sched.replicas] == [4, 2]


def test_request_stamps_replica_and_latency_split():
    sched, clock = make(max_batch=2, slack_s=0.001)
    r = sched.submit("x")
    clock.advance(0.002)
    d = sched.poll()
    clock.advance(0.010)
    sched.complete(d)
    assert r.replica == 0
    assert r.queue_wait == pytest.approx(0.002)
    assert r.compute_time == pytest.approx(0.010)
    s = sched.summary()
    assert s["count"] == 1
    assert s["queue_wait_ms"]["p50"] == pytest.approx(2.0)
    assert s["compute_ms"]["p50"] == pytest.approx(10.0)


def test_service_estimate_ewma_tracks_observations():
    sched, clock = make(max_batch=1, slack_s=0.0, service_estimate_s=0.0)
    for service in (0.010, 0.020):
        sched.submit("x")
        d = sched.poll()
        clock.advance(service)
        sched.complete(d)
    # first observation seeds the estimate; second moves it by the EWMA step
    assert sched.service_estimate_s == pytest.approx(
        0.010 + sched.ewma * 0.010)


# ---------------------------------------------------------------------------
# backpressure + shutdown
# ---------------------------------------------------------------------------


def test_backpressure_at_max_pending():
    sched, clock = make(max_batch=8, slack_s=10.0, max_pending=2)
    sched.submit("a"); sched.submit("b")
    with pytest.raises(Backpressure):
        sched.submit("c")
    clock.advance(11.0)
    d = sched.poll()                      # draining frees the queue
    sched.complete(d)
    sched.submit("c")                     # now admitted


def test_graceful_drain_on_shutdown():
    """shutdown() stops admission; everything pending flushes immediately
    (partial batches included) and completes through the normal cycle."""
    sched, clock = make(max_batch=4, slack_s=10.0)
    reqs = [sched.submit(f"r{i}") for i in range(6)]

    def execute(d):
        clock.advance(0.001)
        sched.complete(d)

    n = sched.drain(execute)
    assert n == 2                         # 4 + 2, no waiting for slack
    assert sched.outstanding == 0
    assert all(r.complete_t is not None for r in reqs)
    with pytest.raises(SchedulerClosed):
        sched.submit("late")


def test_poll_is_empty_noop():
    sched, clock = make()
    assert sched.poll() is None
    assert sched.outstanding == 0


def test_coalescer_take_caps_at_max_batch():
    c = BatchCoalescer(max_batch=2)
    t = 0.0
    for i in range(5):
        c.add(ScheduledRequest(payload=i, seq=i, arrival=t))
    assert [r.payload for r in c.take()] == [0, 1]
    assert [r.payload for r in c.take()] == [2, 3]
    assert [r.payload for r in c.take()] == [4]
    assert len(c) == 0


def test_scheduler_rejects_bad_config():
    with pytest.raises(ValueError):
        Scheduler(0, max_batch=4)
    with pytest.raises(ValueError):
        Scheduler(1, max_batch=0)
    sched, _ = make()
    with pytest.raises(ValueError, match="not both"):
        sched.submit("x", deadline=1.0, deadline_in=1.0)


# ---------------------------------------------------------------------------
# the same script through the JAX package's scheduler and the port's
# ---------------------------------------------------------------------------


def _script(mod, seed, n_replicas, max_batch, slack_s, service_s):
    """A seeded FakeClock script: bursts of arrivals with and without
    deadlines, in two priority classes, polled between bursts; each
    dispatch completes after a service time drawn per batch, and replica
    completions interleave.  Returns (dispatch log, summary)."""
    rng = np.random.default_rng(seed)
    clock = mod.FakeClock()
    sched = mod.Scheduler(n_replicas, max_batch=max_batch, slack_s=slack_s,
                          clock=clock, max_pending=64)
    log, running, rid = [], [], 0

    def poll_all():
        while True:
            d = sched.poll()
            if d is None:
                return
            log.append((round(clock.now(), 9), d.replica.index,
                        [r.payload for r in d.requests]))
            running.append((clock.now() + service_s * rng.uniform(0.5, 1.5),
                            d))

    def finish_until(t):
        for end, d in sorted(running, key=lambda e: e[0]):
            if end <= t:
                clock.advance(max(0.0, end - clock.now()))
                sched.complete(d)
                running.remove((end, d))

    for _ in range(40):
        for _ in range(int(rng.integers(0, 6))):
            deadline = None if rng.random() < 0.4 else \
                float(rng.uniform(0.002, 0.02))
            sched.submit(rid, deadline_in=deadline,
                         priority=int(rng.integers(0, 2)))
            rid += 1
        poll_all()
        step = float(rng.uniform(0.0, 0.003))
        finish_until(clock.now() + step)
        clock.advance(max(0.0, step))
        poll_all()
    n = sched.drain(lambda d: (clock.advance(service_s), sched.complete(d)))
    finish_until(float("inf"))
    return log, int(n), sched.summary()


@pytest.mark.parametrize("n_replicas,max_batch,slack_s,service_s", [
    (1, 4, 0.002, 0.001), (2, 3, 0.004, 0.003), (3, 8, 0.001, 0.0005)])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_matches_jax_scheduler_under_fake_clock(
        seed, n_replicas, max_batch, slack_s, service_s):
    ours = _script(PS, seed, n_replicas, max_batch, slack_s, service_s)
    ref = _script(JS, seed, n_replicas, max_batch, slack_s, service_s)
    assert ours[0] == ref[0]                  # dispatch order and replicas
    assert len(ours[0]) > 10 and len({e[1] for e in ours[0]}) == n_replicas
    assert ours[1] == ref[1]
    assert ours[2] == ref[2]                  # summary(), every key


# ---------------------------------------------------------------------------
# the replica pool over torch devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model8():
    from repro_torch.compile import compile_model
    from repro_torch.models import resnet as R
    cfg = R.RESNET8
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(0))), cfg)
    return compile_model(cfg, qp, batch_sizes=(1, 2), device="cpu")


def test_replica_pool_needs_a_gpu_unless_given_devices(model8, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaPool(model8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaPool(model8, devices=["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaPool(model8, replicas=1)


def test_replica_pool_on_named_devices(model8):
    pool = ReplicaPool(model8, devices=["cpu", "cpu"])
    assert len(pool) == 2 and [r.index for r in pool.replicas] == [0, 1]
    assert all(d == torch.device("cpu") for d in pool.devices)
    assert len(ReplicaPool(model8, devices=["cpu", "cpu"], replicas=1)) == 1
    with pytest.raises(ValueError, match="devices"):
        ReplicaPool(model8, devices=["cpu"], replicas=3)
    with pytest.raises(ValueError, match="at least one device"):
        ReplicaPool(model8, devices=[])
    pool.warmup()
    assert model8.stats()["placed"] == [(1, "cpu"), (2, "cpu")]
    x = np.random.default_rng(0).uniform(
        0, 0.999, (2, 32, 32, 3)).astype(np.float32)
    assert torch.equal(pool.run(1, x), model8(x))
