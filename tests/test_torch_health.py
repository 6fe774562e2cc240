"""``repro_torch.obs.health``, ``obs.recorder`` and ``bundle.write_bundle``
on the CPU: the cases of tests/test_health.py against the port, then the
port held against the JAX package's ``repro.obs`` in one process.

The contracts, strictest first:

1. **Determinism** — every alert timestamp comes from the injected clock,
   so the alert log is byte-identical across same-seed simulations, and
   byte-identical to the reference's on the same trace (observe and
   actuate mode, reports equal).
2. **Hand-computed burn rates**, **edge-triggering**, **bounded memory**,
   as in the reference.
3. **Artifacts parse** — debug bundles round-trip through the port's
   report-CLI validators, and a bundle written by either package parses
   with the other's ``read_bundle``.
4. **The control loop pays for itself** — on the seeded adversarial trace
   the alert-actuated arm strictly beats the queue-signal baseline, while
   a passive monitor changes no routing decision at all.
"""
import json

import numpy as np
import pytest
import torch

import repro.obs as JO
from repro.obs import runtime as jobsrt
from repro.serve.sched import FakeClock as JFakeClock
from repro.traffic import loadgen as JL
from repro_torch.obs import (Alert, BitExactSentinel, BurnRateRule,
                             FlightRecorder, HealthMonitor, LatencyBandRule,
                             QueueGrowthRule, RetraceStormRule,
                             alert_log_path, default_rules, read_bundle,
                             write_bundle)
from repro_torch.obs import runtime as obsrt
from repro_torch.obs.__main__ import load_alerts, main as obs_main
from repro_torch.obs.health import _WindowedCounter
from repro_torch.serve.sched import FakeClock
from repro_torch.traffic import loadgen as L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_session_leaks():
    """Obs state is a module global in each package: every test starts and
    ends clean in both."""
    prior, jprior = obsrt.disable(), jobsrt.disable()
    yield
    obsrt.install(prior)
    jobsrt.install(jprior)


def _session():
    clock = FakeClock()
    ob = obsrt.instrument(clock=clock)
    return ob, clock


# ---------------------------------------------------------------------------
# windowed counters
# ---------------------------------------------------------------------------


def test_windowed_counter_delta_and_pruning():
    wc = _WindowedCounter(horizon_s=10.0)
    for t in range(40):
        wc.push(float(t), float(t * 2))          # monotone: +2 per second
    assert wc.delta(5.0, now=39.0) == pytest.approx(10.0)
    assert wc.delta(10.0, now=39.0) == pytest.approx(20.0)
    assert len(wc.samples) <= 13
    assert wc.delta(100.0, now=39.0) == wc.samples[-1][1] - wc.samples[0][1]


def test_windowed_counter_empty():
    wc = _WindowedCounter(horizon_s=1.0)
    assert wc.delta(1.0, now=0.0) == 0.0


# ---------------------------------------------------------------------------
# burn-rate rule: hand-computed fixtures
# ---------------------------------------------------------------------------


def test_burn_rate_hand_computed_fires():
    """10 missed / 20 total at objective 0.95: a burn of exactly 10x in
    both windows, over the 2x threshold, so the rule pages."""
    ob, clock = _session()
    rule = BurnRateRule(cls="standard", objective=0.95, threshold=2.0,
                        fast_s=1.0, slow_s=30.0, min_samples=5)
    hm = HealthMonitor(ob, rules=[rule], interval_s=0.05)
    c = ob.metrics.counter("slo_deadline_total", "outcomes")
    assert hm.tick(0.0) == []
    c.inc(10, cls="standard", outcome="met")
    c.inc(10, cls="standard", outcome="missed")
    fired = hm.tick(0.5)
    assert [a.rule for a in fired] == ["burn_rate:standard"]
    ctx = dict(fired[0].context)
    assert ctx["fast_burn"] == pytest.approx(10.0)
    assert ctx["slow_burn"] == pytest.approx(10.0)
    assert fired[0].severity == "page"
    assert fired[0].t == 0.5


def test_burn_rate_below_threshold_stays_silent():
    ob, clock = _session()
    rule = BurnRateRule(cls="standard", objective=0.95, threshold=2.0)
    hm = HealthMonitor(ob, rules=[rule])
    c = ob.metrics.counter("slo_deadline_total", "outcomes")
    hm.tick(0.0)
    c.inc(97, cls="standard", outcome="met")
    c.inc(3, cls="standard", outcome="missed")
    assert hm.tick(0.5) == []
    assert not rule.active


def test_burn_rate_needs_both_windows():
    ob, clock = _session()
    rule = BurnRateRule(cls="standard", objective=0.95, threshold=2.0,
                        fast_s=1.0, slow_s=30.0, min_samples=5)
    hm = HealthMonitor(ob, rules=[rule])
    c = ob.metrics.counter("slo_deadline_total", "outcomes")
    hm.tick(0.0)
    c.inc(990, cls="standard", outcome="met")
    hm.tick(1.0)
    c.inc(10, cls="standard", outcome="missed")
    fired = hm.tick(29.0)
    assert fired == [] and not rule.active


def test_burn_rate_ignores_other_classes():
    ob, clock = _session()
    rule = BurnRateRule(cls="standard", objective=0.95)
    hm = HealthMonitor(ob, rules=[rule])
    c = ob.metrics.counter("slo_deadline_total", "outcomes")
    hm.tick(0.0)
    c.inc(50, cls="bulk", outcome="missed")
    assert hm.tick(0.5) == []


def test_burn_rate_rejects_bad_objective():
    with pytest.raises(ValueError):
        BurnRateRule(objective=1.0)


# ---------------------------------------------------------------------------
# edge-triggering and the anomaly rules
# ---------------------------------------------------------------------------


class _FakeSched:
    def __init__(self):
        self.pending = 0
        self.in_flight = 0
        self.replicas = [None]
        self.active = 1


def test_queue_growth_edge_trigger_and_rearm():
    ob, clock = _session()
    rule = QueueGrowthRule(k=4, min_depth=4)
    hm = HealthMonitor(ob, rules=[rule])
    sched = _FakeSched()
    hm.attach_server("primary", sched)

    t = 0.0

    def tick(depth):
        nonlocal t
        sched.pending = depth
        t += 0.05
        return hm.tick(t)

    fired = []
    for d in (1, 2, 5, 9, 14):
        fired += tick(d)
    assert [a.rule for a in fired] == ["queue_growth"]
    for d in (15, 16, 17, 18):
        assert tick(d) == []
    assert rule.active
    assert tick(18) == []
    assert not rule.active
    fired = []
    for d in (19, 20, 21, 22, 23):
        fired += tick(d)
    assert [a.rule for a in fired] == ["queue_growth"]
    assert rule.fired == 2


def test_latency_band_detects_excursion():
    ob, clock = _session()
    rule = LatencyBandRule(metric="sched_queue_wait_ms", warmup=8)
    hm = HealthMonitor(ob, rules=[rule])
    h = ob.metrics.histogram("sched_queue_wait_ms", "wait")
    t = 0.0
    for _ in range(12):
        h.observe(1.0)
        t += 0.05
        assert hm.tick(t) == []
    h.observe(500.0)
    fired = hm.tick(t + 0.05)
    assert [a.rule for a in fired] == ["latency_band:sched_queue_wait_ms"]
    ctx = dict(fired[0].context)
    assert ctx["mean_ms"] > ctx["band_ms"]
    assert hm.tick(t + 0.10) == []


def test_retrace_storm_windowed():
    ob, clock = _session()
    rule = RetraceStormRule(window_s=1.0, storm_n=3)
    hm = HealthMonitor(ob, rules=[rule])
    c = ob.metrics.counter("compile_retraces_total", "retraces")
    hm.tick(0.0)
    c.inc(2, bucket="8", backend="cuda")
    assert hm.tick(0.2) == []
    c.inc(1, bucket="4", backend="cuda")
    fired = hm.tick(0.4)
    assert [a.rule for a in fired] == ["retrace_storm"]
    assert fired[0].severity == "page"
    assert hm.tick(2.0) == []
    assert not rule.active


def test_bit_exact_sentinel_fires_per_increase():
    ob, clock = _session()
    rule = BitExactSentinel()
    hm = HealthMonitor(ob, rules=[rule])
    c = ob.metrics.counter("ab_mismatch_total", "mismatches")
    assert hm.tick(0.0) == []
    c.inc(shadow="torch-int")
    assert [a.rule for a in hm.tick(0.1)] == ["bit_exact"]
    assert hm.tick(0.2) == []
    c.inc(shadow="torch-int")
    assert [a.rule for a in hm.tick(0.3)] == ["bit_exact"]


def test_alerts_recorded_in_metrics_and_trace():
    ob, clock = _session()
    hm = HealthMonitor(ob, rules=[BitExactSentinel()])
    ob.metrics.counter("ab_mismatch_total", "m").inc()
    hm.tick(0.5)
    assert ob.metrics.counter(
        "health_alerts_total", "").value(rule="bit_exact",
                                         severity="page") == 1
    instants = [e for e in ob.trace.events
                if e.ph == "i" and e.name == "alert"]
    assert len(instants) == 1 and instants[0].args["rule"] == "bit_exact"
    assert hm.summary()["by_rule"] == {"bit_exact": 1}


# ---------------------------------------------------------------------------
# flight recorder: bounded rings
# ---------------------------------------------------------------------------


def test_flight_recorder_ring_eviction_bounds():
    ob, clock = _session()
    rec = FlightRecorder(events_capacity=8, snapshots_capacity=4)
    rec.attach(ob.trace)
    for i in range(20):
        ob.trace.instant(f"e{i}", cat="test", track="t", t=float(i))
    assert len(rec.events) == 8
    assert rec.seen_events == 20
    assert rec.dropped_events == 12
    assert [e.name for e in rec.events] == [f"e{i}" for i in range(12, 20)]
    c = ob.metrics.counter("x_total", "x")
    for i in range(10):
        c.inc()
        rec.record_metrics(float(i), ob.metrics)
    assert len(rec.deltas) == 4
    s = rec.summary()
    assert s["events_capacity"] == 8 and s["metric_samples"] == 4


def test_flight_recorder_changed_keys_only():
    ob, clock = _session()
    rec = FlightRecorder()
    c = ob.metrics.counter("a_total", "a")
    c.inc()
    rec.record_metrics(0.0, ob.metrics)
    rec.record_metrics(1.0, ob.metrics)
    assert len(rec.deltas) == 1
    ob.metrics.counter("b_total", "b").inc(5)
    rec.record_metrics(2.0, ob.metrics)
    assert len(rec.deltas) == 2
    t, changed = rec.deltas[-1]
    assert t == 2.0 and list(changed) == ["b_total||"]
    ob.trace.instant("mark", cat="test", track="t", t=0.5)
    assert "traceEvents" in rec.chrome()


def test_trace_without_listeners_records_as_before():
    """The listener hook keeps the empty-list fast path: a trace nobody
    subscribed to records exactly what it did, and a listener sees every
    span and instant in recording order."""
    ob, clock = _session()
    assert ob.trace.listeners == []
    ob.trace.span("s", cat="c", track="t", t0=0.0, t1=1.0)
    seen = []
    ob.trace.listeners.append(seen.append)
    ob.trace.span("s2", cat="c", track="t", t0=1.0, t1=2.0)
    ob.trace.instant("i", cat="c", track="t", t=2.5)
    assert [e.name for e in ob.trace.events] == ["s", "s2", "i"]
    assert seen == ob.trace.events[1:]


# ---------------------------------------------------------------------------
# debug bundles: round-trip through the CLI validators
# ---------------------------------------------------------------------------


def test_bundle_round_trip(tmp_path):
    ob, clock = _session()
    rec = FlightRecorder(events_capacity=64)
    rec.attach(ob.trace)
    hm = HealthMonitor(ob, rules=[BitExactSentinel()], recorder=rec,
                       bundle_dir=str(tmp_path / "bundles"))
    hm.attach_server("primary", _FakeSched())
    hm.census_extra["arch"] = "resnet8"
    ob.trace.instant("warm", cat="test", track="t", t=0.1)
    ob.metrics.counter("ab_mismatch_total", "m").inc()
    clock.advance(0.5)
    fired = hm.tick(0.5)
    assert fired and len(hm.bundles) == 1

    bundle = read_bundle(hm.bundles[0])
    m = bundle["manifest"]
    assert m["reason"] == "alert:bit_exact"
    assert m["t"] == 0.5 and m["alerts"] == 1
    assert m["census"]["servers"]["primary"]["replicas"] == 1
    assert m["census"]["arch"] == "resnet8"
    assert m["recorder"]["events"] >= 1
    assert bundle["alerts"][0]["rule"] == "bit_exact"
    assert any(e.get("name") == "warm" for e in bundle["trace_events"])
    assert "ab_mismatch_total" in bundle["metrics"]

    assert obs_main(["--bundle", hm.bundles[0]]) == 0
    assert obs_main(["--alerts", hm.bundles[0]]) == 0
    assert obs_main(["--alerts", hm.bundles[0], "--assert-no-alerts"]) == 1


def test_bundle_cap_and_drain_postmortem(tmp_path):
    ob, clock = _session()
    hm = HealthMonitor(ob, rules=[], bundle_dir=str(tmp_path),
                       max_bundles=2)
    ob.health = hm
    assert hm.dump_bundle("first", 0.0)
    hm.on_drain(missed=3)
    assert len(hm.bundles) == 2
    assert "drain_missed_deadlines" in hm.bundles[1]
    assert hm.dump_bundle("over-cap", 1.0) is None
    assert len(hm.bundles) == 2


def test_scheduler_drain_with_missed_deadlines_dumps_a_bundle(tmp_path):
    """The port's ``Scheduler.drain`` reads ``ob.health`` and hands a late
    drain to the monitor, which freezes a post-mortem bundle."""
    from repro_torch.serve import sched as S

    ob, clock = _session()
    hm = HealthMonitor(ob, rules=[], bundle_dir=str(tmp_path))
    ob.health = hm
    sched = S.Scheduler(1, max_batch=2, slack_s=50.0, clock=clock)
    sched.submit("late", deadline_in=0.5)
    clock.advance(1.0)
    res = sched.drain(lambda d: sched.complete(d))
    assert res.missed_deadline == 1
    assert len(hm.bundles) == 1 and "drain_missed_deadlines" in hm.bundles[0]
    assert read_bundle(hm.bundles[0])["manifest"]["reason"] == \
        "drain_missed_deadlines"


def test_read_bundle_rejects_garbage(tmp_path):
    with pytest.raises(ValueError, match="manifest"):
        read_bundle(str(tmp_path))
    (tmp_path / "manifest.json").write_text('{"schema": 99}')
    with pytest.raises(ValueError, match="schema"):
        read_bundle(str(tmp_path))


def test_alert_log_write_and_dump_cli(tmp_path):
    ob, clock = _session()
    hm = HealthMonitor(ob, rules=[BitExactSentinel()])
    ob.metrics.counter("ab_mismatch_total", "m").inc()
    hm.tick(0.25)
    log = tmp_path / "run.alerts.jsonl"
    hm.write_alert_log(str(log))
    assert load_alerts(str(log))[0]["t"] == 0.25
    metrics = tmp_path / "metrics.txt"
    metrics.write_text(ob.metrics.render_text())

    out = tmp_path / "bundles"
    rc = obs_main(["dump", "--metrics", str(metrics), "--alerts", str(log),
                   "--out", str(out), "--reason", "post mortem"])
    assert rc == 0
    bundle = read_bundle(str(out / "bundle_000_post-mortem"))
    assert bundle["manifest"]["alerts"] == 1
    assert bundle["alerts"][0]["rule"] == "bit_exact"
    assert obs_main(["dump", "--out", str(out)]) == 1


def test_alert_log_path_derivation():
    assert alert_log_path("results/metrics.txt") == \
        "results/metrics.alerts.jsonl"


def test_alert_canonical_json():
    a = Alert(rule="r", severity="warn", t=1.5, message="m",
              context=(("b", 2), ("a", 1)))
    d = json.loads(a.to_json())
    assert d == {"rule": "r", "severity": "warn", "t": 1.5, "message": "m",
                 "context": {"a": 1, "b": 2}}
    assert a.to_json() == JO.Alert(rule="r", severity="warn", t=1.5,
                                   message="m",
                                   context=(("b", 2), ("a", 1))).to_json()


# ---------------------------------------------------------------------------
# control-loop signals
# ---------------------------------------------------------------------------


def test_autoscaler_scales_on_alert_hint():
    from repro_torch.traffic import AutoscaleConfig, Autoscaler

    class _Hint:
        def scale_hint(self):
            return "burn_rate:standard"

    clock = FakeClock()
    auto = Autoscaler(AutoscaleConfig(min_replicas=1, max_replicas=4,
                                      cooldown_s=0.0),
                      clock=clock, health=_Hint())
    assert auto.observe(busy=0, queue_depth=0, slots_per_replica=8) == 2
    assert auto.last_reason == "alert:burn_rate:standard"
    clock.advance(1.0)
    assert auto.observe(busy=0, queue_depth=0, slots_per_replica=8) == 3


def test_router_preemptive_degrade_on_alert():
    from repro_torch.traffic import OverloadRouter, ServerSignals
    from repro_torch.traffic.slo import SLOClass

    ob, clock = _session()

    class _Overloaded:
        def overloaded(self):
            return "burn_rate:standard"

    classes = [SLOClass("standard", deadline_ms=50.0, priority=1,
                        policy="degrade")]
    idle = ServerSignals(outstanding=0, active=1, max_batch=8,
                         service_estimate_s=0.001)
    signals = {"resnet20": idle, "resnet8": idle}
    plain = OverloadRouter(classes, "resnet20", degraded="resnet8")
    assert plain.route("standard", signals).target == "resnet20"
    wired = OverloadRouter(classes, "resnet20", degraded="resnet8",
                           health=_Overloaded())
    d = wired.route("standard", signals)
    assert d.target == "resnet8" and d.degraded
    assert d.reason == "alert:burn_rate:standard"
    assert ob.metrics.counter("health_actuations_total", "").value(
        kind="degrade", cls="standard") == 1


# ---------------------------------------------------------------------------
# end-to-end acceptance: seeded sims, in the port and in the reference
# ---------------------------------------------------------------------------


def _trickle_burst_times(seed=0, cycles=6, trickle_s=0.15, burst_s=0.08,
                         trickle_rate=60.0, burst_rate=2500.0):
    """The arrival times of tests/test_health.py's EWMA-adversarial trace:
    each trickle phase trains the scheduler's service estimate on cheap
    singleton batches, so at the next burst front the predictive router
    under-prices the primary."""
    rng = np.random.default_rng(seed)
    out, t0 = [], 0.0
    for _ in range(cycles):
        t = t0
        while t < t0 + trickle_s:
            out.append(t)
            t += rng.exponential(1.0 / trickle_rate)
        t = t0 + trickle_s
        while t < t0 + trickle_s + burst_s:
            out.append(t)
            t += rng.exponential(1.0 / burst_rate)
        t0 += trickle_s + burst_s
    return out


def _trickle_burst_arrivals(seed=0, cycles=6, **kw):
    return [L.Arrival(t=t, slo="standard")
            for t in _trickle_burst_times(seed, cycles, **kw)]


def _run_health_sim(arrivals, mode, primary_fps=400.0, port=True):
    """One sim arm: 'base' (no monitor), 'observe' (passive alerts), or
    'actuate' (monitor wired into the router), through the port's stack
    or, with ``port=False``, the JAX package's."""
    if port:
        from repro_torch import traffic as T
        obs_rt, Monitor, rules, Clock = (obsrt, HealthMonitor,
                                         default_rules, FakeClock)
    else:
        from repro import traffic as T
        obs_rt, Monitor, rules, Clock = (jobsrt, JO.HealthMonitor,
                                         JO.default_rules, JFakeClock)
        arrivals = [JL.Arrival(t=a.t, slo=a.slo) for a in arrivals]

    classes = T.parse_classes("standard:25:1:degrade")
    clock = Clock()
    prior = obs_rt.disable()
    try:
        health = None
        if mode != "base":
            ob = obs_rt.instrument(clock=clock)
            health = Monitor(
                ob, rules=rules(["standard"], objective=0.99),
                interval_s=0.01)
            ob.health = health
        servers = {
            "resnet20": T.SimServer("resnet20",
                                    T.ServiceModel.from_fps(primary_fps),
                                    clock, replicas=1, max_batch=8),
            "resnet8": T.SimServer("resnet8",
                                   T.ServiceModel.from_fps(30000.0),
                                   clock, replicas=1, max_batch=8)}
        router = T.OverloadRouter(
            classes, primary="resnet20", degraded="resnet8",
            health=health if mode == "actuate" else None)
        sim = T.TrafficSim(servers, classes, router, clock, health=health)
        report = sim.run(arrivals)
        log = health.alert_log_jsonl() if health else ""
        return report, log, health
    finally:
        obs_rt.install(prior)


def test_overload_fires_burn_rate_quiet_arm_silent():
    hot = _trickle_burst_arrivals(seed=0, cycles=3)
    _, log, health = _run_health_sim(hot, "observe")
    rules_fired = {json.loads(line)["rule"] for line in log.splitlines()}
    assert "burn_rate:standard" in rules_fired
    assert health.summary()["alerts"] == len(log.splitlines())

    quiet = _trickle_burst_arrivals(seed=0, cycles=3, trickle_rate=2000.0,
                                    burst_rate=2000.0)
    quiet_rep, quiet_log, quiet_health = _run_health_sim(
        quiet, "observe", primary_fps=30000.0)
    assert quiet_rep["classes"]["standard"]["deadline_hit_rate"] == 1.0
    pages = [json.loads(line) for line in quiet_log.splitlines()
             if json.loads(line)["severity"] == "page"]
    assert pages == []
    assert "burn_rate:standard" not in {
        json.loads(line)["rule"] for line in quiet_log.splitlines()}
    assert quiet_health.ticks > 0


def test_alert_log_byte_identical_across_runs():
    logs = []
    for _ in range(2):
        arrivals = _trickle_burst_arrivals(seed=0, cycles=3)
        _, log, _ = _run_health_sim(arrivals, "observe")
        logs.append(log)
    assert logs[0] != ""
    assert logs[0] == logs[1]


def test_passive_monitor_does_not_perturb_routing():
    arrivals = _trickle_burst_arrivals(seed=0, cycles=3)
    base, _, _ = _run_health_sim(arrivals, "base")
    obs, _, _ = _run_health_sim(arrivals, "observe")
    assert base["classes"] == obs["classes"]
    assert base["totals"] == obs["totals"]


def test_actuated_arm_beats_queue_signal_baseline():
    arrivals = _trickle_burst_arrivals(seed=0, cycles=6)
    base, _, _ = _run_health_sim(arrivals, "base")
    act, act_log, act_health = _run_health_sim(arrivals, "actuate")
    hit_base = base["classes"]["standard"]["deadline_hit_rate"]
    hit_act = act["classes"]["standard"]["deadline_hit_rate"]
    assert hit_act > hit_base
    assert act["classes"]["standard"]["degraded"] > \
        base["classes"]["standard"]["degraded"]
    assert any(json.loads(line)["rule"].startswith(("burn_rate", "latency"))
               for line in act_log.splitlines())


@pytest.mark.parametrize("mode", ["observe", "actuate"])
def test_alert_log_byte_identical_with_reference(mode):
    """The trickle-burst sim of tests/test_health.py through both packages:
    the alert logs are the same bytes and the reports equal dicts, so the
    port's rules, monitor, router and scheduler make every decision the
    reference makes."""
    arrivals = _trickle_burst_arrivals(seed=0, cycles=6)
    rep, log, health = _run_health_sim(arrivals, mode)
    jrep, jlog, jhealth = _run_health_sim(arrivals, mode, port=False)
    assert log != "" and log == jlog
    assert rep == jrep
    assert health.summary() == jhealth.summary()


# ---------------------------------------------------------------------------
# bundles across the two packages
# ---------------------------------------------------------------------------


def _bundle_session(pkg_obs, obs_runtime, clock, bundle_dir):
    """The same incident in either package: a recorder, a trace instant,
    a bitwise mismatch, one tick that fires and dumps a bundle."""
    ob = obs_runtime.instrument(clock=clock)
    rec = pkg_obs.FlightRecorder(events_capacity=64)
    rec.attach(ob.trace)
    hm = pkg_obs.HealthMonitor(ob, rules=[pkg_obs.BitExactSentinel()],
                               recorder=rec, bundle_dir=bundle_dir)
    hm.attach_server("primary", _FakeSched())
    hm.census_extra["arch"] = "resnet8"
    ob.trace.instant("warm", cat="test", track="t", t=0.1)
    ob.metrics.counter("ab_mismatch_total", "m").inc(shadow="int")
    clock.advance(0.5)
    hm.tick(0.5)
    obs_runtime.disable()
    assert len(hm.bundles) == 1
    return hm.bundles[0]


def test_bundles_cross_read_between_packages(tmp_path):
    """A bundle written by the port's ``write_bundle`` parses with the
    reference's ``read_bundle`` and one written by the reference parses
    with the port's; the two parse to equal content (the manifests hold
    no path)."""
    import repro_torch.obs as PO

    ours = _bundle_session(PO, obsrt, FakeClock(), str(tmp_path / "port"))
    theirs = _bundle_session(JO, jobsrt, JFakeClock(),
                             str(tmp_path / "ref"))
    by_ref, by_port = JO.read_bundle(ours), read_bundle(theirs)
    assert by_ref["manifest"] == by_port["manifest"]
    assert by_ref["manifest"]["reason"] == "alert:bit_exact"
    for key in ("alerts", "metrics", "deltas", "trace_events"):
        assert by_ref[key] == by_port[key], key
    for name in ("manifest.json", "alerts.jsonl", "metrics.txt",
                 "deltas.jsonl", "trace.json"):
        assert (tmp_path / "port" / "bundle_000_alert-bit_exact" /
                name).read_bytes() == (
            tmp_path / "ref" / "bundle_000_alert-bit_exact" /
            name).read_bytes(), name


def test_write_bundle_without_recorder_takes_the_session_trace(tmp_path):
    ob, clock = _session()
    ob.trace.span("s", cat="c", track="t", t0=0.0, t1=0.25)
    path = write_bundle(str(tmp_path), ob, reason="manual dump", now=0.5,
                        seq=3)
    assert path.endswith("bundle_003_manual-dump")
    b = read_bundle(path)
    assert b["manifest"]["recorder"] is None and b["deltas"] == []
    assert [e["name"] for e in b["trace_events"] if e.get("ph") == "X"] \
        == ["s"]
