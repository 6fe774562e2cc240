"""``repro_torch.traffic`` on the CPU: the cases of tests/test_traffic.py
and the traffic-CLI cases of tests/test_obs.py against the port, then the
port held against the JAX package's ``repro.traffic`` in one process.

Held against the reference, same seed and same inputs:

* ``make_process`` gives the same arrivals for every pattern, and a trace
  saved by either package loads in the other;
* the no-model simulation (bursty 2,400/s, autoscaling 1..4 replicas,
  ResNet8 as the degrade variant, the paper's FPGA service model) reports
  the same totals, classes, servers and autoscaler decisions;
* the simulation with real ResNet8 models (weights drawn by the JAX
  package and carried over with ``params_from_numpy``) routes every
  request the same way, and the port's ``torch-int`` logits are within
  1e-5 of the reference's ``lax-int`` logits with equal argmax — and
  bitwise those of the port's ``ShardedResNetEngine`` on the CPU.

Everything runs on ``device="cpu"``, where the kernels run their plain
versions; without a GPU the CLIs' default ``cuda`` device raises.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from repro.compile import compile_model as jax_compile_model
from repro.models import resnet as JR
from repro.serve.sched import FakeClock as JFakeClock
from repro import traffic as JT
from repro.traffic.__main__ import main as jax_traffic_main
from repro_torch.compile import compile_model, params_from_numpy
from repro_torch.models import resnet as R
from repro_torch.obs import metrics as M
from repro_torch.obs import runtime as obsrt
from repro_torch.obs import trace as T
from repro_torch.serve import (DrainResult, FakeClock, ImageRequest,
                               ResNetEngine, ShardedResNetEngine)
from repro_torch.serve import sched as S
from repro_torch.traffic import (
    DEFAULT_CLASSES, DROP, Arrival, AutoscaleConfig, Autoscaler,
    DiurnalProcess, LiveTrafficRunner, OnOffProcess, OverloadRouter,
    PoissonProcess, ServerSignals, ServiceModel, SimServer, SLOClass,
    TraceReplay, TrafficSim, effective_accuracy, load_trace, make_process,
    parse_classes, save_trace)
from repro_torch.traffic.__main__ import main as traffic_main

MIX = {"interactive": 0.25, "standard": 0.5, "bulk": 0.25}
LOGIT_ATOL = 1e-5   # float32 classifier, summed in another order
CPU = ["cpu"]


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
    from repro.obs import runtime as jobsrt

    prior, jprior = obsrt.disable(), jobsrt.disable()
    yield
    obsrt.install(prior)
    jobsrt.install(jprior)


def _jax_qparams(cfg, seed):
    return JR.quantize_params(JR.fold_params(JR.init_params(
        cfg, jax.random.PRNGKey(seed))), cfg)


@pytest.fixture(scope="module")
def resnet8_qparams():
    """ResNet8 weights drawn by the JAX package from ``PRNGKey(0)`` and
    ``PRNGKey(1)``: (jax qparams, port qparams) for each."""
    out = []
    for seed in (0, 1):
        jqp = _jax_qparams(JR.RESNET8, seed)
        out.append((jqp, params_from_numpy(jqp)))
    return out


# ---------------------------------------------------------------------------
# loadgen — determinism + trace round-trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["poisson", "bursty", "diurnal"])
def test_generators_deterministic_per_seed(pattern):
    a = make_process(pattern, 500.0, seed=7, class_mix=MIX,
                     period_s=0.2).generate(horizon_s=0.25)
    b = make_process(pattern, 500.0, seed=7, class_mix=MIX,
                     period_s=0.2).generate(horizon_s=0.25)
    c = make_process(pattern, 500.0, seed=8, class_mix=MIX,
                     period_s=0.2).generate(horizon_s=0.25)
    assert a and a == b
    assert a != c
    assert all(x.t <= y.t for x, y in zip(a, a[1:]))
    assert {x.slo for x in a} <= set(MIX)


def test_generate_bounds():
    p = PoissonProcess(1000.0, seed=0, class_mix=MIX)
    assert len(p.generate(n=32)) == 32
    with pytest.raises(ValueError):
        p.generate()
    assert all(a.t < 0.05 for a in p.generate(horizon_s=0.05))


def test_onoff_concentrates_rate():
    bursty = OnOffProcess(2000.0, mean_on_s=0.05, mean_off_s=0.05, seed=1,
                          class_mix=MIX).generate(horizon_s=1.0)
    gaps = np.diff([a.t for a in bursty])
    assert np.min(gaps) < 1.0 / 1500.0
    assert np.max(gaps) > 0.01


def test_diurnal_validates():
    with pytest.raises(ValueError):
        DiurnalProcess(500.0, 100.0)


def test_trace_roundtrip(tmp_path):
    arrivals = PoissonProcess(800.0, seed=3, class_mix=MIX).generate(n=64)
    path = str(tmp_path / "trace.json")
    save_trace(path, arrivals, meta={"pattern": "poisson", "seed": 3})
    assert load_trace(path) == arrivals
    assert TraceReplay.from_file(path).generate(n=10) == arrivals[:10]
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and doc["meta"]["pattern"] == "poisson"


def test_arrival_dict_roundtrip():
    a = Arrival(t=0.125, slo="standard", source=2)
    assert Arrival.from_dict(a.to_dict()) == a


def _as_tuples(arrivals):
    return [(a.t, a.slo, a.source) for a in arrivals]


@pytest.mark.parametrize("pattern", ["poisson", "bursty", "diurnal"])
def test_arrivals_equal_the_reference_per_seed(pattern):
    """The same numpy draws in the same order: every arrival time and class
    equal to the reference's, float for float."""
    for seed in (0, 5):
        ours = make_process(pattern, 2400.0, seed=seed, class_mix=MIX,
                            period_s=0.3, burst_on_s=0.05,
                            burst_off_s=0.05).generate(horizon_s=0.5)
        theirs = JT.make_process(pattern, 2400.0, seed=seed, class_mix=MIX,
                                 period_s=0.3, burst_on_s=0.05,
                                 burst_off_s=0.05).generate(horizon_s=0.5)
        assert len(ours) > 100
        assert _as_tuples(ours) == _as_tuples(theirs)


def test_trace_files_load_across_packages(tmp_path):
    arrivals = make_process("bursty", 1200.0, seed=2,
                            class_mix=MIX).generate(horizon_s=0.2)
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    save_trace(ours, arrivals, meta={"seed": 2})
    JT.save_trace(theirs, JT.load_trace(ours), meta={"seed": 2})
    assert _as_tuples(JT.load_trace(ours)) == _as_tuples(arrivals)
    assert load_trace(theirs) == arrivals
    with open(ours) as f, open(theirs) as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# slo — class parsing + accounting
# ---------------------------------------------------------------------------


def test_parse_classes_inline_and_default():
    assert parse_classes(None) == list(DEFAULT_CLASSES)
    got = parse_classes("gold:10:0:strict,best_effort:100:3:drop")
    assert got == [SLOClass("gold", 10.0, 0, "strict"),
                   SLOClass("best_effort", 100.0, 3, "drop")]
    with pytest.raises(ValueError):
        parse_classes("dup:10:0,dup:20:1")
    with pytest.raises(ValueError):
        parse_classes("nofields")


def test_parse_classes_json_file(tmp_path):
    path = tmp_path / "classes.json"
    path.write_text(json.dumps([c.to_dict() for c in DEFAULT_CLASSES]))
    assert parse_classes(str(path)) == list(DEFAULT_CLASSES)


def test_slo_class_validation():
    with pytest.raises(ValueError):
        SLOClass("x", deadline_ms=0.0, priority=0)
    with pytest.raises(ValueError):
        SLOClass("x", deadline_ms=10.0, priority=0, policy="retry")


# ---------------------------------------------------------------------------
# serve.sched extensions (per-priority stats, DrainResult, set_active)
# ---------------------------------------------------------------------------


def _run_through(sched, n, priority=0, deadline_in=None, advance=0.0):
    clock = sched.clock
    reqs = [sched.submit(i, priority=priority, deadline_in=deadline_in)
            for i in range(n)]
    if advance:
        clock.advance(advance)
    while sched.pending:
        d = sched.poll(sched.clock.now())
        if d is None:
            clock.advance(1.0)
            continue
        sched.complete(d)
    return reqs


def test_latency_stats_by_priority_breakdown():
    clock = FakeClock()
    sched = S.Scheduler(1, max_batch=4, slack_s=0.0, clock=clock)
    _run_through(sched, 3, priority=0, deadline_in=10.0)
    _run_through(sched, 2, priority=2, deadline_in=10.0)
    summ = sched.stats.summary()
    assert summ["count"] == 5 and summ["deadline_total"] == 5
    assert set(summ) >= {"count", "queue_wait_ms", "compute_ms",
                         "deadline_misses", "deadline_total", "failed"}
    by = summ["by_priority"]
    assert set(by) == {0, 2}
    assert by[0]["count"] == 3 and by[2]["count"] == 2
    assert by[2]["deadline_total"] == 2 and by[2]["deadline_misses"] == 0


def test_drain_result_reports_missed_deadlines():
    clock = FakeClock()
    sched = S.Scheduler(1, max_batch=2, slack_s=50.0, clock=clock)
    sched.submit("late", deadline_in=0.5)
    sched.submit("fine", deadline_in=100.0)
    clock.advance(1.0)
    done = []
    res = sched.drain(lambda d: (done.append(len(d)), sched.complete(d)))
    assert isinstance(res, int) and res == len(done)
    assert isinstance(res, DrainResult)
    assert res.missed_deadline == 1
    assert sched.summary()["drained_missed_deadline"] == 1


def test_set_active_restricts_dispatch_prefix():
    clock = FakeClock()
    sched = S.Scheduler(3, max_batch=1, slack_s=0.0, clock=clock)
    assert sched.set_active(1) == 1
    for i in range(4):
        sched.submit(i)
        d = sched.poll(clock.now())
        assert d.replica.index == 0
        sched.complete(d)
    assert sched.set_active(99) == 3
    assert sched.set_active(0) == 1
    assert sched.summary()["active_replicas"] == 1


# ---------------------------------------------------------------------------
# autoscale — hysteresis + cooldown under FakeClock
# ---------------------------------------------------------------------------


def test_autoscaler_scales_up_on_sustained_util():
    clock = FakeClock()
    a = Autoscaler(AutoscaleConfig(max_replicas=4, cooldown_s=0.1),
                   clock=clock)
    assert a.observe(busy=1, queue_depth=0) == 1
    assert a.observe(busy=1, queue_depth=0) == 1
    clock.advance(0.2)
    assert a.observe(busy=1, queue_depth=0) == 2
    assert a.decisions[-1].reason == "util-high"


def test_autoscaler_queue_pressure_scales_up_immediately():
    clock = FakeClock()
    a = Autoscaler(AutoscaleConfig(max_replicas=4, queue_high=2.0),
                   clock=clock)
    assert a.observe(busy=0, queue_depth=16, slots_per_replica=8) == 2
    assert a.decisions[-1].reason == "queue"


def test_autoscaler_cooldown_blocks_consecutive_actions():
    clock = FakeClock()
    a = Autoscaler(AutoscaleConfig(max_replicas=4, cooldown_s=0.25),
                   clock=clock)
    assert a.observe(busy=0, queue_depth=99, slots_per_replica=1) == 2
    clock.advance(0.1)
    assert a.observe(busy=2, queue_depth=99, slots_per_replica=1) == 2
    clock.advance(0.25)
    assert a.observe(busy=2, queue_depth=99, slots_per_replica=1) == 3
    assert len(a.decisions) == 2


def test_autoscaler_hysteresis_dead_band_and_scale_down():
    clock = FakeClock()
    a = Autoscaler(AutoscaleConfig(max_replicas=4, cooldown_s=0.0,
                                   high_util=0.75, low_util=0.25),
                   clock=clock, active=2)
    assert a.observe(busy=1, queue_depth=0) == 2
    for _ in range(8):
        assert a.observe(busy=0, queue_depth=3) == 2
    assert a.observe(busy=0, queue_depth=0) == 1
    assert a.decisions[-1].reason == "util-low"
    for _ in range(4):
        assert a.observe(busy=0, queue_depth=0) == 1


def test_autoscale_config_validation():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscaleConfig(low_util=0.8, high_util=0.5)


# ---------------------------------------------------------------------------
# degrade — routing policy + accuracy accounting
# ---------------------------------------------------------------------------

BUSY = ServerSignals(outstanding=300, active=1, max_batch=8,
                     service_estimate_s=0.01)
FREE = ServerSignals(outstanding=0, active=1, max_batch=8,
                     service_estimate_s=0.001)
COLD = ServerSignals(outstanding=100, active=1, max_batch=8,
                     service_estimate_s=0.0)


def _router(enabled=True):
    return OverloadRouter(DEFAULT_CLASSES, primary="big", degraded="small",
                          enabled=enabled)


def test_router_not_overloaded_goes_primary():
    r = _router()
    for name in ("interactive", "standard", "bulk"):
        d = r.route(name, {"big": FREE, "small": FREE})
        assert d.target == "big" and not d.degraded and not d.dropped


def test_router_cold_estimate_never_overloads():
    d = _router().route("standard", {"big": COLD, "small": FREE})
    assert d.target == "big" and not d.overloaded


def test_router_overload_policies():
    r = _router()
    strict = r.route("interactive", {"big": BUSY, "small": FREE})
    assert strict.target == "big" and strict.overloaded \
        and not strict.degraded
    deg = r.route("standard", {"big": BUSY, "small": FREE})
    assert deg.target == "small" and deg.degraded
    drop = r.route("bulk", {"big": BUSY, "small": FREE})
    assert drop.target == DROP and drop.dropped


def test_router_wont_degrade_into_a_swamped_variant():
    d = _router().route("standard", {"big": BUSY, "small": BUSY})
    assert d.target == "big" and not d.degraded
    d = _router(enabled=False).route("standard", {"big": BUSY, "small": FREE})
    assert d.target == "big" and not d.degraded


def test_effective_accuracy_accounts_drops():
    out = effective_accuracy({"a": 2, "b": 2}, dropped=4,
                             accuracy_by_variant={"a": 0.8, "b": 0.6},
                             primary="a")
    assert out["effective_top1"] == pytest.approx(0.35)
    assert out["accuracy_cost"] == pytest.approx(0.45)
    with pytest.raises(ValueError):
        effective_accuracy({"c": 1}, 0, {"a": 0.8}, "a")


# ---------------------------------------------------------------------------
# the virtual-time simulator — acceptance pins
# ---------------------------------------------------------------------------


def _overload_sim(enabled, autoscale=False, replicas=1):
    clock = FakeClock()
    servers = {
        "resnet20": SimServer("resnet20", ServiceModel.from_fps(800.0),
                              clock, replicas=replicas, max_batch=8,
                              active=1 if autoscale else None),
        "resnet8": SimServer("resnet8", ServiceModel.from_fps(3200.0),
                             clock, replicas=1, max_batch=8)}
    router = OverloadRouter(DEFAULT_CLASSES, primary="resnet20",
                            degraded="resnet8", enabled=enabled)
    scaler = Autoscaler(AutoscaleConfig(max_replicas=replicas,
                                        cooldown_s=0.02),
                        clock=clock) if autoscale else None
    sim = TrafficSim(servers, DEFAULT_CLASSES, router, clock,
                     autoscaler=scaler)
    arrivals = make_process("bursty", 2400.0, seed=3, class_mix=MIX,
                            burst_on_s=0.05, burst_off_s=0.05
                            ).generate(horizon_s=0.3)
    report = sim.run(arrivals, accuracy_by_variant={"resnet20": 0.913,
                                                    "resnet8": 0.887})
    return sim, report


def test_degradation_strictly_improves_low_priority_hit_rate():
    _, off = _overload_sim(enabled=False)
    _, on = _overload_sim(enabled=True)
    assert on["totals"]["submitted"] == off["totals"]["submitted"]
    assert on["classes"]["standard"]["deadline_hit_rate"] > \
        off["classes"]["standard"]["deadline_hit_rate"]
    assert on["totals"]["degraded"] > 0
    acc = on["accuracy"]
    assert acc["effective_top1"] < acc["primary_top1"]
    assert acc["accuracy_cost"] == pytest.approx(
        acc["primary_top1"] - acc["effective_top1"])
    assert off["accuracy"]["accuracy_cost"] == 0.0
    assert off["totals"]["degraded"] == off["totals"]["dropped"] == 0
    json.dumps(on)


def test_high_priority_class_is_never_degraded_or_dropped():
    sim, on = _overload_sim(enabled=True)
    cls = on["classes"]["interactive"]
    assert cls["degraded"] == 0 and cls["dropped"] == 0
    assert all(r.variant == "resnet20" for r in sim.requests
               if r.slo == "interactive" and r.done)


def test_autoscaler_reacts_in_sim():
    _, rep = _overload_sim(enabled=False, autoscale=True, replicas=4)
    auto = rep["autoscaler"]
    assert auto["scale_events"] >= 1
    assert auto["decisions"][0]["from_replicas"] == 1
    assert all(1 <= d["to_replicas"] <= 4 for d in auto["decisions"])
    _, fixed = _overload_sim(enabled=False, replicas=1)
    assert rep["totals"]["deadline_hit_rate"] > \
        fixed["totals"]["deadline_hit_rate"]


def test_sim_rejects_unknown_classes():
    clock = FakeClock()
    server = SimServer("m", ServiceModel.from_fps(1000.0), clock)
    sim = TrafficSim({"m": server}, DEFAULT_CLASSES,
                     OverloadRouter(DEFAULT_CLASSES, primary="m"), clock)
    with pytest.raises(ValueError):
        sim.run([Arrival(t=0.0, slo="nonexistent")])


def test_sim_logits_bit_exact_with_sharded_engine(resnet8_qparams):
    """One replica, no overload: the simulator serving a real compiled model
    gives logits bitwise those of ShardedResNetEngine on the same images —
    the traffic control plane cannot perturb the arithmetic."""
    cfg = R.RESNET8
    qp = resnet8_qparams[0][1]
    batch, n = 4, 12
    rng = np.random.default_rng(0)
    images = rng.random((n, cfg.img, cfg.img, 3)).astype(np.float32)

    cm = compile_model(cfg, qp, backend="torch-int", batch_sizes=(batch,),
                       device="cpu")
    classes = [SLOClass("standard", deadline_ms=1000.0, priority=1,
                        policy="degrade")]
    clock = FakeClock()
    server = SimServer("resnet8", ServiceModel.from_fps(30153.0), clock,
                       replicas=1, max_batch=batch, model=cm)
    sim = TrafficSim({"resnet8": server}, classes,
                     OverloadRouter(classes, primary="resnet8"), clock)
    arrivals = PoissonProcess(100.0, seed=1,
                              class_mix={"standard": 1.0}).generate(n=n)
    rep = sim.run(arrivals, images=images, labels=np.zeros(n, np.int64))
    assert rep["totals"]["served"] == n
    assert rep["totals"]["dropped"] == rep["totals"]["degraded"] == 0
    assert all(r.done and r.logits is not None for r in sim.requests)

    eng = ShardedResNetEngine(cfg, qp, batch=batch, backend="torch-int",
                              devices=CPU)
    assert eng.active_replicas == 1 and eng.queue_depth == 0
    assert eng.set_active_replicas(99) == 1
    reqs = [ImageRequest(rid=i, image=images[i]) for i in range(n)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for i, r in enumerate(reqs):
        assert np.array_equal(r.logits, sim.requests[i].logits), \
            f"request {i}: sim logits diverge from the engine"


# ---------------------------------------------------------------------------
# the simulator against the reference's
# ---------------------------------------------------------------------------

_NO_MODEL_ARGV = ["sim", "--no-model", "--arch", "resnet20",
                  "--degrade-arch", "resnet8", "--pattern", "bursty",
                  "--rate", "2400", "--duration", "0.5", "--autoscale",
                  "--replicas", "4", "--seed", "0"]


def test_no_model_sim_report_equals_the_reference(capsys):
    """The CLI's no-model simulation (the three default classes, bursty at
    2,400/s for 0.5 s, autoscaling 1..4 replicas, ResNet8 as the degrade
    variant, the paper's FPGA service model): the same report as the
    reference's, decision for decision."""
    ours = traffic_main(_NO_MODEL_ARGV)
    theirs = jax_traffic_main(_NO_MODEL_ARGV)
    capsys.readouterr()
    assert ours["totals"]["submitted"] > 500
    assert ours["autoscaler"]["scale_events"] >= 1
    assert ours == theirs
    for name in ("totals", "classes", "servers", "autoscaler"):
        assert ours[name] == theirs[name], name


def _real_model_sims(resnet8_qparams, n=48, batch=4):
    """Both packages' simulators over the same bursty overload with real
    ResNet8 models: the primary from ``PRNGKey(0)``, the degrade variant
    from ``PRNGKey(1)``, served at modeled speeds (100 and 2,000 images/s
    a replica) that force degrading and dropping."""
    cfg = R.RESNET8
    rng = np.random.default_rng(4)
    images = rng.random((n, cfg.img, cfg.img, 3)).astype(np.float32)
    labels = rng.integers(0, 10, n)
    arrivals = make_process("bursty", 6000.0, seed=4, class_mix=MIX,
                            burst_on_s=0.01, burst_off_s=0.01
                            ).generate(n=n)
    out = {}
    for port in (True, False):
        if port:
            pkg, Clock = (__import__("repro_torch.traffic").traffic,
                          FakeClock)
            models = {name: compile_model(cfg, qp, backend="torch-int",
                                          batch_sizes=(batch,),
                                          device="cpu")
                      for name, (_, qp) in zip(("big", "small"),
                                               resnet8_qparams)}
            arr = arrivals
        else:
            pkg, Clock = JT, JFakeClock
            models = {name: jax_compile_model(JR.RESNET8, jqp,
                                              backend="lax-int",
                                              batch_sizes=(batch,))
                      for name, (jqp, _) in zip(("big", "small"),
                                                resnet8_qparams)}
            arr = [JT.Arrival(t=a.t, slo=a.slo) for a in arrivals]
        clock = Clock()
        servers = {
            "big": pkg.SimServer("big", pkg.ServiceModel.from_fps(100.0),
                                 clock, replicas=1, max_batch=batch,
                                 model=models["big"]),
            "small": pkg.SimServer("small",
                                   pkg.ServiceModel.from_fps(2000.0),
                                   clock, replicas=1, max_batch=batch,
                                   model=models["small"])}
        router = pkg.OverloadRouter(pkg.DEFAULT_CLASSES, primary="big",
                                    degraded="small")
        sim = pkg.TrafficSim(servers, pkg.DEFAULT_CLASSES, router, clock)
        rep = sim.run(arr, images=images, labels=labels)
        out[port] = (sim, rep)
    return images, out[True], out[False]


def test_sim_with_real_models_matches_the_reference(resnet8_qparams):
    """Request by request: the same variant, degrade and drop decisions as
    the reference, the port's ``torch-int`` logits within 1e-5 of the
    reference's ``lax-int`` logits with equal argmax, and the same
    report."""
    _, (sim, rep), (jsim, jrep) = _real_model_sims(resnet8_qparams)
    assert rep["totals"]["degraded"] > 0 and rep["totals"]["dropped"] > 0
    assert rep == jrep
    assert len(sim.requests) == len(jsim.requests)
    served = 0
    for r, j in zip(sim.requests, jsim.requests):
        assert (r.rid, r.slo, r.variant, r.degraded, r.done, r.pred) == \
            (j.rid, j.slo, j.variant, j.degraded, j.done, j.pred)
        if r.logits is None:
            assert j.logits is None
            continue
        served += 1
        np.testing.assert_allclose(r.logits, np.asarray(j.logits), rtol=0,
                                   atol=LOGIT_ATOL)
    assert served == rep["totals"]["served"] > 0


def test_sim_with_real_models_is_bitwise_the_sharded_engine(
        resnet8_qparams):
    """Every logit the port's simulator served is bitwise what the port's
    ``ShardedResNetEngine`` (``torch-int``, a CPU pool of two replicas)
    gives for the same variant and image."""
    images, (sim, _), _ = _real_model_sims(resnet8_qparams)
    for name, (_, qp) in zip(("big", "small"), resnet8_qparams):
        eng = ShardedResNetEngine(R.RESNET8, qp, batch=4,
                                  backend="torch-int", devices=CPU * 2,
                                  batch_sizes=(1, 4))
        mine = [r for r in sim.requests if r.variant == name]
        assert mine
        reqs = [ImageRequest(rid=r.rid, image=images[r.rid % len(images)])
                for r in mine]
        for q in reqs:
            eng.submit(q)
        eng.run()
        for r, q in zip(mine, reqs):
            assert np.array_equal(r.logits, q.logits), (name, r.rid)


def test_obs_off_serving_is_bit_identical(resnet8_qparams):
    """Instrumentation must not perturb the arithmetic: the same seeded sim
    serving a real compiled model yields bitwise the same logits with an
    obs session installed and without one."""
    cfg = R.RESNET8
    cm = compile_model(cfg, resnet8_qparams[0][1], backend="torch-int",
                       batch_sizes=(4,), device="cpu")
    rng = np.random.default_rng(0)
    images = rng.random((12, cfg.img, cfg.img, 3)).astype(np.float32)
    classes = [SLOClass("standard", deadline_ms=1000.0, priority=1,
                        policy="degrade")]
    arrivals = PoissonProcess(200.0, seed=1,
                              class_mix={"standard": 1.0}).generate(n=12)

    def serve(instrumented):
        clock = FakeClock()
        if instrumented:
            obsrt.instrument(clock=clock)
        try:
            server = SimServer("resnet8", ServiceModel.from_fps(3200.0),
                               clock, replicas=1, max_batch=4, model=cm)
            sim = TrafficSim({"resnet8": server}, classes,
                             OverloadRouter(classes, primary="resnet8"),
                             clock)
            sim.run(arrivals, images=images)
            return np.stack([r.logits for r in sim.requests])
        finally:
            if instrumented:
                obsrt.disable()

    off, on = serve(False), serve(True)
    assert np.array_equal(off, on)


# ---------------------------------------------------------------------------
# the live runner over ShardedResNetEngine (CPU replicas)
# ---------------------------------------------------------------------------


def test_live_runner_over_sharded_engines_accounts_and_is_bitwise(
        resnet8_qparams):
    """The live control plane on the wall clock: a Poisson trace through
    two ``ShardedResNetEngine`` variants on CPU replicas, with a health
    monitor on the session.  Accounting adds up per class, every served
    request's logits are bitwise ``ResNetEngine``'s on its variant and
    image, and the registry's ``slo_*`` counters equal the report."""
    from repro_torch.obs import HealthMonitor, default_rules

    cfg = R.RESNET8
    rng = np.random.default_rng(2)
    images = rng.random((16, cfg.img, cfg.img, 3)).astype(np.float32)
    variants = {name: ShardedResNetEngine(
        cfg, qp, batch=4, backend="torch-int", devices=CPU,
        batch_sizes=(1, 4), slack_ms=1.0)
        for name, (_, qp) in zip(("big", "small"), resnet8_qparams)}
    classes = parse_classes("interactive:2000:0:strict,"
                            "standard:2000:1:degrade,bulk:2000:2:drop")
    ob = obsrt.instrument()
    health = HealthMonitor(ob, rules=default_rules(
        [c.name for c in classes]), interval_s=0.01)
    ob.health = health
    runner = LiveTrafficRunner(
        variants, classes, OverloadRouter(classes, "big", degraded="small"),
        autoscaler=Autoscaler(AutoscaleConfig(max_replicas=1),
                              clock=variants["big"].clock), health=health)
    arrivals = PoissonProcess(400.0, seed=3, class_mix=MIX).generate(n=24)
    try:
        rep = runner.run(arrivals, images)
    finally:
        obsrt.disable()
    t = rep["totals"]
    assert t["submitted"] == 24 == t["served"] + t["dropped"]
    for name, c in rep["classes"].items():
        assert c["submitted"] == c["count"] + c["dropped"], name
    assert rep["health"]["ticks"] > 0
    counted = ob.metrics.counter("slo_submitted_total", "")
    assert sum(counted.value(cls=c.name) for c in classes) == 24
    served = ob.metrics.counter("slo_served_total", "")
    assert sum(v for _, v in served.labelled()) == t["served"]
    for name, (_, qp) in zip(("big", "small"), resnet8_qparams):
        plain = ResNetEngine(cfg, qp, batch=4, backend="torch-int",
                             device="cpu")
        mine = [tr for tr in runner.tracked if tr.variant == name]
        for tr in mine:
            ref = ImageRequest(rid=tr.req.rid, image=tr.req.image)
            plain.submit(ref)
            plain.run()
            assert np.array_equal(tr.req.logits, ref.logits)


# ---------------------------------------------------------------------------
# the CLI: sim with trace export, live, no fallback without a GPU
# ---------------------------------------------------------------------------

_TRAFFIC_ARGV = [
    "sim", "--device", "cpu", "--backend", "torch-int", "--arch", "resnet8",
    "--degrade-arch", "", "--pattern", "bursty", "--rate", "600",
    "--duration", "0.1", "--fps-primary", "3200", "--replicas", "2",
    "--eval-n", "8", "--batch", "4", "--seed", "0",
]


def _run_traffic(tmp_path, tag, profile=True):
    d = tmp_path / tag
    d.mkdir()
    argv = _TRAFFIC_ARGV + [
        "--trace-out", str(d / "trace.json"),
        "--jsonl-out", str(d / "trace.jsonl"),
        "--metrics-out", str(d / "metrics.txt"),
    ] + ([] if profile else ["--no-profile"])
    report = traffic_main(argv)
    return d, report


def _stripped_jsonl(path):
    out = []
    for line in path.read_text().splitlines():
        d = json.loads(line)
        if d.get("cat") in T.VOLATILE_CATS:
            d["ts"] = d["dur"] = 0.0
        args = {k: v for k, v in d.get("args", {}).items()
                if k not in T.VOLATILE_ARGS}
        d.pop("args", None)
        if args:
            d["args"] = args
        out.append(json.dumps(d, sort_keys=True))
    return "\n".join(out)


def _stripped_chrome(path):
    events = copy.deepcopy(json.loads(path.read_text())["traceEvents"])
    for e in events:
        if e.get("cat") in T.VOLATILE_CATS:
            e["ts"] = 0.0
            e.pop("dur", None)
        if "args" in e and e["ph"] != "M":
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in T.VOLATILE_ARGS}
    return json.dumps(events, sort_keys=True)


def test_traffic_cli_exports_trace_with_kernel_profiles(tmp_path, capsys):
    """A seeded sim run with --trace-out produces a Chrome trace carrying
    per-request spans and per-task kernel profiles (the plain versions'
    times on the CPU) with modeled HBM bytes."""
    from repro_torch.obs.__main__ import load_chrome_trace

    d, report = _run_traffic(tmp_path, "a")
    capsys.readouterr()
    events = load_chrome_trace(str(d / "trace.json"))
    names = {e.get("name") for e in events}
    assert {"queue_wait", "compute", "coalesce_hold"} <= names
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "no kernel-profile spans in the trace"
    for e in kernels:
        assert e["args"]["hbm_modeled_bytes"] > 0
        assert e["args"]["vs_roofline"] > 0
    assert report["obs"]["profiles"]
    assert {p["kind"] for p in report["obs"]["profiles"]} == \
        {"stem", "block"}
    assert obsrt.active() is None
    parsed = M.parse_text((d / "metrics.txt").read_text())
    assert "sched_served_total" in parsed
    assert "kernel_hbm_modeled_bytes" in parsed


def test_traffic_cli_trace_determinism_across_runs(tmp_path, capsys):
    """Same seed + FakeClock => byte-identical metrics, and byte-identical
    JSONL/Chrome traces modulo the documented volatile fields."""
    d1, _ = _run_traffic(tmp_path, "r1")
    d2, _ = _run_traffic(tmp_path, "r2")
    capsys.readouterr()
    assert (d1 / "metrics.txt").read_bytes() == \
        (d2 / "metrics.txt").read_bytes()
    assert _stripped_jsonl(d1 / "trace.jsonl") == \
        _stripped_jsonl(d2 / "trace.jsonl")
    assert _stripped_chrome(d1 / "trace.json") == \
        _stripped_chrome(d2 / "trace.json")


def test_traffic_cli_alerts_and_bundles(tmp_path, capsys):
    """``--alerts --bundle-dir --health-actuate`` on an overloaded sim:
    the alert log lands in the bundle dir and beside the metrics, parses
    through the report CLI's validator, and every bundle reads back."""
    from repro_torch.obs import read_bundle
    from repro_torch.obs.__main__ import load_alerts

    argv = ["sim", "--no-model", "--arch", "resnet20", "--degrade-arch",
            "resnet8", "--rate", "4000", "--duration", "0.5",
            "--fps-primary", "800", "--fps-degraded", "3200", "--seed", "1",
            "--alerts", "--health-actuate", "--health-interval-ms", "10",
            "--bundle-dir", str(tmp_path / "b"), "--metrics-out",
            str(tmp_path / "m.txt")]
    report = traffic_main(argv)
    capsys.readouterr()
    h = report["health"]
    assert h["alerts"] > 0 and h["bundles"]
    alerts = load_alerts(str(tmp_path / "b" / "alerts.jsonl"))
    assert len(alerts) == h["alerts"]
    assert load_alerts(str(tmp_path / "m.alerts.jsonl")) == alerts
    for b in h["bundles"]:
        assert read_bundle(b)["manifest"]["census"]["arch"] == "resnet20"


def test_traffic_cli_live_mode_on_cpu_replicas(capsys):
    report = traffic_main(["live", "--device", "cpu", "--backend",
                           "torch-int", "--arch", "resnet8",
                           "--degrade-arch", "", "--replicas", "2",
                           "--rate", "400", "--requests", "16",
                           "--eval-n", "8", "--batch", "4", "--seed", "0",
                           "--autoscale"])
    out = capsys.readouterr().out
    assert "traffic report" in out
    assert report["mode"] == "live"
    assert report["totals"]["submitted"] == 16
    assert report["totals"]["served"] + report["totals"]["dropped"] == 16
    assert len(report["servers"]["resnet8"]["replicas"]) == 2
    assert "measured_accuracy" in report and "accuracy" in report


@pytest.mark.parametrize("mode", ["sim", "live"])
def test_traffic_cli_raises_without_a_gpu(mode, monkeypatch, capsys):
    """The default device is ``cuda``: without one the CLI raises, in both
    modes, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic_main([mode, "--arch", "resnet8", "--degrade-arch", "",
                      "--requests", "4", "--eval-n", "0"])
    capsys.readouterr()


def test_launch_serve_traffic_flags_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` on the SLO path: classes,
    autoscaling, a degrade variant, alerts, bundles and metrics; every
    artifact parses and the accounting adds up."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs.__main__ import load_alerts

    report = launch_serve.main([
        "--arch", "resnet8", "--device", "cpu", "--backend", "torch-int",
        "--replicas", "2", "--batch", "4", "--requests", "24",
        "--arrival-rate", "400", "--slo-classes",
        "interactive:25:0:strict,standard:50:1:degrade,bulk:200:2:drop",
        "--degrade-arch", "resnet20", "--autoscale", "--health-actuate",
        "--bundle-dir", str(tmp_path / "b"), "--metrics-out",
        str(tmp_path / "m.txt"), "--trace-out", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "served trace of 24 arrivals" in out and "health: " in out
    t = report["totals"]
    assert t["submitted"] == 24 == t["served"] + t["dropped"]
    assert set(report["servers"]) == {"resnet8", "resnet20"}
    assert report["autoscaler"]["active"] >= 1
    assert load_alerts(str(tmp_path / "b" / "alerts.jsonl")) == \
        load_alerts(str(tmp_path / "m.alerts.jsonl"))
    parsed = M.parse_text((tmp_path / "m.txt").read_text())
    assert "slo_submitted_total" in parsed and "sched_served_total" in parsed
    from repro_torch.obs.__main__ import load_chrome_trace
    assert load_chrome_trace(str(tmp_path / "t.json"))
    assert obsrt.active() is None


@pytest.mark.parametrize("device,replicas,want", [
    ("cpu", 3, (["cpu"] * 3, 3)), ("cpu", 0, ([], 1)),
    ("cuda", 4, (None, 0))])
def test_wiring_pool_helpers(device, replicas, want, monkeypatch):
    """The CLIs' live pool: ``cuda`` leaves the devices to the engine (one
    replica a card, at most the cards there are); another device is named
    once a replica."""
    from repro_torch.traffic.wiring import pool_devices, pool_size

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert (pool_devices(device, replicas), pool_size(device, replicas)) \
        == want


def test_wiring_health_and_export_on_a_session(tmp_path):
    """``make_health`` needs an active session and installs its monitor
    there, census and recorder included; ``finish_obs`` exports, uninstalls
    the session and writes the alert log into the bundle directory and
    next to the metrics."""
    from repro_torch.obs.__main__ import load_alerts
    from repro_torch.traffic.wiring import finish_obs, make_health

    assert make_health(DEFAULT_CLASSES) is None
    ob = obsrt.instrument(clock=FakeClock())
    health = make_health(DEFAULT_CLASSES, interval_s=0.01,
                         bundle_dir=str(tmp_path / "b"), arch="resnet8")
    assert ob.health is health and health.interval_s == 0.01
    assert health.census_extra["arch"] == "resnet8"
    assert health.recorder is not None
    health.tick(ob.now())
    written = finish_obs(ob, metrics_out=str(tmp_path / "m.txt"),
                         bundle_dir=str(tmp_path / "b"))
    assert obsrt.active() is None
    assert set(written) == {"metrics", "alerts"}
    assert load_alerts(str(tmp_path / "b" / "alerts.jsonl")) == \
        load_alerts(str(tmp_path / "m.alerts.jsonl")) == []
