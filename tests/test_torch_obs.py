"""``repro_torch.obs`` against ``repro.obs``: each case of tests/test_obs.py
that touches a ported module, run over both packages where the case is the
same (``pkg``), plus the port's own hooks — compile accounting in
``CompiledModel``, the A/B probe in ``ResNetEngine`` and
``obs.profile.profile_tasks`` on the CPU (the kernels' plain versions)."""
import importlib
import json

import numpy as np
import pytest
import torch
from test_torch_slice import images, np_qparams

from repro.core import dataflow as jdf
from repro.models import resnet as JR
from repro_torch.compile import calltrace, compiler
from repro_torch.compile import (compile_model, lm_config, lowering,
                                 optimized_graph, params_from_numpy, plan_lm)
from repro_torch.configs import get_smoke_config
from repro_torch.compile.lm_params import init_lm_params
from repro_torch.core import dataflow as df
from repro_torch.models import resnet as R
from repro_torch.obs import metrics as PM
from repro_torch.obs import runtime as prt
from repro_torch.obs import trace as PT
from repro_torch.obs.profile import REFERENCE_HBM_GBPS, profile_tasks
from repro_torch.serve import ImageRequest, ResNetEngine

PKGS = ["repro", "repro_torch"]


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.obs.metrics"),
            importlib.import_module(f"{pkg}.obs.trace"),
            importlib.import_module(f"{pkg}.obs.runtime"))


@pytest.fixture(autouse=True)
def _no_session_leaks():
    """Obs state is a module global in each package: every test starts and
    ends clean."""
    import repro.obs.runtime as jrt
    prior = (jrt.disable(), prt.disable())
    yield
    jrt.install(prior[0])
    prt.install(prior[1])


class FakeClock:
    """A virtual clock: ``now()`` in seconds, moved by ``advance``."""

    def __init__(self, t=0.0):
        self.t = t

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def qp8():
    return params_from_numpy(np_qparams(JR.RESNET8, seed=21))


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_labels_value_total(pkg):
    M, _, _ = _mods(pkg)
    c = M.Counter("served_total")
    c.inc(replica="0")
    c.inc(3, replica="1")
    c.inc(replica="0")
    assert (c.value(replica="0"), c.value(replica="1"),
            c.value(replica="9"), c.total()) == (2, 3, 0, 5)
    with pytest.raises(ValueError):
        c.inc(-1)


@pytest.mark.parametrize("pkg", PKGS)
def test_gauge_set_add(pkg):
    M, _, _ = _mods(pkg)
    g = M.Gauge("active")
    g.set(4)
    g.add(-1)
    assert g.value() == 3
    g.set(2.5, pool="a")
    assert g.value(pool="a") == 2.5


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_cumulative_buckets(pkg):
    M, _, _ = _mods(pkg)
    h = M.Histogram("wait_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    snap = h.snapshot()["series"][""]
    assert snap["buckets"] == {"1": 1, "10": 2, "100": 3}
    assert snap["count"] == 4 and snap["sum"] == pytest.approx(555.5)
    assert h.count() == 4 and h.sum() == pytest.approx(555.5)


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_create_or_get_and_kind_conflict(pkg):
    M, _, _ = _mods(pkg)
    r = M.MetricsRegistry()
    assert r.counter("a") is r.counter("a")
    with pytest.raises(TypeError):
        r.gauge("a")
    assert r.total("a") == 0
    r.counter("a").inc(5, k="x")
    assert r.total("a") == 5 and r.get("nope") is None


def _registry(M, order):
    r = M.MetricsRegistry()
    for name in order:
        r.counter(name, f"help for {name}")
    r.counter("aa").inc(2, b="2", a="1")
    r.counter("aa").inc(1)
    r.counter("zz").inc(7)
    r.gauge("frac", "a share").set(0.125, pool="x")
    r.gauge("frac").set(1e-7)
    r.histogram("h_ms", buckets=(1.0, 5.0)).observe(0.3, cls="x")
    r.histogram("h_ms").observe(7.5, cls="y")
    return r


@pytest.mark.parametrize("order", [("zz", "aa"), ("aa", "zz")])
def test_render_text_is_byte_equal_between_packages(order):
    """The same operations give the same Prometheus text in both packages,
    in any insertion order."""
    jm, pm = _mods("repro")[0], _mods("repro_torch")[0]
    text = _registry(pm, order).render_text()
    assert text == _registry(jm, order).render_text()
    assert text == _registry(pm, ("aa", "zz")).render_text()
    assert _registry(pm, order).snapshot() == _registry(jm, order).snapshot()


@pytest.mark.parametrize("pkg", PKGS)
def test_render_text_round_trips_through_parse_text(pkg):
    M, _, _ = _mods(pkg)
    r = M.MetricsRegistry()
    r.counter("runs_total", "runs").inc(3, bucket="8")
    r.gauge("frac").set(0.125)
    r.histogram("lat_ms", buckets=(1.0,)).observe(0.5)
    parsed = M.parse_text(r.render_text())
    assert parsed["runs_total"]['{bucket="8"}'] == 3
    assert parsed["frac"][""] == 0.125
    assert parsed["lat_ms_bucket"]['{le="1"}'] == 1
    assert parsed["lat_ms_bucket"]['{le="+Inf"}'] == 1
    assert parsed["lat_ms_count"][""] == 1
    # each package parses the other's text the same way
    other = _mods("repro" if pkg == "repro_torch" else "repro_torch")[0]
    assert other.parse_text(r.render_text()) == parsed


@pytest.mark.parametrize("pkg", PKGS)
def test_parse_text_rejects_malformed(pkg):
    M, _, _ = _mods(pkg)
    for bad in ("dangling_name\n", "name{unbalanced 3\n",
                "name not_a_number\n"):
        with pytest.raises(ValueError):
            M.parse_text(bad)
    assert M.parse_text("# comment only\n\n") == {}


# ---------------------------------------------------------------------------
# trace recording + export
# ---------------------------------------------------------------------------


def _sample_trace(T, order=("b_track", "a_track")):
    clock = FakeClock(0.25)
    tr = T.Trace(clock=clock)
    tr.span("work", cat="sched", track=order[0], t0=0.001, t1=0.003, seq=1)
    tr.instant("mark", cat="control", track=order[1], t=0.002, reason="x")
    tr.span("slow", cat="kernel", track="kernels", t0=0.0, t1=0.5,
            wall_us=500000.0, hbm_modeled_bytes=1024)
    clock.advance(0.125)
    tr.instant("now", cat="compile", track="compile", bucket=8)
    tr.span("open", track="main")
    return tr


def test_chrome_and_jsonl_equal_between_packages_under_one_fake_clock():
    jt, pt = _mods("repro")[1], _mods("repro_torch")[1]
    for strip in (False, True):
        assert _sample_trace(pt).chrome(strip_volatile=strip) == \
            _sample_trace(jt).chrome(strip_volatile=strip)
        assert _sample_trace(pt).jsonl(strip_volatile=strip) == \
            _sample_trace(jt).jsonl(strip_volatile=strip)
    assert _sample_trace(pt).summary() == _sample_trace(jt).summary()
    assert PT.VOLATILE_ARGS == jt.VOLATILE_ARGS
    assert PT.VOLATILE_CATS == jt.VOLATILE_CATS


@pytest.mark.parametrize("pkg", PKGS)
def test_chrome_structure_and_track_tids(pkg):
    T = _mods(pkg)[1]
    ch = _sample_trace(T).chrome()
    assert set(ch) == {"traceEvents", "displayTimeUnit"}
    meta = [e for e in ch["traceEvents"] if e["ph"] == "M"]
    assert [m["args"]["name"] for m in meta] == \
        ["a_track", "b_track", "compile", "kernels", "main"]
    assert [m["tid"] for m in meta] == [1, 2, 3, 4, 5]
    span = next(e for e in ch["traceEvents"]
                if e["ph"] == "X" and e["name"] == "work")
    assert span["ts"] == 1000.0 and span["dur"] == 2000.0
    assert span["tid"] == 2 and span["pid"] == 1
    inst = next(e for e in ch["traceEvents"] if e["name"] == "now")
    assert inst["s"] == "t" and inst["ts"] == 375000.0
    assert ch == _sample_trace(T, order=("b_track", "a_track")).chrome()
    for line in _sample_trace(T).jsonl().splitlines():
        d = json.loads(line)
        assert list(d) == sorted(d) and d["ph"] in ("X", "i")


@pytest.mark.parametrize("pkg", PKGS)
def test_strip_volatile_drops_wall_fields_and_kernel_times(pkg):
    T = _mods(pkg)[1]
    tr = _sample_trace(T)
    stripped = T.strip_volatile_events(tr.events)
    kernel = next(e for e in stripped if e.cat == "kernel")
    assert kernel.ts == 0.0 and kernel.dur == 0.0
    assert "wall_us" not in (kernel.args or {})
    assert kernel.args["hbm_modeled_bytes"] == 1024
    sched = next(e for e in stripped if e.cat == "sched")
    assert sched.ts == 0.001 and sched.dur == pytest.approx(0.002)
    assert tr.events[2].args["wall_us"] == 500000.0


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_summary_counts(pkg):
    s = _sample_trace(_mods(pkg)[1]).summary()
    assert (s["events"], s["spans"], s["instants"]) == (5, 3, 2)
    assert s["tracks"]["kernels"]["total_s"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# runtime switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_instrumented_context_manager_always_uninstalls(pkg):
    rt = _mods(pkg)[2]
    with pytest.raises(RuntimeError):
        with rt.instrumented() as ob:
            assert rt.active() is ob
            raise RuntimeError("boom")
    assert rt.active() is None


@pytest.mark.parametrize("pkg", PKGS)
def test_install_restores_a_specific_session(pkg):
    rt = _mods(pkg)[2]
    a = rt.instrument()
    b = rt.Observability()
    assert rt.install(b) is b and rt.active() is b
    rt.install(a)
    assert rt.active() is a
    rt.install(None)
    assert rt.active() is None
    clock = FakeClock(3.5)
    ob = rt.instrument()
    ob.set_clock(clock)
    assert ob.now() == 3.5 and ob.trace.now() == 3.5
    assert rt.disable() is ob and rt.active() is None


# ---------------------------------------------------------------------------
# the port's hooks: compile accounting, the A/B probe, zero cost when off
# ---------------------------------------------------------------------------


def test_compile_counters_and_retrace_detector(qp8):
    """tests/test_obs.py's case on the port: one trace and one executable a
    bucket, the runs and pad rows counted, and a forced second trace of the
    bucket fires the retrace detector in lockstep with ``trace_counts``."""
    ob = prt.instrument()
    cm = compile_model(R.RESNET8, qp8, backend="cuda", batch_sizes=(4,),
                       device="cpu")
    imgs = torch.from_numpy(images(4, seed=1))
    cm(imgs)
    assert ob.metrics.total("compile_traces_total") == 1
    assert ob.metrics.get("compile_executables_total").value(
        kind="default", bucket="4", backend="cuda") == 1
    assert ob.metrics.total("model_runs_total") == 1
    assert ob.metrics.total("compile_retraces_total") == 0
    cm(imgs[:2])
    assert ob.metrics.get("model_pad_rows_total").value(
        bucket="4", backend="cuda") == 2
    compile_events = [e for e in ob.trace.events if e.name == "compile"]
    assert len(compile_events) == 1 and \
        compile_events[0].args["kind"] == "default"
    cm._staged(imgs)
    assert cm.trace_counts[4] == 2
    assert ob.metrics.total("compile_retraces_total") == 1
    assert any(e.name == "retrace" for e in ob.trace.events)
    cm.run_placed(imgs, "cpu")
    assert ob.metrics.get("compile_executables_total").value(
        kind="device", bucket="4", backend="cuda") == 1
    assert ob.metrics.total("model_runs_total") == 3


class _Poison:
    def __getattr__(self, name):
        raise AssertionError(f"obs used while disabled (attribute {name!r})")


class _StubGraph:
    """A captured graph's stand-in on the CPU: ``replay()`` runs the eager
    forward from the static input into the static output."""

    def __init__(self, forward, static_in, static_out):
        self.forward, self.static_in, self.static_out = \
            forward, static_in, static_out

    def replay(self):
        self.static_out.copy_(self.forward(self.static_in))


def _graph_model(qp, bucket=4):
    """A CPU ``CompiledModel`` whose bucket runs through a
    ``GraphExecutable`` around a stub graph (the GPU's serving path)."""
    cm = compile_model(R.RESNET8, qp, backend="cuda", batch_sizes=(bucket,),
                       device="cpu")
    static_in = torch.zeros(cm.input_spec(bucket).shape)
    static_out = torch.zeros(bucket, R.RESNET8.num_classes)
    cm._execs[bucket] = compiler.GraphExecutable(
        _StubGraph(cm._forward, static_in, static_out), static_in,
        static_out, {})
    return cm


def test_disabled_serving_path_never_touches_the_session(qp8):
    """After disable(), a session captured earlier must be unreachable from
    the serving path: call sites read ``runtime.active()`` every time."""
    ob = prt.instrument()
    eng = ResNetEngine(R.RESNET8, qp8, batch=4, batch_sizes=(2, 4),
                       ab_backends=("torch-int",), device="cpu")
    cm = _graph_model(qp8)
    prt.disable()
    ob.metrics = ob.trace = ob.call_tracer = _Poison()
    for i, im in enumerate(images(5, seed=2)):
        eng.submit(ImageRequest(rid=i, image=im))
    assert eng.run() == 2 and eng.served == 5
    imgs = torch.from_numpy(images(4, seed=2))
    assert torch.equal(cm(imgs[:3]), cm._forward(cm.pad(imgs[:3]))[:3])
    assert cm.run_counts[4] == 1


def _refuse(*args, **kwargs):
    raise AssertionError("the call path did more than read the switch")


def test_disabled_call_path_reads_the_switch_once(qp8, monkeypatch):
    """With no session a bucket run through a graph reads
    ``obs.active()`` once and nothing else of the tracing: no clock read,
    no span object, no CUDA event, no profiler call."""
    cm = _graph_model(qp8)
    imgs = torch.from_numpy(images(8, seed=3))
    reads = []
    monkeypatch.setattr(prt, "active", lambda: reads.append(1))
    for mod in (compiler, calltrace):
        monkeypatch.setattr(mod, "time", _Poison())
    for owner, name in ((calltrace, "tracer"), (calltrace.Call, "__init__"),
                        (calltrace.Phase, "__init__"), (torch.cuda, "Event"),
                        (torch.autograd, "_profiler_enabled"),
                        (torch.profiler, "record_function")):
        monkeypatch.setattr(owner, name, _refuse)
    out = cm(imgs)              # two bucket runs of 4
    assert reads == [1, 1]
    assert torch.equal(out[:4], cm._forward(imgs[:4]))


def _by_call(events):
    out = {}
    for e in events:
        if e.track == calltrace.TRACK:
            out.setdefault(e.args["call"], []).append(e)
    return out


def test_graph_call_spans_one_tree(qp8):
    """A graph's bucket run is one host span ``call`` over ``copy_in``,
    ``replay`` and ``clone``, in that order and apart, all with the run's
    number; the self time is what the children leave of ``call``.  An
    eager bucket (``run_placed`` on the CPU) records ``call`` alone, and
    the CPU has no device spans."""
    cm = _graph_model(qp8)
    imgs = torch.from_numpy(images(4, seed=1))
    ob = prt.instrument()
    out = cm(imgs[:3])
    assert torch.equal(out, cm._forward(cm.pad(imgs[:3]))[:3])
    cm(imgs)
    cm.run_placed(imgs, "cpu")
    assert not _by_call(ob.trace.events)    # kept until the flush
    ob.flush()
    calls = _by_call(ob.trace.events)
    assert sorted(calls) == [1, 2, 3]
    for n in (1, 2):
        root, *kids = calls[n]
        assert root.name == "call" and root.cat == "compile"
        assert root.args == dict(call=n, bucket=4, backend="cuda")
        assert [k.name for k in kids] == ["copy_in", "replay", "clone"]
        assert all(k.args == dict(call=n, parent="call") for k in kids)
        ends = [root.ts] + [x for k in kids for x in (k.ts, k.ts + k.dur)]
        assert ends == sorted(ends) and ends[-1] <= root.ts + root.dur
        self_s = root.dur - sum(k.dur for k in kids)
        assert 0 <= self_s <= root.dur
    assert [e.name for e in calls[3]] == ["call"]
    assert not [e for e in ob.trace.events if e.cat == "kernel"]
    assert ob.metrics.total("model_runs_total") == 3
    n = len(ob.trace.events)
    ob.flush()                   # a second flush records nothing again
    assert len(ob.trace.events) == n


def _fake_clock_run(qp):
    ob = prt.instrument(clock=FakeClock(2.5))
    cm = _graph_model(qp)
    imgs = torch.from_numpy(images(4, seed=1))
    cm(imgs[:2])
    ob.clock.advance(0.5)
    cm(imgs)
    ob.clock.advance(0.25)
    ob.flush()
    prt.disable()
    return ob


def test_call_spans_under_a_fake_clock_strip_to_the_same_bytes(qp8):
    """Under a ``FakeClock`` a span sits at the clock's time with no
    duration and carries the measured one as ``wall_us``; two seeded runs
    export the same bytes once the volatile args are stripped."""
    a, b = _fake_clock_run(qp8), _fake_clock_run(qp8)
    calls = _by_call(a.trace.events)
    assert {e.ts for e in calls[1]} == {2.5} and \
        {e.ts for e in calls[2]} == {3.0}
    assert all(e.dur == 0.0 and e.args["wall_us"] >= 0.0
               for es in calls.values() for e in es)
    assert a.trace.jsonl(strip_volatile=True) == \
        b.trace.jsonl(strip_volatile=True)
    assert a.trace.chrome(strip_volatile=True) == \
        b.trace.chrome(strip_volatile=True)


class _StubEvent:
    """A CUDA event's stand-in: ``t``, the device's time in ms when it
    passed the event, and ``done``, set by the test as the device would."""

    def __init__(self, t=None):
        self.t, self.done, self.streams = t, False, []

    def record(self, stream=None):
        self.streams.append(stream)
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


def _stub_streams(monkeypatch, ids):
    """The current stream's id reads from ``ids`` (one value a call);
    ``torch.cuda.current_stream`` counts its lookups in the result."""
    looked = []
    it = iter(ids)
    monkeypatch.setattr(calltrace, "stream_id", lambda index: next(it))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: looked.append(index) or
                        f"s{len(looked)}")
    return looked


def test_device_spans_resolve_lazily_through_the_anchor(monkeypatch):
    """A call's events are read at the read (the flush), oldest first,
    waiting for each, and placed at the anchor's host time plus their
    ``elapsed_time`` from the anchor; the stream is looked up in full only
    when its id changed; a full ring leaves a call untimed, and a read
    frees it."""
    looked = _stub_streams(monkeypatch, [7, 7, 9, 9])
    pairs = [(_StubEvent(), _StubEvent()) for _ in range(2)]
    timer = calltrace.DeviceTimer(pairs, _StubEvent(t=1000.0),
                                  anchor_host=50.0, uncertainty=20e-6)
    for call in (1, 2):
        timer.end(timer.begin(), call)
    assert timer.begin() is None and timer.dropped == 1
    assert looked == [0] and pairs[1][1].streams == ["s1"]
    pairs[0][0].t, pairs[0][1].t = 1000.5, 1000.625
    pairs[1][0].t, pairs[1][1].t = 1000.75, 1001.0
    [(c1, a0, a1), (c2, b0, b1)] = timer.read()
    assert (c1, c2) == (1, 2) and pairs[1][1].done
    assert (a0, a1) == (pytest.approx(50.0005), pytest.approx(50.000625))
    assert (b0, b1) == (pytest.approx(50.00075), pytest.approx(50.001))
    assert timer.read() == []
    assert timer.begin() == 0 and pairs[0][0].streams == ["s1", "s2"]
    assert timer.begin() == 1 and looked == [0, 0]


def test_reanchor_moves_the_placed_spans_onto_the_line():
    """A second anchor that the first places 4 us late on the host clock
    (the device's clock ran fast) moves each span placed through the first
    in proportion to its distance from it, and the new anchor places what
    follows."""
    timer = calltrace.DeviceTimer([], _StubEvent(t=0.0), anchor_host=10.0,
                                  uncertainty=0.0)
    timer.placed = [PT.TraceEvent("X", "call", "kernel", "d", t, 1e-4)
                    for t in (10.0, 10.5, 11.0)]
    placed = timer.placed
    timer.reanchor(_StubEvent(t=1000.0), anchor_host=11.0 - 4e-6,
                   uncertainty=1e-5)
    assert [e.ts for e in placed] == pytest.approx(
        [10.0, 10.5 - 2e-6, 11.0 - 4e-6], abs=1e-9)
    assert timer.placed == [] and timer.anchor_host == 11.0 - 4e-6


def test_session_flush_places_device_spans_beside_the_host_spans(
        monkeypatch):
    """Through the session: a traced run on a CUDA device records its
    events on the current stream, and ``flush()`` turns them into a
    ``call`` span on the device's track with the run's number, which
    ``strip_volatile`` zeroes as it does kernel times."""
    dev = torch.device("cuda", 0)
    pairs = [(_StubEvent(), _StubEvent()) for _ in range(4)]
    ob = prt.instrument()
    tracer = calltrace.tracer(ob)
    assert calltrace.tracer(ob) is tracer
    tracer.timers[dev] = calltrace.DeviceTimer(
        pairs, _StubEvent(t=0.0), anchor_host=ob.now(), uncertainty=0.0)
    _stub_streams(monkeypatch, [3])
    monkeypatch.setattr(calltrace, "anchor_event", lambda d, now: (
        _StubEvent(t=1.0), tracer.timers[dev].anchor_host + 1e-3, 2e-5))
    with tracer.call(dev, bucket=8) as call:
        with call.phase("copy_in"):
            pass
    with tracer.call(dev, bucket=8):
        pass                    # no phase: untimed on the device
    assert pairs[0][0].streams == pairs[0][1].streams == ["s1"]
    assert pairs[1][0].streams == []
    pairs[0][0].t, pairs[0][1].t = 0.25, 0.5
    ob.flush()
    [span] = [e for e in ob.trace.events
              if e.cat == "kernel" and e.ph == "X"]
    assert (span.name, span.track, span.args) == \
        ("call", "device cuda:0", dict(call=1))
    assert span.dur == pytest.approx(0.25e-3)
    host, timer_span, copy_in = _by_call(ob.trace.events)[1]
    # the flush's anchor, 1 ms after the first and placed there by it,
    # shows no skew: the span stays at the first anchor + 0.25 ms
    timer = ob.call_tracer.timers[dev]
    assert span.ts == pytest.approx(timer.anchor_host - 1e-3 + 0.25e-3)
    assert host.args == dict(call=1, bucket=8)
    # the start event's record is a child of its own, before copy_in, so
    # the call's self time holds none of the device timing
    assert (timer_span.name, copy_in.name) == ("timer", "copy_in")
    assert timer_span.args == dict(call=1, parent="call")
    assert host.ts <= timer_span.ts <= timer_span.ts + timer_span.dur \
        <= copy_in.ts
    anchors = [e for e in ob.trace.events if e.name == "anchor"]
    assert [e.args["wall_us"] for e in anchors] == [20.0]
    stripped = PT.strip_volatile_events([span])[0]
    assert stripped.ts == stripped.dur == 0.0


def test_a_full_ring_leaves_the_call_untimed_until_the_flush(
        monkeypatch):
    """No call reads an event: once every pair of the ring holds a call,
    the next goes untimed, and nothing waits; the flush reads the ring
    and frees it for the calls after."""
    dev = torch.device("cuda", 0)
    (start, end), = pairs = [(_StubEvent(), _StubEvent())]
    ob = prt.instrument()
    tracer = calltrace.tracer(ob)
    timer = tracer.timers[dev] = calltrace.DeviceTimer(
        pairs, _StubEvent(t=0.0), anchor_host=0.0, uncertainty=0.0)
    _stub_streams(monkeypatch, [5] * 3)
    monkeypatch.setattr(calltrace, "anchor_event", lambda d, now: (
        _StubEvent(t=3.0), 3e-3, 0.0))
    monkeypatch.setattr(_StubEvent, "elapsed_time", _refuse)

    def run():
        with tracer.call(dev) as call:
            with call.phase("copy_in"):
                pass

    run()
    run()                       # the ring is full: call 2 untimed
    assert timer.dropped == 1 and len(start.streams) == 1
    assert not end.done         # nothing waited on the call path
    monkeypatch.undo()
    _stub_streams(monkeypatch, [5])
    monkeypatch.setattr(calltrace, "anchor_event", lambda d, now: (
        _StubEvent(t=3.0), 3e-3, 0.0))
    start.t, end.t = 1.0, 2.0
    ob.flush()
    assert [e.args["call"] for e in ob.trace.events
            if e.cat == "kernel" and e.ph == "X"] == [1]
    run()                       # the flush freed the ring: call 3 timed
    assert timer.pending == [(0, 3)] and len(start.streams) == 2


def test_profiler_shows_the_call_phases(qp8):
    """Under ``torch.profiler`` each host span is also a
    ``record_function`` annotation: ``copy_in`` encloses the call's
    ``aten::copy_`` and ``call`` encloses its three phases."""
    from torch.profiler import ProfilerActivity, profile
    cm = _graph_model(qp8)
    imgs = torch.from_numpy(images(4, seed=1))
    prt.instrument()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cm(imgs)
    ev = prof.events()
    one = {}
    for name in ("call", "copy_in", "replay", "clone"):
        [one[name]] = [e for e in ev if e.name == name]

    def inside(e, outer):
        return outer.time_range.start <= e.time_range.start and \
            e.time_range.end <= outer.time_range.end

    assert any(e.name == "aten::copy_" and inside(e, one["copy_in"])
               for e in ev)
    assert all(inside(one[k], one["call"])
               for k in ("copy_in", "replay", "clone"))


def _serve(qp, instrumented, backend="cuda", shadow="torch-int"):
    ob = prt.instrument(clock=FakeClock()) if instrumented else None
    try:
        eng = ResNetEngine(R.RESNET8, qp, batch=4, batch_sizes=(1, 4),
                           backend=backend, ab_backends=(shadow,),
                           device="cpu")
        reqs = [ImageRequest(rid=i, image=im)
                for i, im in enumerate(images(6, seed=3))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return np.stack([r.logits for r in reqs]), ob
    finally:
        prt.disable()


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_serving_with_a_session_is_bitwise_the_same(qp8, backend):
    off, _ = _serve(qp8, False, backend)
    on, ob = _serve(qp8, True, backend)
    assert np.array_equal(off, on)
    m = ob.metrics
    assert m.get("ab_checks_total").value(shadow="torch-int") == 2
    assert m.get("ab_max_abs_dev").value(shadow="torch-int") == 0.0
    assert m.total("ab_mismatch_total") == 0
    assert m.total("model_runs_total") == 4          # primary + shadow
    assert m.get("model_pad_rows_total").value(bucket="4",
                                               backend=backend) == 2
    assert m.total("compile_traces_total") == 2


def test_integer_shadow_that_disagrees_counts_a_mismatch(qp8):
    ob = prt.instrument()
    eng = ResNetEngine(R.RESNET8, qp8, batch=2, batch_sizes=(2,),
                       ab_backends=("torch-int",), device="cpu")
    honest = eng.shadows["torch-int"]
    eng.shadows["torch-int"] = lambda x: honest(x) + 0.5
    for i, im in enumerate(images(2, seed=4)):
        eng.submit(ImageRequest(rid=i, image=im))
    eng.run()
    assert ob.metrics.get("ab_mismatch_total").value(shadow="torch-int") \
        == 1
    assert ob.metrics.get("ab_max_abs_dev").value(
        shadow="torch-int") == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["gemma-2b", "falcon-mamba-7b"])
def test_lm_shadow_deviation_is_no_bitwise_mismatch(name):
    """An LM's attention and scan are float, so its integer backends agree
    within tolerance only: the probe records every deviation of the
    torch-int shadow in ``ab_max_abs_dev`` and counts none of them in
    ``ab_mismatch_total``, which is the conv configs' bitwise sentinel."""
    cfg = lm_config(get_smoke_config(name), seq_len=8)
    ob = prt.instrument()
    eng = ResNetEngine(cfg, init_lm_params(cfg, seed=3, device="cpu"),
                       batch=2, batch_sizes=(2,), ab_backends=("torch-int",),
                       device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8))
    for i, t in enumerate(toks.astype(np.int32)):
        eng.submit(ImageRequest(rid=i, image=t))
    assert eng.tick()                    # the honest shadow
    honest = eng.shadows["torch-int"]
    eng.shadows["torch-int"] = lambda x: honest(x) + 0.5
    assert eng.tick()                    # a shadow that deviates
    m = ob.metrics
    assert m.get("ab_checks_total").value(shadow="torch-int") == 2
    assert eng.ab_stats["torch-int"][1] >= 0.5
    assert m.get("ab_max_abs_dev").value(shadow="torch-int") == \
        eng.ab_stats["torch-int"][1]
    assert m.total("ab_mismatch_total") == 0


# ---------------------------------------------------------------------------
# report CLI and bundles
# ---------------------------------------------------------------------------


def _exports(tmp_path, qp):
    _, ob = _serve(qp, True)
    trace, mtx = tmp_path / "trace.json", tmp_path / "metrics.txt"
    prt.export(ob, trace_out=str(trace), metrics_out=str(mtx),
               jsonl_out=str(tmp_path / "trace.jsonl"))
    return trace, mtx


def test_obs_report_cli_parses_exports_as_the_reference_does(
        tmp_path, capsys, qp8):
    from repro.obs.__main__ import main as jax_main
    from repro_torch.obs.__main__ import main as port_main
    trace, mtx = _exports(tmp_path, qp8)
    outs = []
    for main, tag in ((port_main, "port"), (jax_main, "jax")):
        out_json = tmp_path / f"summary_{tag}.json"
        assert main(["--trace", str(trace), "--metrics", str(mtx),
                     "--top", "3", "--json", str(out_json)]) == 0
        outs.append((capsys.readouterr().out, out_json.read_text()))
    assert outs[0] == outs[1]
    assert "spans" in outs[0][0] and "metrics:" in outs[0][0]
    summary = json.loads(outs[0][1])
    assert summary["trace_events"] > 0 and summary["metrics"] > 0


def test_obs_report_cli_rejects_garbage(tmp_path, capsys):
    from repro_torch.obs.__main__ import main as port_main
    bad = tmp_path / "bad.json"
    bad.write_text('{"noTraceEvents": []}')
    assert port_main(["--trace", str(bad)]) == 1
    badm = tmp_path / "bad.txt"
    badm.write_text("dangling_name\n")
    assert port_main(["--metrics", str(badm)]) == 1
    assert port_main(["dump", "--out", str(tmp_path)]) == 1
    capsys.readouterr()


def test_dump_bundle_reads_back_in_both_packages(tmp_path, capsys, qp8):
    from repro.obs.bundle import read_bundle as jax_read_bundle
    from repro_torch.obs.__main__ import main as port_main
    from repro_torch.obs.bundle import read_bundle
    trace, mtx = _exports(tmp_path, qp8)
    out = tmp_path / "bundles"
    assert port_main(["dump", "--trace", str(trace), "--metrics", str(mtx),
                      "--out", str(out), "--reason", "manual check"]) == 0
    path = out / "bundle_000_manual-check"
    port, ref = read_bundle(str(path)), jax_read_bundle(str(path))
    assert port == ref and port["metrics"] and port["trace_events"]
    assert port_main(["--bundle", str(path)]) == 0
    assert "bundle: reason=manual check" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# per-task profiling on the CPU (the kernels' plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kinds", [
    ("cuda", ["stem", "block", "block", "block"]),
    ("cuda-stream", ["chain"])])
def test_profile_tasks_pairs_time_with_the_jax_byte_model(qp8, backend,
                                                          kinds):
    ob = prt.instrument()
    batch = 2
    rows = profile_tasks(R.RESNET8, qp8, backend=backend, batch=batch,
                         reps=1, ob=ob, device="cpu")
    assert [r.kind for r in rows] == kinds
    shapes = jdf.resnet_block_shapes(1)
    stem = jdf.resnet_layers(1)[0]
    for r in rows:
        assert r.wall_us > 0 and r.hbm_bytes > 0 and r.vmem_bytes > 0
        assert r.vs_roofline > 0 and r.gbps > 0
        assert r.to_dict()["hbm_bytes"] == r.hbm_bytes
        if r.kind == "stem":
            want = (jdf.conv_task_hbm_bytes(stem, batch, 1),
                    jdf.conv_task_vmem_bytes(stem, 1, 0))
        elif r.kind == "block":
            s = shapes[int(r.task[1:])]
            want = (jdf.resblock_task_hbm_bytes(
                        s.h, s.w, s.ich, s.och, batch, 1,
                        downsample=s.downsample, stride=s.stride),
                    jdf.resblock_task_vmem_bytes(
                        s.h, s.w, s.ich, s.och, 1,
                        downsample=s.downsample, stride=s.stride))
        else:
            assert r.task == "stem+b0+b1+b2"
            want = (jdf.chain_task_hbm_bytes(shapes, batch, 1, stem_och=16),
                    jdf.chain_task_vmem_bytes(shapes, 1, stem_och=16))
        assert (r.hbm_bytes, r.vmem_bytes) == want, r.task
        bound_us = r.hbm_bytes / (REFERENCE_HBM_GBPS * 1e9) * 1e6
        assert r.vs_roofline == pytest.approx(r.wall_us / bound_us)
    assert REFERENCE_HBM_GBPS == 3350.0
    assert ob.metrics.total("kernel_profiles_total") == len(rows)
    assert len([e for e in ob.trace.events if e.cat == "kernel"]) == \
        len(rows)
    text = ob.metrics.render_text()
    assert "kernel_hbm_modeled_bytes" in text
    assert "wall" not in text and "gbps" not in text
    assert PM.parse_text(text)["kernel_vmem_modeled_bytes"]
    assert df.resnet_block_shapes(1)[0].h == shapes[0].h


def test_profile_tasks_refuses_other_backends_and_lm_configs(qp8):
    """A non-kernel backend is refused, for a conv config and an LM config
    alike; an LM config on a kernel backend is profiled (its leg landed),
    one row per task of its plan."""
    with pytest.raises(ValueError, match="kernel backends"):
        profile_tasks(R.RESNET8, qp8, backend="torch-int", device="cpu")
    cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=16)
    params = init_lm_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="kernel backends"):
        profile_tasks(cfg, params, backend="torch-int", device="cpu")
    rows = profile_tasks(cfg, params, reps=1, device="cpu")
    assert len(rows) == len(plan_lm(optimized_graph(cfg), params).tasks)


@pytest.mark.parametrize("name", ["gemma-2b", "falcon-mamba-7b"])
@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_profile_tasks_lm_rows_pair_time_with_the_jax_byte_model(name,
                                                                 backend):
    """The LM leg: one row per matmul / attention / scan task of the plan,
    keyed by ``tuning_key`` (the reference's rows' keys), each paired with
    the JAX package's ``core.dataflow`` LM byte formula at the tiles the
    port's kernel runs (a matmul at (128, bn, 128), or the mma_sync path's
    (128, 128, 64); an attention at (bm positions, 64 keys); a scan at its
    channel block), ``vmem_bytes`` the thread block's shared memory."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.matmul_int8 import ops as mops
    from repro_torch.kernels.selective_scan import ops as sops

    cfg = lm_config(get_smoke_config(name), seq_len=16)
    params = init_lm_params(cfg, seed=1, device="cpu")
    batch = 2
    ob = prt.instrument()
    plan = plan_lm(optimized_graph(cfg), params)
    rows = profile_tasks(cfg, params, backend=backend, batch=batch, reps=1,
                         ob=ob, device="cpu")
    keys = [lowering.tuning_key(n) for n in optimized_graph(cfg).nodes]
    assert [r.task for r in rows] == [k for k in keys if k]
    assert [r.kind for r in rows] == [t.kind for t in plan.tasks]
    M = batch * cfg.seq_len
    for r, t in zip(rows, plan.tasks):
        assert r.batch == batch and r.wall_us > 0 and r.hbm_bytes > 0
        if t.kind == "matmul":
            if mops.matmul_path(M, t.dout, t.din) == "wgmma":
                bn = mops.matmul_tiles(M, t.dout, t.din)[1]
                tiles, smem = (128, bn, 128), mops.smem_bytes(bn)
            else:
                tiles, smem = (128, 128, 64), mops.SYNC_SMEM
            want = (jdf.matmul_task_hbm_bytes(
                M, t.din, t.dout, *tiles, acc_init=t.skip is not None), smem)
            assert r.batch_tile == 128
        elif t.kind == "attention":
            bq, bk = fops.attn_tiles(cfg.seq_len, cfg.seq_len,
                                     t.heads // t.kv_heads)
            want = (jdf.attention_task_hbm_bytes(
                batch * t.heads, cfg.seq_len, cfg.seq_len, t.head_dim, bq,
                bk), fops.block_smem_bytes(t.head_dim))
            assert r.batch_tile == bq
        else:
            want = (jdf.scan_task_hbm_bytes(batch, cfg.seq_len, t.d_inner,
                                            t.ssm_state, 32),
                    sops.scan_smem_bytes(32, 4))
            assert r.batch_tile == 32
        assert (r.hbm_bytes, r.vmem_bytes) == want, r.task
    assert ob.metrics.total("kernel_profiles_total") == len(rows)
    assert {e.name for e in ob.trace.events if e.cat == "kernel"} == \
        {f"{cfg.name}/{r.task}" for r in rows}
