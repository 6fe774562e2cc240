"""The obs phase: the reduction of the program's call spans, on spans
written by hand, the four readers, and the phase itself on the CPU."""
import json
import sys

import pytest
import torch

from bench import cells, obsphase
from bench.tests.small import small_cell

from repro_torch import obs
from repro_torch.obs.trace import TraceEvent

READERS = ("call_self_host_us", "replay_host_us", "call_device_us",
           "call_gap_us")


def _call(n, t0, copy_in, replay, clone, dev=None, timer=None):
    """The spans of call ``n``: host ``call`` from ``t0`` for 50 us, its
    children (the tracer's ``timer`` where given) and its device span,
    each ``(start, end)`` in us."""
    us = 1e-6
    out = [TraceEvent("X", "call", "compile", "calls", t0 * us, 50 * us,
                      dict(call=n, bucket=32, backend="cuda"))]
    if timer is not None:
        out.append(TraceEvent("X", obsphase.TIMER, "compile", "calls",
                              timer[0] * us, (timer[1] - timer[0]) * us,
                              dict(call=n, parent="call")))
    for name, (a, b) in zip(obsphase.PHASES, (copy_in, replay, clone)):
        out.append(TraceEvent("X", name, "compile", "calls", a * us,
                              (b - a) * us, dict(call=n, parent="call")))
    if dev is not None:
        out.append(TraceEvent("X", "call", "kernel", "device cuda:0",
                              dev[0] * us, (dev[1] - dev[0]) * us,
                              dict(call=n)))
    return out


EVENTS = [TraceEvent("i", "anchor", "kernel", "device cuda:0", 0.0,
                     args=dict(wall_us=1.0))]
EVENTS += _call(1, 0, (10, 20), (25, 40), (42, 48), dev=(3, 55))
EVENTS += _call(2, 60, (70, 80), (85, 100), (102, 108), dev=(65, 90))
EVENTS += _call(3, 120, (130, 140), (145, 160), (162, 168), dev=(180, 230))
EVENTS += _call(4, 300, (305, 310), (312, 330), (332, 340), dev=(320, 380),
                timer=(302, 304))


def test_reduce():
    r = obsphase.reduce(EVENTS)
    assert r["calls"] == r["device_calls"] == 4
    assert r["call_us"] == pytest.approx([50] * 4)
    # the tracer's own timer is a child: call 4's self time leaves it out
    assert r["call_self_us"] == pytest.approx([19, 19, 19, 17])
    assert r["timer_us"] == pytest.approx([2])
    assert r["replay_us"] == pytest.approx([15, 15, 15, 18])
    assert r["copy_in_us"] == pytest.approx([10, 10, 10, 5])
    assert r["device_us"] == pytest.approx([52, 25, 50, 60])
    assert r["gap_us"] == pytest.approx([10, 90, 90])
    # midpoints: 60 in call 2 before its copy_in, 135 in call 3's
    # copy_in, 275 under no call
    assert r["gap_by_span_us"] == pytest.approx(
        {"call": 10, "copy_in": 90, "none": 90})
    # call 1's device start leads its copy_in by 7 us > 5 + 1; call 4's
    # record (its timer, from 302) lies before its device start (320)
    assert r["anchor_us"] == 1.0
    assert r["early_calls"] == 1
    assert r["early_worst_us"] == pytest.approx(7)
    assert r["early_record_calls"] == 0


def test_early_against_the_record():
    """A host stall after the start event's record moves ``copy_in`` but
    not the device: early against ``copy_in``, not against the record."""
    r = obsphase.reduce(_call(1, 0, (40, 45), (46, 47), (48, 49),
                              dev=(10, 60), timer=(5, 38)))
    assert (r["early_calls"], r["early_record_calls"]) == (1, 0)
    r = obsphase.reduce(_call(1, 0, (40, 45), (46, 47), (48, 49),
                              dev=(1, 60), timer=(8, 38)))
    assert (r["early_calls"], r["early_record_calls"]) == (1, 1)


def test_reduce_skips_the_first_calls():
    """The session's first calls set the tracing up: ``first_call_us``
    times the first, and ``skip`` leaves them out of the rest."""
    r = obsphase.reduce(EVENTS, skip=1)
    assert r["calls"] == r["device_calls"] == 3
    assert r["first_call_us"] == pytest.approx(50)
    assert r["device_us"] == pytest.approx([25, 50, 60])
    assert r["gap_us"] == pytest.approx([90, 90])
    assert r["early_calls"] == 0
    assert obsphase.reduce(EVENTS, skip=4) is None


def test_reduce_without_call_spans():
    assert obsphase.reduce([]) is None
    assert obsphase.reduce(EVENTS[:1]) is None


def test_reduce_host_spans_alone():
    """An eager bucket (the CPU): ``call`` alone, no device span."""
    r = obsphase.reduce([e for e in EVENTS
                         if e.name == "call" and e.cat == "compile"])
    assert r["calls"] == 4 and r["device_calls"] == 0
    assert r["call_self_us"] == pytest.approx([50] * 4)
    assert r["replay_us"] == r["device_us"] == r["gap_us"] == \
        r["timer_us"] == []
    assert r["anchor_us"] is None


def _read(rec):
    return {name: cells.reader(name)(rec) for name in READERS}


def test_readers():
    rec = dict(obs=dict(call_self_us=[12.0, 10.0, 30.0],
                        replay_us=[8.0, 9.0, 7.0, 20.0],
                        device_us=[104.0, 110.0, 106.0],
                        gap_us=[3.0, 5.0]))
    assert _read(rec) == dict(call_self_host_us=12.0, replay_host_us=8.5,
                              call_device_us=106.0, call_gap_us=4.0)
    rec = dict(obs=obsphase.reduce(EVENTS))
    assert _read(rec) == pytest.approx(dict(
        call_self_host_us=19, replay_host_us=15, call_device_us=51,
        call_gap_us=90))


def test_covering_span_can_be_the_timer():
    """A gap whose midpoint lies in the tracer's ``timer`` is put down to
    it, not to the call's self time."""
    events = _call(1, 0, (10, 20), (25, 40), (42, 48), dev=(12, 50))
    events += _call(2, 60, (70, 80), (85, 100), (102, 108), dev=(70, 90),
                    timer=(58, 62))
    assert obsphase.reduce(events)["gap_by_span_us"] == \
        pytest.approx({"timer": 20})


def _card_with_spans(monkeypatch, argv):
    """A card and a program with call spans; the phase's process stubbed
    to return a reduction; ``sys.argv`` set to ``argv``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(obsphase, "isolated", lambda cfg, mix, seed, dev:
                        dict(seed=seed, calls=1))
    monkeypatch.setattr(obsphase, "summary", lambda out, rec: "")
    monkeypatch.setattr(sys, "argv", argv)


def test_record_takes_the_seed_and_the_window_period(monkeypatch):
    _card_with_spans(monkeypatch, ["run.py", "--workload", "w", "--seed",
                                   "3000000017", "--seconds", "2",
                                   "--trace", "1"])
    rec = dict(trace={}, cfg={}, mix={},
               window=dict(enqueue_s=[1e-5] * 8000))
    assert obsphase.record(rec) == dict(seed=3000000017, calls=1,
                                        window_period_us=250.0)


def test_record_refuses_a_command_line_without_the_seed(monkeypatch):
    _card_with_spans(monkeypatch, ["run.py", "--workload", "w",
                                   "--seconds", "2"])
    with pytest.raises(RuntimeError, match="--seed and --seconds"):
        obsphase.record(dict(trace={}, cfg={}, mix={}, window={}))


def test_summary_flags_a_phase_the_session_paced():
    """A phase whose period lies more than ``PACED_SHARE`` above the
    window's is flagged on its line; one within it is not."""
    out = obsphase.reduce(EVENTS)
    out.update(period_us=108.0, enqueue_us=40.0, window_period_us=100.0)
    assert obsphase.paced_by_session(out) is None
    assert "PACED" not in obsphase.summary(out, {})
    out["period_us"] = 130.0
    assert obsphase.paced_by_session(out) == pytest.approx(0.3)
    assert "PACED BY THE SESSION: the phase's period is 30.0% above" in \
        obsphase.summary(out, {})


def test_phase_process_refuses_the_jax_package(monkeypatch, tmp_path):
    """The phase's process exits 3, writing nothing, if it holds JAX or
    the JAX package after the phase."""
    from bench import run
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(cfg={}, mix={}, seed=1, device="cpu")))
    monkeypatch.setattr(run, "import_port", lambda: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(obsphase, "phase", lambda *a: dict(calls=1))
    monkeypatch.setattr(run, "forbidden_modules", lambda: ["jax"])
    assert obsphase.main([str(spec)]) == 3
    assert not (tmp_path / "out.json").exists()
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    assert obsphase.main([str(spec)]) == 0
    assert json.loads((tmp_path / "out.json").read_text()) == dict(calls=1)


def test_readers_without_an_obs_phase(monkeypatch):
    """None from every reader: a record with no profiled phase, a record
    whose phase found nothing, and a program with no call spans (no
    ``flush``), which runs no phase even with a card."""
    assert set(_read(dict(trace=None)).values()) == {None}
    assert set(_read(dict(trace={}, obs=None)).values()) == {None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delattr(obs.Observability, "flush")
    rec = dict(trace={})
    assert set(_read(rec).values()) == {None} and rec["obs"] is None


def test_phase_on_the_cpu(monkeypatch):
    """The phase end to end on a small cell: a fresh program, its calls
    under a session, the session uninstalled after; on the CPU each bucket
    is eager, so ``call`` alone and no device span."""
    c = small_cell("resnet8.b32", trace_calls=3)
    monkeypatch.setattr(obsphase, "SESSION_WARMUP", 2)
    out = obsphase.phase(c.cfg, c.mix, 2 ** 31 + 7, torch.device("cpu"),
                         obs)
    assert obs.active() is None
    assert out["calls"] == 3 and out["device_calls"] == 0
    assert out["period_us"] > 0 and out["enqueue_us"] > 0
    rec = dict(obs=out, window=dict(enqueue_s=[4e-5, 5e-5]))
    line = obsphase.summary(out, rec)
    assert line.startswith("bench: obs phase 3 calls") and \
        "(window, no session: 45.00;" in line
    got = _read(rec)
    assert got.pop("call_self_host_us") > 0
    assert set(got.values()) == {None}


def test_phase_in_a_process_of_its_own():
    """``isolated`` runs the phase in a fresh interpreter and hands its
    reduction back whole."""
    c = small_cell("resnet8.b32", trace_calls=2, warmup_calls=0)
    out = obsphase.isolated(c.cfg, c.mix, 5, "cpu")
    assert out["calls"] == 2 and len(out["call_self_us"]) == 2
