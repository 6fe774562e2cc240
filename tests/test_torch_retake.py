"""``chip_smoke.py``'s one rule for every traced check (``traced_check``),
on a stub profiler: ``chip_smoke`` imports without a card, and its
``traced_launches`` is replaced by one that hands out scripted kernel
counts, one session a call.

  * a session short of the plan is taken again (through ``retake`` where
    given), up to ``PAR_TRACES`` sessions, and every session's counts come
    back; the first session's result and counters are the ones returned;
  * a session over the plan, or with a kernel of the port the plan lacks,
    fails at once, with no retake;
  * sessions short every time fail after ``PAR_TRACES``;
  * the final session must equal the counters as well as the plan.
"""
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PLAN = dict(conv_stem=2, resblock_fused=18, block_chain=0, conv2d_int8=0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    yield mod
    del sys.modules[spec.name]


class Script:
    """Stub sessions: each ``traced_launches(fn)`` runs ``fn`` and returns
    the next scripted profiler counts; the counters read ``counters``
    (the plan unless a test says otherwise)."""

    def __init__(self, seen, counters=None):
        self.seen = list(seen)
        self.counters = counters or [dict(PLAN)] * len(self.seen)
        self.calls = self.zeroed = 0
        self.ran = []

    def traced(self, fn):
        out = fn()
        ran = dict(PLAN, **self.seen[self.calls])
        self.calls += 1
        return out, ran, {}

    def zero(self):
        self.zeroed += 1

    def read(self):
        return dict(self.counters[self.calls - 1])


def _run(smoke, monkeypatch, script, retake=True):
    monkeypatch.setattr(smoke, "traced_launches", script.traced)
    runs = []

    def run():
        runs.append("run")
        return "first"

    def again():
        runs.append("retake")
        return "again"

    out = smoke.traced_check(run, script.zero, script.read,
                             lambda res, launches: PLAN, "stub",
                             again if retake else None)
    return out, runs


def test_plan_met_at_once(smoke, monkeypatch):
    s = Script([{}])
    (first, launches, _, sessions), runs = _run(smoke, monkeypatch, s)
    assert first == "first" and launches == PLAN and runs == ["run"]
    assert sessions == [PLAN] and s.zeroed == 1


def test_short_session_is_retaken(smoke, monkeypatch):
    short = dict(resblock_fused=17)
    s = Script([short, short, {}])
    (first, launches, _, sessions), runs = _run(smoke, monkeypatch, s)
    assert runs == ["run", "retake", "retake"]
    assert first == "first" and launches == PLAN
    assert [x["resblock_fused"] for x in sessions] == [17, 17, 18]
    assert s.zeroed == 3              # counters zeroed before each session


def test_stateless_run_is_its_own_retake(smoke, monkeypatch):
    s = Script([dict(conv_stem=1), {}])
    _, runs = _run(smoke, monkeypatch, s, retake=False)
    assert runs == ["run", "run"]


@pytest.mark.parametrize("seen", [dict(resblock_fused=19),
                                  dict(conv2d_int8=1),
                                  dict(conv_stem=1, resblock_fused=19)],
                         ids=["over", "outside-the-plan", "short-and-over"])
def test_over_the_plan_fails_at_once(smoke, monkeypatch, seen):
    s = Script([seen, {}])
    with pytest.raises(AssertionError, match="more launches than the plan"):
        _run(smoke, monkeypatch, s)
    assert s.calls == 1


def test_short_every_time_fails(smoke, monkeypatch):
    s = Script([dict(conv_stem=1)] * smoke.PAR_TRACES)
    with pytest.raises(AssertionError, match="fell short of the plan"):
        _run(smoke, monkeypatch, s)
    assert s.calls == smoke.PAR_TRACES


def test_final_session_must_equal_the_counters(smoke, monkeypatch):
    s = Script([dict(conv_stem=1), {}],
               counters=[PLAN, dict(PLAN, conv_stem=3)])
    with pytest.raises(AssertionError, match="the counters say"):
        _run(smoke, monkeypatch, s)
