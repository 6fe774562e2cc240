"""A run of the harness on the CPU with the timed path broken underneath
``CompiledModel.__call__``: ``correct`` has to come out false for every
fault a serving cell can have, and true for the sound program."""
import pytest
import torch

from bench import run
from bench.tests.small import small_cell

from repro_torch.compile import compiler


def _altered(exe, x):
    out = exe.forward(compiler._pad_rows(x, exe.batch))[:x.shape[0]].clone()
    out[-1, 3] += 0.01          # one answer altered where it is produced
    return out


class _Stale:
    """Each call returns the result of the call before it."""

    def __init__(self):
        self.last = None

    def __call__(self, exe, x):
        out = exe.forward(compiler._pad_rows(x, exe.batch))[:x.shape[0]]
        prev, self.last = self.last, out
        return out if prev is None else prev


def _half(exe, x):
    """Half of the batch computed, its rows standing in for the rest."""
    n = x.shape[0]
    out = exe.forward(compiler._pad_rows(x[:n // 2], exe.batch))[:n // 2]
    return torch.cat([out, out])[:n]


def _run(workload):
    # every slice sampled: with four slices a run visits each only a few
    # times, where a full run visits every slice hundreds of times
    cell = small_cell(workload, sample_share=1.0, warmup_calls=4)
    res = run.run_cell(cell, seed=2 ** 31 + 19, seconds=0.2, trace=False,
                       device=torch.device("cpu"), t_start=0.0)
    return run.result_line(cell, res, "cpu", 1)


def test_sound_run_is_correct():
    line = _run("resnet8.b32")
    assert line["correct"] and line["failed"] == 0
    assert list(line["checks"]) == ["logit_gap", "slots_unchecked"]
    assert line["checks"]["logit_gap"]["value"] < 1e-6
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_altered, _Stale(), _half],
                         ids=["altered", "stale", "half"])
def test_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(compiler.EagerExecutable, "__call__",
                        lambda exe, x: fault(exe, x))
    line = _run("resnet8.b32")
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > \
        line["checks"]["logit_gap"]["limit"]
