"""``python -m repro_torch.compile``, the port's compile-smoke CLI, on the
CPU against the reference CLI (``python -m repro.compile``,
``src/repro/compile/__main__.py``).

The reference CLI itself cannot run here: its ``pallas`` LM backend needs
``pallas.load``, which this jax lacks.  So its record's keys are read from
its source (the dict literals of ``smoke_one`` and ``main``), and the
port's record must carry every one of them.  On the CPU the port's
``cuda`` backend runs the kernels' plain versions, and its logits are
bitwise ``torch-int``'s; that is asserted.  Without a GPU the default
device fails with a non-zero exit and no CPU fallback."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.compile import __main__ as cli

ROOT = Path(__file__).resolve().parents[1]
REF_CLI = ROOT / "src" / "repro" / "compile" / "__main__.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_keys():
    """``(record keys, model keys, check names)`` of the reference CLI's
    JSON record, read from the dict literals its source builds it with."""
    tree = ast.parse(REF_CLI.read_text())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in ("smoke_one",
                                                               "main"):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Dict):
                    found[sub.targets[0].id] = sub.value
                elif isinstance(sub, ast.Return) and \
                        isinstance(sub.value, ast.Dict):
                    found["model"] = sub.value

    def keys(d):
        return {k.value for k in d.keys}

    return keys(found["record"]), keys(found["model"]), keys(found["checks"])


def test_reference_record_keys_are_read():
    rec, model, checks = _reference_keys()
    assert rec == {"seed", "models", "ok", "wall_s"}
    assert {"model", "family", "checks", "ok", "tasks"} <= model
    assert checks == {"bit_exact", "finite", "shape_ok", "single_trace"}


def test_cli_on_cpu_exits_0_with_the_reference_record(tmp_path, capsys):
    out = tmp_path / "smoke.json"
    assert cli.main(["--device", "cpu", "--json", str(out)]) == 0
    record = json.loads(out.read_text())
    rec_keys, model_keys, check_names = _reference_keys()
    assert rec_keys <= set(record) and record["ok"] is True
    assert record["device"] == "cpu"
    assert [m["model"] for m in record["models"]] == list(cli.SMOKE_MODELS)
    for m in record["models"]:
        assert model_keys <= set(m)
        # the reference's checks: bitwise (reported at the model level,
        # where on the card only the tolerance is a check), the rest gated
        assert check_names - {"bit_exact"} <= set(m["checks"])
        assert all(m["checks"].values()) and m["ok"]
        assert m["bit_exact"] is True and m["max_abs_dev"] == 0.0
        assert (m["seq_len"], m["batch"]) == (16, 4)
    assert {m["family"] for m in record["models"]} == {"dense", "ssm"}
    text = capsys.readouterr().out
    assert text.strip().splitlines()[-1].startswith("OK: 2 model(s) on cpu")


def test_cli_exit_code_follows_the_checks(monkeypatch):
    """A check that fails makes the exit code 1 (here the tolerance, made
    negative)."""
    monkeypatch.setattr(cli, "logit_tolerance",
                        lambda *a: torch.full((4, 1), -1.0,
                                              dtype=torch.float64))
    assert cli.main(["--device", "cpu"]) == 1


def test_cli_without_a_gpu_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "m.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.compile", "--device", "cpu",
         "--seq-len", "8", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert json.loads(out.read_text())["ok"] is True
