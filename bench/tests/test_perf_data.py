"""The benchmark as data: every name in BENCHMARK.json resolves to its
files, names and units keep to their characters, and the harness refuses
to run without a card."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    text = [x["why"] for k in ("configs", "workloads") for x in BENCH[k]]
    text += [m["layer"] for m in BENCH["per_layer"]]
    text += [c["source"] for c in BENCH["configs"]]
    for t in text:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = cells.cell(BENCH, workload)
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.cfg["name"]]
    assert conf["file"].startswith("bench/configs/")
    assert cell.cfg["source"] == conf["source"]
    for part in ("models", "reference"):
        assert (cells.BENCH / part / f"{cell.cfg['family']}.py").exists()
    assert cell.mix["pool_images"] % cell.mix["batch"] == 0
    assert cell.mix["depth"] >= 1
    assert cell.mix["batch"] in cell.cfg["batch_sizes"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                   "images_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_every_config_used_and_metric_listed():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= names
    readers = {p.stem for p in (cells.BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}


def test_files_named_from_name_characters():
    for p in cells.BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        for part in p.relative_to(cells.ROOT).parts:
            assert NAME.match(part), p


def _run(root):
    code = ("import runpy, sys; sys.argv = ['bench/run.py', "
            "'--workload', 'resnet8.b32', '--seed', '1', '--seconds', '1']; "
            "runpy.run_path('bench/run.py', run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """On this CPU machine the harness exits non-zero and prints nothing on
    standard output: no fallback to the CPU."""
    proc = _run(cells.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with only BENCHMARK.json and bench/ has no port to run:
    exit non-zero, no result (the card's presence faked)."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: True; "
         "torch.cuda.device_count = lambda: 1; import runpy, sys; "
         "sys.argv = ['bench/run.py', '--workload', 'resnet8.b32', "
         "'--seed', '1', '--seconds', '1']; "
         "runpy.run_path('bench/run.py', run_name='__main__')"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "repro_torch" in proc.stderr
