"""The twins of the JAX package's examples (``repro_torch.examples``),
each run on the CPU through its ``main`` (``--device cpu``): the lines
the reference's example prints (``examples/quickstart.py`` and the rest),
the analytic ones equal to the JAX package's own, and each twin's
default device the GPU, which it refuses without one."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import dataflow as jdataflow
from repro.core import graph as jgraph
from repro.core import ilp as jilp
from repro_torch.examples import (multipod_dryrun, quickstart, serve_lm,
                                  train_resnet_cifar)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_prints_the_reference_lines(capsys):
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[graph] residual Adds: 3 -> 0" in out
    g1 = jgraph.optimize(jgraph.resnet8_graph())
    want = [r["ratio"] for r in jgraph.skip_buffer_report(
        jgraph.resnet8_graph(), g1)]
    assert res["skip"] == want and "R_sc = 0.50" in out
    assert "[train] step 30: loss=" in out and res["train"]["acc"] > 0.1
    assert "[int8] integer-graph accuracy" in out
    assert res["bit_exact"]
    assert "bit-exact with the integer graph (torch-int): True" in out
    assert res["served"] == 12 and "ResNetEngine served 12 images" in out
    for plat, (fps, paper) in res["ilp"].items():
        sol = jilp.predict_fps(jdataflow.resnet8_layers(), plat)
        assert fps == sol.fps and abs(fps - paper) <= 0.15 * paper
        assert f"[ilp] resnet8 on {plat}: predicted {fps:.0f} FPS" in out


def test_train_resnet_cifar_runs_the_accuracy_flow(capsys, monkeypatch,
                                                   tmp_path):
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)
    res = train_resnet_cifar.main([
        "--device", "cpu", "--steps", "4", "--qat-steps", "2", "--batch",
        "16", "--eval-n", "32", "--calib-batches", "1", "--ckpt-dir",
        str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "float metrics:" in out and "qat metrics:" in out
    assert res["export"]["bit_exact"]
    assert res["export"]["backends"] == ("cuda", "cuda-stream", "torch-int")
    assert res["source"] == "synthetic" and res["eval_n"] == 32
    assert "eval[synthetic n=32]: float top1=" in out
    assert "int8(cuda) top1=" in out and "retraces=1" in out
    assert os.listdir(tmp_path / "ck")          # the loop checkpointed


@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
def test_serve_lm_prints_tokens_and_ticks(capsys, int8):
    res = serve_lm.main(["--device", "cpu"] + (["--int8-kv"] if int8
                                               else []))
    out = capsys.readouterr().out
    head = f"llama3.2-3b{' (int8 KV)' if int8 else ''}: 72 tokens / "
    assert out.startswith(head) and out.rstrip().endswith("s")
    assert res["ticks"] > 0 and all(len(o) == 12 for o in res["outputs"])


def test_multipod_dryrun_prints_the_cell():
    """One cell a process (it starts the ``fake`` group): internvl2-1b
    decode_32k, seconds of host time."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multipod_dryrun",
         "--arch", "internvl2-1b", "--shape", "decode_32k", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=600,
        cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "cell: internvl2-1b x decode_32k on 512 chips (2 pods)"
    assert lines[1].startswith("  compute  ") and "->" in lines[1]
    assert lines[2].startswith("  collectives: {'all-reduce': ")
    assert "flops/device over model flops/device: " in lines[3]
    # the decode step's attention splits gcd(14 heads, 16) = 2 ways, its
    # MLP and (tied table by its d shard) logits 16; nothing repeats
    assert "split over 'model': {'attention': 2, 'logits': 16, 'mlp': 16}, " \
        "whole on every 'model' rank: []" in lines[3]
    assert lines[4].startswith("  fits 80G HBM: True (temp ")


@pytest.mark.parametrize("mod", [quickstart, train_resnet_cifar, serve_lm,
                                 multipod_dryrun],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_twins_default_to_the_gpu(mod):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
