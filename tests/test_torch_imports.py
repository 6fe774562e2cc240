"""``repro_torch`` stands alone: importing it and every submodule pulls in
neither ``jax`` nor any module of the JAX package ``repro``, and no source
file of the port (nor ``chip_smoke.py``) names either in an import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""

# the submodules of each slice, so that a new one cannot be missed by the
# walk (the serving-at-scale and tuning slice, the training and
# quantization slice, and the traffic and health slice, among them)
EXPECTED = {"repro_torch.serve.sched", "repro_torch.serve.engine",
            "repro_torch.tune.space", "repro_torch.tune.cost",
            "repro_torch.tune.search", "repro_torch.tune.cache",
            "repro_torch.tune.__main__", "repro_torch.launch.serve",
            "repro_torch.obs.__main__", "repro_torch.compile.compiler",
            "repro_torch.core.tree", "repro_torch.data.synthetic",
            "repro_torch.train.optimizer", "repro_torch.train.checkpoint",
            "repro_torch.train.loop", "repro_torch.quantize.observers",
            "repro_torch.quantize.calibrate", "repro_torch.quantize.qat",
            "repro_torch.quantize.export", "repro_torch.quantize.evaluate",
            "repro_torch.quantize.__main__", "repro_torch.launch.train",
            "repro_torch.obs.health", "repro_torch.obs.recorder",
            "repro_torch.obs.bundle", "repro_torch.traffic.loadgen",
            "repro_torch.traffic.slo", "repro_torch.traffic.autoscale",
            "repro_torch.traffic.degrade", "repro_torch.traffic.sim",
            "repro_torch.traffic.live", "repro_torch.traffic.__main__",
            "repro_torch.traffic.wiring"}


def test_import_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15, res.stdout
    assert EXPECTED <= set(res.stdout.splitlines()[1].split()), res.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
