"""Per-task kernel profiling: measured device time vs modeled HBM/VMEM bytes.

The port's counterpart of ``repro.obs.profile`` for the conv configs.  The
paper's evaluation is a per-layer accounting (buffer bytes, DSP/BRAM,
latency per conv task — Tables 3-4); here each lowered task of the
``cuda`` or ``cuda-stream`` backend — the ``conv_stem`` launch, every
``resblock_fused`` block, or each ``block_chain`` — is timed as the
prepared launch the lowered forward runs (``features.steps``), and paired
with the *modeled* traffic of ``core.dataflow``.  Every profile row
carries:

* ``wall_us``       — the task's time (volatile): on a CUDA device, its
  device time by CUDA-graph replay (``reps`` launches captured in one
  graph, the median replay over ``reps``); on the CPU, the best-of-``reps``
  wall time of the plain version;
* ``hbm_bytes`` / ``vmem_bytes`` — modeled traffic/footprint
  (deterministic), the reference's formulas at the task's own batch and
  batch tile, so they equal the JAX package's numbers for the same task;
* ``gbps``          — achieved HBM bandwidth implied by the two;
* ``vs_roofline``   — measured time over the memory-bound lower bound at
  ``REFERENCE_HBM_GBPS``: 1.0 is roofline-perfect, larger is slower.  On
  the CPU the ratio only ranks tasks; it is no device number.

LM configs are not profiled yet (ROADMAP item A8.3, the LM profile): the
reference's LM leg reads TPU tile knobs (``bm``/``bq``/``bd``) that the
port's kernels do not have.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.compile import lowering
from repro_torch.compile.backends import get_backend
from repro_torch.compile.compiler import resolve_device
from repro_torch.compile.params import ensure_typed
from repro_torch.core import dataflow
from repro_torch.kernels.common import graph_ms

__all__ = ["TaskProfile", "profile_tasks", "REFERENCE_HBM_GBPS"]

# Reference memory bandwidth for the roofline denominator: the HBM3 of one
# NVIDIA H100 SXM, 3.35 TB/s (NVIDIA data sheet).
REFERENCE_HBM_GBPS = 3350.0

# timed replays of the graph (the median is kept)
_REPLAYS = 5


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    """One profiled task: measured time + modeled bytes."""

    task: str                 # "stem", "b3", "stem+b0+b1"
    kind: str                 # "stem" | "block" | "chain"
    batch: int
    batch_tile: int           # images a unit of work (a thread block)
    wall_us: float            # volatile (a measurement)
    hbm_bytes: int            # modeled, deterministic
    vmem_bytes: int           # modeled, deterministic

    @property
    def gbps(self) -> float:
        if self.wall_us <= 0:
            return 0.0
        return self.hbm_bytes / (self.wall_us * 1e-6) / 1e9

    @property
    def vs_roofline(self) -> float:
        """Measured / memory-bound-lower-bound at REFERENCE_HBM_GBPS."""
        bound_us = self.hbm_bytes / (REFERENCE_HBM_GBPS * 1e9) * 1e6
        if bound_us <= 0:
            return 0.0
        return self.wall_us / bound_us

    def to_dict(self) -> dict:
        return dict(task=self.task, kind=self.kind, batch=self.batch,
                    batch_tile=self.batch_tile, wall_us=self.wall_us,
                    hbm_bytes=self.hbm_bytes, vmem_bytes=self.vmem_bytes,
                    gbps=self.gbps, vs_roofline=self.vs_roofline)


def _device_us(fn, reps: int) -> float:
    """Device microseconds of one ``fn()``: ``reps`` calls captured into one
    CUDA graph, the median replay over ``reps`` (``kernels.common.graph_ms``;
    host launch overhead excluded, the launch counters left as found)."""
    return graph_ms(fn, reps, _REPLAYS) * 1e3


def _host_us(fn, reps: int) -> float:
    """Best-of-``reps`` wall microseconds of ``fn()`` on the CPU, after one
    unmeasured call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _attach(ob, cfg_name: str, tp: TaskProfile) -> None:
    """Record a profile into an observability session: a ``cat="kernel"``
    span (ts from the session clock — deterministic; dur is the measurement
    — volatile, zeroed by strip_volatile exports) plus deterministic
    modeled-bytes gauges.  Measured numbers stay OUT of the metrics
    registry so ``--metrics-out`` files remain byte-stable."""
    t0 = ob.now()
    ob.trace.span(f"{cfg_name}/{tp.task}", cat="kernel", track="kernels",
                  t0=t0, t1=t0 + tp.wall_us * 1e-6,
                  kind=tp.kind, batch=tp.batch, batch_tile=tp.batch_tile,
                  hbm_modeled_bytes=tp.hbm_bytes,
                  vmem_modeled_bytes=tp.vmem_bytes,
                  wall_us=round(tp.wall_us, 3),
                  gbps=round(tp.gbps, 4),
                  vs_roofline=round(tp.vs_roofline, 2))
    ob.metrics.counter(
        "kernel_profiles_total", "profiled kernel tasks").inc(
            kind=tp.kind, model=cfg_name)
    ob.metrics.gauge(
        "kernel_hbm_modeled_bytes",
        "modeled HBM traffic per task (core.dataflow)").set(
            tp.hbm_bytes, task=tp.task, model=cfg_name)
    ob.metrics.gauge(
        "kernel_vmem_modeled_bytes",
        "modeled VMEM footprint per task (core.dataflow)").set(
            tp.vmem_bytes, task=tp.task, model=cfg_name)
    ob.profiles.append(tp)


def profile_tasks(cfg, qparams, backend: str = "cuda", batch: int = 4,
                  reps: int = 2, seed: int = 0, ob=None,
                  device=None) -> List[TaskProfile]:
    """Profile every lowered task of ``cfg`` under ``backend`` on
    ``device`` (default ``cuda``; ``"cpu"`` times the plain versions).

    ``backend="cuda"`` profiles the per-block pipeline (one ``conv_stem``
    row + one ``resblock_fused`` row per block); ``backend="cuda-stream"``
    the chains of its default partition (a chain cut down to one block
    without the stem runs ``resblock_fused``, a stem left unfused
    ``conv_stem``, as in the backend).  Each task runs the prepared launch
    of the lowered forward on seeded uint8 activations with the real
    quantized weights, so it executes the production arithmetic.  When
    ``ob`` is given, every profile is attached to its trace/metrics (see
    :func:`_attach`)."""
    if backend not in ("cuda", "cuda-stream"):
        raise ValueError(
            f"profile_tasks supports the kernel backends "
            f"('cuda', 'cuda-stream'), not {backend!r}")
    if lowering._is_lm_cfg(cfg):
        raise ValueError(
            f"profile_tasks covers conv configs only; the LM profile of "
            f"{cfg.name!r} is ROADMAP item A8.3")

    dev = resolve_device(device)
    params = ensure_typed(qparams).to(dev)
    be = get_backend(backend)
    g = lowering.optimized_graph(cfg)
    steps = list(be.conv_features(g, cfg, params).steps)
    plan = lowering.plan_model(g, params)
    chains = lowering.plan_chains(plan, cfg, cuts=be.cuts,
                                  fuse_stem=be.fuse_stem,
                                  smem_budget=be.smem_budget)
    shapes = dataflow.resnet_block_shapes(cfg.blocks_per_stage,
                                          cfg.base_width, cfg.img)
    stem_layer = dataflow.resnet_layers(cfg.blocks_per_stage, cfg.base_width,
                                        cfg.img)[0]
    rng = np.random.default_rng(seed)
    time_us = _device_us if dev.type == "cuda" else _host_us

    def u8(h, w, c):
        return torch.from_numpy(rng.integers(
            0, 256, size=(batch, h, w, c), dtype=np.uint8)).to(dev)

    def tile(config) -> int:
        return config.batch_tile if config is not None else 1

    def stem_row(step, config):
        x = u8(cfg.img, cfg.img, dataflow.STEM_CIN)
        bt = tile(config)
        cb = config.cout_block if config is not None else 0
        return TaskProfile(
            task="stem", kind="stem", batch=batch, batch_tile=bt,
            wall_us=time_us(lambda: step(x), reps),
            hbm_bytes=dataflow.conv_task_hbm_bytes(stem_layer, batch, bt),
            vmem_bytes=dataflow.conv_task_vmem_bytes(stem_layer, bt, cb))

    def block_row(step, task):
        shp = shapes[task.index]
        x = u8(shp.h, shp.w, shp.ich)
        bt = tile(task.config)
        return TaskProfile(
            task=f"b{task.index}", kind="block", batch=batch, batch_tile=bt,
            wall_us=time_us(lambda: step(x), reps),
            hbm_bytes=dataflow.resblock_task_hbm_bytes(
                shp.h, shp.w, shp.ich, shp.och, batch, bt,
                downsample=task.has_ds, stride=task.stride),
            vmem_bytes=dataflow.resblock_task_vmem_bytes(
                shp.h, shp.w, shp.ich, shp.och, bt,
                downsample=task.has_ds, stride=task.stride))

    def chain_row(step, chain):
        cshapes = [shapes[t.index] for t in chain.blocks]
        stem_och = cfg.base_width if chain.stem is not None else 0
        first = cshapes[0]
        x = u8(first.h, first.w, dataflow.STEM_CIN if stem_och
               else first.ich)
        bt = tile(chain.config)
        return TaskProfile(
            task=chain.describe(), kind="chain", batch=batch, batch_tile=bt,
            wall_us=time_us(lambda: step(x), reps),
            hbm_bytes=dataflow.chain_task_hbm_bytes(
                cshapes, batch, bt, stem_och=stem_och),
            vmem_bytes=dataflow.chain_task_vmem_bytes(
                cshapes, bt, stem_och=stem_och))

    out: List[TaskProfile] = []
    if not chains or chains[0].stem is None:
        out.append(stem_row(steps.pop(0), plan.stem.config))
    for chain, step in zip(chains, steps, strict=True):
        if len(chain.blocks) == 1 and chain.stem is None:
            out.append(block_row(step, chain.blocks[0]))
        else:
            out.append(chain_row(step, chain))

    if ob is not None:
        for tp in out:
            _attach(ob, cfg.name, tp)
    return out
