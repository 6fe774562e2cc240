#!/usr/bin/env python3
"""GPU smoke test of ``repro_torch``, the PyTorch/CUDA port.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each:

  1. device   — requires a CUDA GPU (exits 2 without one); prints the card's
                name and power limit as nvidia-smi reports them.
  2. build    — compiles the seven kernels (conv_stem, resblock_fused,
                block_chain, matmul_int8, flash_attention, selective_scan,
                conv2d_int8) from ``src/repro_torch/kernels/csrc``, one
                nvcc each, all started together; prints ptxas registers
                and spills, and the IMMA (int8 tensor-core) and IDP (dp4a)
                instructions in the SASS of the block kernels and the two
                conv kernels: IMMA in resblock_fused, block_chain and
                conv2d_int8, no IDP in resblock_fused (block_chain keeps
                dp4a for its fused stem only), IDP in conv_stem.
  3. kernels  — each conv kernel against its plain PyTorch version on the
                card, bitwise (``torch.equal``): conv_stem at N = 1, 8, 32
                and 256 for shifts > 0, = 0, < 0, every launch on the
                banded path (``conv_stem_op.launches_by_path``), timed at
                32 and 256 beside an empty kernel of the same grid launched
                the same way (the launch floor); resblock_fused at every
                ResNet20 block shape for skip shifts > 0, = 0, < 0 at
                buckets 1, 8, 32 and 256, each at the row band
                ``tune.space.block_band_rows`` picks for the card's SMs;
                block_chain on the
                ResNet20 chain with the stem fused (N = 1, 8, 32 at
                batch_tile 1 and 2, N = 256), the ResNet8 chain (N = 1, 8,
                32) and the four narrow chains of tests/test_kernels.py at
                batch_tile 1 and 2, skip shifts > 0, = 0, < 0, each at the
                split ``tune.space.chain_split`` picks from the clusters
                the card runs at once (``cudaOccupancyMaxActiveClusters``),
                with the kernel's shared memory equal to the planner's
                formula at that split.  In every case at
                least a fifth of the outputs lie strictly inside (0, 255).
                Device time (``ms``, CUDA-graph replay) of the main path's
                call form (the launch prepared at lower time), eager call
                time with host launch overhead (``call_ms``), the direct
                op's device time (``op_ms``: it packs the weights every
                call), the plain version's device time, the roofline bound,
                TOP/s and share of the bound, at the main path's shapes
                (batch 32), with thread blocks, shared memory and the SMs
                used at buckets 1, 8 and 32 (each thread block's ``%smid``
                recorded in one checked launch, distinct values counted),
                and the host microseconds of one block_chain call, direct
                op against prepared launch.
  4. serve    — full-width ResNet20 and ResNet8 from the port's own
                ``init_params(seed) -> fold_params -> quantize_params``,
                requests served through ``ResNetEngine`` with buckets
                (1, 8, 32) on the ``cuda`` backend and then on the
                ``cuda-stream`` backend, each bucket a CUDA graph
                (``CompiledModel``): one capture and one executable for
                each bucket used, in the served model and its
                ``torch-int`` shadow; the served run traced by
                ``torch.profiler`` (the buckets it uses built first, as a
                server does at start), whose kernel events (CUPTI reports
                the kernels of each graph replay) match the backend's
                launch plan once a bucket run, as do the wrappers'
                counters (a replay adds what its capture counted); the
                u8 maps of
                the padded bucket batches bitwise equal to the
                ``torch-int`` backend's, the served logits bitwise the
                eager lowered forward's on the same batches and within
                1e-5 of ``torch-int`` with equal argmax; a second call of
                a bucket leaves the first result unchanged;
                ``run_placed(x, cuda:0)`` bitwise the default path.  At
                bucket 32: the served call (copy in, replay, clone), the
                bucket's graph replayed back to back (device time), the
                eager lowered forward, the served call's idle share;
                then the eager forward of both backends timed in turns.
  5. profile  — ``torch.profiler`` over five ResNet20 bucket-32 served
                calls (graph replays) of each backend.
  5a. sharded serve — full-width ResNet20 through ``ShardedResNetEngine``
                with a replica on every card, buckets (1, 8, 32), 512
                requests with 5 ms deadlines under a 1 ms coalescing
                window, on ``cuda`` and ``cuda-stream``: the pool built
                first (one capture of each bucket on each card, never
                again), then the same images in seeded bursts, traced
                (kernel events = bucket runs x plan, as the counters) and
                timed, and open-loop at 20,000 images/s; every
                micro-batch's logits bitwise ``ResNetEngine``'s model on
                the same batch, the whole run against ``ResNetEngine``
                serving the same images; images/s, queue-wait and compute
                p50/p99, deadlines met, buckets used.
  5a'. traffic — ``repro_torch.traffic`` and ``obs.health`` with ResNet20
                (``init_params(seed)``) as the primary and ResNet8
                (``init_params(seed + 1)``) as the degrade variant:
                (a) the traffic CLI's virtual-time simulation (bursty
                2,400/s for 0.5 s, the default classes, autoscaling 1..4
                replicas, the paper's FPGA service rates) with
                ``cuda-stream`` models at bucket 8 and a health monitor
                writing bundles: every dispatch bitwise the eager forward
                and within 1e-5 of ``torch-int``, each request served its
                row, the report equal to a run with no model, alert log
                and bundles equal across two runs, ``block_chain``
                launches = dispatches x plan; (b) ``LiveTrafficRunner`` over
                ``ShardedResNetEngine`` on ``cuda`` (buckets 1, 8, 32, 1 ms
                window, alerts actuating): steady Poisson 20,000/s for 0.5
                s, the same with no obs session, and on-off bursts at
                120,000/s (2/3/5 ms classes); every dispatch bitwise
                ``ResNetEngine``'s model on its batch, every logit bitwise
                ``ResNetEngine``'s for its image and within 1e-5 of
                ``torch-int``, submitted =
                served + dropped per class, the strict class never degraded
                or dropped, the ``slo_*`` counters equal to the report,
                bundles and alert logs parsed, ``conv_stem`` and
                ``resblock_fused`` launches = bucket runs x plan; images/s,
                hit rates, waits, alerts printed; (c) one ``launch.serve``
                call with the traffic flags, its metrics, alert log,
                bundles and trace parsed.
  5b. tune    — ``tune.search`` for ResNet20 at bucket 32 on both
                backends with timing on the card and validation
                (``REPRO_TUNE_CACHE`` in a temporary directory): the winner
                measured (``source == "device"``; a fallback fails), a
                second search answered from the cache, the tuned model
                bitwise with ``torch-int`` at 37, 1 and 8 images; every
                config the space enumerates (the stem's and each block
                shape's bands, the chain's (batch_tile, split) pairs the
                card co-schedules) at bucket 32 bitwise with the kernel's
                plain version, its shared memory equal to the Python
                formula; the candidates' times, the tuned and default
                served images/s interleaved, and the tuned kernels' times
                beside their rules'.
  5c. task profile — ``obs.profile.profile_tasks`` for ResNet20 at batch
                32 on both backends with an obs session: a stem row and
                nine block rows on ``cuda``, one chain row on
                ``cuda-stream``; the block rows' sum within 25% of the
                kernels phase's resblock_fused time and the chain row
                within 25% of block_chain's; ``vs_roofline`` per task at
                3,350 GB/s; the session's metrics text, parsed back.
  5d. conv2d — conv2d_int8, the general int8 conv (off the serving path:
                its launches there are counted and are 0), bitwise against
                its plain version on the sweep of tests/test_kernels.py,
                the skip init, out_shift > 0, = 0 and < 0, ReLU on and off,
                int32 output and uint8 input, then on ResNet20's 20 conv
                layers at batch 32 with s8 input (a fifth of the
                requantized outputs strictly inside their clip range);
                every ResNet20 layer and the kernels_micro shape on the
                tensor-core path (``conv2d_int8_op.launches_by_path``);
                per layer its time, bound, TOP/s and path, and at the
                kernels_micro shape.
  5e. train  — ResNet20 at full width (16/32/64), CIFAR-10 shapes, batch
                128 on ``SyntheticCifar`` (nothing downloaded), through the
                port's training and quantization flow: 60 float steps of
                ``train.loop.run`` (``sgdm(lr=0.1, warmup=6)``, checkpoints
                in a temporary directory; the loss finite and falling),
                the resume check in deterministic mode (10 steps straight
                against 5 + checkpoint + resume, bitwise), PTQ with the
                percentile observer on ``calibration_batches(4, 128)``,
                ``validate_export`` bitwise across ``cuda``, ``cuda-stream``
                and ``torch-int``, the calibration JSON read back, 20 QAT
                steps (``fine_tune``), re-calibration and the gate again,
                then top-1 on a 1,024-image ``synthetic_eval_set`` through
                ``ResNetEngine`` on the three backends and
                ``ShardedResNetEngine`` on ``cuda`` (identical, one capture
                a bucket) against ``evaluate_float``; the launch counters,
                zeroed before the evaluation, show ``conv_stem``,
                ``resblock_fused`` and ``block_chain`` replayed once a
                bucket run.  Step ms, images/s, QAT step ms, calibration
                seconds, eval images/s, float / PTQ / QAT top-1.
  6. LM kernels — matmul_int8 bitwise against its plain version at every
                projection shape of gemma-2b and falcon-mamba-7b at M =
                2048 (bucket 4, S = 512) and 512, B as (K, N) and packed
                (N, K), acc_init full, broadcast (row stride 0) and none,
                every launch on the wgmma path; a wrap case (acc_init near
                +-2^31); ragged shapes (N = 200, K = 30, M = 129) on the
                path their shape picks; per shape the generic time (full
                init) and the main path's call form (packed B, broadcast
                bias) with their bounds, TOP/s, tiles, split-K, shared
                memory and ptxas registers; flash_attention at gemma-2b's shape within
                2e-5 (causal, non-causal, Sq = 128 < Sk, KV = H, KV = 2,
                head dims 64 and 128, Sq and Sk not tile multiples, and
                bf16 within 2e-2), with its occupancy, ptxas report and
                achieved TFLOP/s; selective_scan at falcon-mamba-7b's shape from a
                nonzero state within 1e-5, with its threads, warps an SM
                and registers.  Times as in phase 3, plus the one PyTorch
                call computing the same function (``library_ms``:
                ``torch._int_mm`` + init with B row- and column-major, the
                faster of the two; SDPA).
  7. LM serve — gemma-2b (18 layers) and falcon-mamba-7b (64 layers) at
                published width, weights from ``init_lm_params(seed)`` on
                the card: 6 token requests through ``ResNetEngine`` on
                ``cuda`` with buckets (1, 4) and a ``torch-int`` shadow,
                each bucket a CUDA graph (one capture a bucket used);
                launches (profiler and counters) against the plan, every
                matmul on the wgmma path;
                every task replayed on
                ``cuda`` and ``torch-int`` on the same inputs (matmul
                accumulators and outputs bitwise, attention and scan within
                their tolerances and one int8 step); the served logits
                bitwise the eager lowered forward's, and within the
                bound carried from the final hidden states
                (``lm_params.logit_tolerance``) of ``torch-int``; the share
                of hidden int8 values that differ, argmax agreement, and
                how far one int8 step travels (``one_step_flip_*``); the
                replay and placement checks of phase 4; tokens/s and ms
                of the served call, the graph and the eager forward, idle
                shares; a profiler pass over one served call each.
  8. the ``{"kernels": [...], "serve": {...}, "train": {...},
     "traffic": {...}}`` line (rows 1-3 carry their tuned knob and time
     beside the rule's and their launches in the train phase's evaluation
     and in the traffic phase; ``serve`` the sharded and tuned
     summaries), then
     ``{"ok": true, "device": ...}``.

Every phase's line carries ``card``: the card's name and power limit as
nvidia-smi reports them.

Any failure raises, and the script exits non-zero without the last line.
"""
import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.compile import backends as BK  # noqa: E402
from repro_torch.compile import (compile_model,  # noqa: E402
                                 get_backend, get_task_impl,
                                 hidden_out_spec, init_lm_params, lm_config,
                                 lower_forward, plan_lm)
from repro_torch.compile import lowering  # noqa: E402
from repro_torch.compile.backends import softplus  # noqa: E402
from repro_torch.compile.compiler import GraphExecutable  # noqa: E402
from repro_torch.compile.lm_params import logit_tolerance  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dataflow as df  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.quant import (dequantize,  # noqa: E402
                                   percentile_linear, requantize_shift,
                                   shift_align)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data.synthetic import SyntheticCifar  # noqa: E402
from repro_torch.kernels.common import conv_i32, requant_u8  # noqa: E402
from repro_torch.kernels.common import (read_launches,  # noqa: E402
                                        write_launches)
# device time of one call: ``reps`` calls captured into one CUDA graph,
# the median of five replays over ``reps`` (host launch overhead excluded)
from repro_torch.kernels.common import \
    graph_ms as device_ms  # noqa: E402
from repro_torch.kernels.conv_stem import ops as stem_ops  # noqa: E402
from repro_torch.kernels.conv_stem.ops import (  # noqa: E402
    BAND_THREADS, band_smem_bytes, conv_stem_op, empty_launch,
    stem_band_rows, stem_path)
from repro_torch.kernels.conv_stem.ref import conv_stem_ref  # noqa: E402
from repro_torch.kernels.conv2d_int8.ops import (  # noqa: E402
    conv2d_int8_op, conv_path, conv_tiles, out_hw)
from repro_torch.kernels.conv2d_int8.ref import \
    conv2d_int8_plain  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attn_tiles, flash_attention_op)
from repro_torch.kernels.flash_attention.ops import \
    blocks_per_sm as flash_blocks_per_sm  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    smem_bytes as flash_smem_bytes  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_plain  # noqa: E402
from repro_torch.kernels.matmul_int8.ops import (  # noqa: E402
    matmul_int8_op, matmul_path, matmul_tiles, pack_weight)
from repro_torch.kernels.matmul_int8.ops import \
    smem_bytes as mm_smem_bytes  # noqa: E402
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref  # noqa: E402
from repro_torch.kernels.megakernel import ops as chain_ops  # noqa: E402
from repro_torch.kernels.megakernel.ops import (  # noqa: E402
    ChainBlockSpec, ChainLaunch, block_chain_op)
from repro_torch.kernels.megakernel.ref import block_chain_ref  # noqa: E402
from repro_torch.kernels.resblock_fused.ops import (  # noqa: E402
    ResblockLaunch, resblock_fused_op, smem_bytes)
from repro_torch.kernels.resblock_fused.ref import resblock_ref  # noqa: E402
from repro_torch.kernels.selective_scan.ops import (  # noqa: E402
    scan_threads, selective_scan_op)
from repro_torch.kernels.selective_scan.ref import \
    selective_scan_ref  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.obs import (FlightRecorder, HealthMonitor,  # noqa: E402
                             alert_log_path, default_rules, read_bundle)
from repro_torch.obs import runtime as obs_runtime  # noqa: E402
from repro_torch.obs.__main__ import (load_alerts,  # noqa: E402
                                      load_chrome_trace)
from repro_torch.obs.metrics import parse_text  # noqa: E402
from repro_torch.obs.profile import REFERENCE_HBM_GBPS  # noqa: E402
from repro_torch.obs.profile import profile_tasks  # noqa: E402
from repro_torch.serve import (ImageRequest, ResNetEngine,  # noqa: E402
                               ShardedResNetEngine)
from repro_torch.quantize import (CalibrationResult,  # noqa: E402
                                  QuantRecipe, calibration_batches,
                                  evaluate_compiled, evaluate_engine,
                                  evaluate_float,
                                  fine_tune, ptq_quantize, qat_loss,
                                  synthetic_eval_set, validate_export)
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch import tune as T  # noqa: E402
from repro_torch.serve.sched import FakeClock  # noqa: E402
from repro_torch.traffic import (PAPER_FPS, AutoscaleConfig,  # noqa: E402
                                 Autoscaler, LiveTrafficRunner,
                                 OnOffProcess, OverloadRouter, ServiceModel,
                                 SimServer, TrafficSim, make_process,
                                 parse_classes)
from repro_torch.tune import space  # noqa: E402
from repro_torch.tune.config import KernelConfig  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
LOGIT_ATOL = 1e-5
MIN_UNSATURATED = 0.2    # share of kernel outputs strictly inside (0, 255)
BUCKET = 32
BUCKETS = (1, 8, 32)   # the engine's buckets
REQUESTS = 37     # one full bucket of 32, then 5 padded up to bucket 8
REPS = 50         # timed calls per measurement
# ResNet20's residual block shapes (H, Cin, Cout, stride) and how many of
# each one forward runs
RESNET20_BLOCKS = [((32, 16, 16, 1), 3), ((32, 16, 32, 2), 1),
                   ((16, 32, 32, 1), 2), ((16, 32, 64, 2), 1),
                   ((8, 64, 64, 1), 2)]
# the narrow chains of tests/test_kernels.py: links of (cin, cout, stride)
# on a 16x16 input
NARROW_CHAINS = [[(8, 8, 1)], [(8, 8, 1), (8, 8, 1)],
                 [(8, 8, 1), (8, 16, 2), (16, 16, 1)],
                 [(4, 8, 2), (8, 16, 2)]]
SKIP_CYCLES = [(3, 0, -2), (0, -2, 3), (-2, 3, 0)]


# the card's name and power limit as nvidia-smi reports them, set by the
# device phase and printed in every phase's line beside its numbers
CARD = None


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "card": CARD, **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def call_ms(fn, reps):
    """Median CUDA-event time of one eager call after warm-up.  The device
    waits for the host between the two events, so this includes the host's
    launch overhead: what a caller of the eager path sees."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(bytes_moved, ops, peak=INT8_OPS_PER_S):
    """Least time in ms the card could take: bytes over HBM bandwidth vs
    operations over their peak (default: int8 on the tensor cores), the
    larger of the two."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, ref):
    return int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def device_phase():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def build_phase():
    t0 = time.perf_counter()
    secs = _build.build(force=True)
    ptxas = {k: [ln.strip() for ln in _build.build_log(k).splitlines()
                 if "registers" in ln or "spill" in ln]
             for k in _build.KERNELS}
    sass = {k: sass_counts(k) for k in ("resblock_fused", "block_chain",
                                        "conv_stem", "conv2d_int8")}
    for k in ("resblock_fused", "block_chain", "conv2d_int8"):
        check(sass[k]["IMMA"] > 0, f"{k}: no IMMA (int8 tensor-core) "
                                   f"instruction in its SASS")
    check(sass["resblock_fused"]["IDP"] == 0,
          "resblock_fused: dp4a (IDP) left in its SASS")
    check(sass["conv_stem"]["IDP"] > 0, "conv_stem: no dp4a (IDP) in its SASS")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_kernel=secs, ptxas=ptxas, sass=sass)
    return sass


def sass_counts(name):
    """Counts of the int8 tensor-core (IMMA) and dp4a (IDP) instructions in
    the SASS of kernel ``name``'s built library (``cuobjdump -sass``)."""
    exe = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    ops = []
    for ln in text.splitlines():
        # "/*0c40*/  @P0 IMMA.16832.U8.S8 R4, R8.ROW, R12.COL, R4 ; /* 0x.. */"
        if ln.strip().startswith("/*") and "*/" in ln:
            words = [w for w in ln.split("*/", 1)[1].split()
                     if not w.startswith("@")]
            if words:
                ops.append(words[0])
    return {op: sum(o.startswith(op) for o in ops) for op in ("IMMA", "IDP")}


def check_unsaturated(out, what):
    """A bitwise match proves little where nearly every output clips to 0
    or 255: require a fifth of them strictly inside."""
    share = float(((out > 0) & (out < 255)).float().mean())
    check(share >= MIN_UNSATURATED,
          f"{what}: only {share:.3f} of outputs inside (0, 255)")


def stem_case(rng, dev, n, small=False):
    """Full-range operands, or small ones, skewed positive, whose
    accumulators stay inside [0, 255] at shifts 0 and -1 for any draw."""
    if small:
        x = rng.integers(0, 4, (n, 32, 32, 3), np.uint8)
        w = rng.integers(-1, 4, (3, 3, 3, 16), np.int8)
        b = rng.integers(0, 20, 16).astype(np.int32)
    else:
        x = rng.integers(0, 256, (n, 32, 32, 3), np.uint8)
        w = rng.integers(-128, 128, (3, 3, 3, 16), np.int8)
        b = rng.integers(-500, 500, 16).astype(np.int32)
    x, w, b = (torch.from_numpy(a) for a in (x, w, b))
    return x.to(dev), w.to(dev), b.to(dev)


def block_case(rng, dev, n, h, cin, cout, stride):
    def i8(*s):
        return torch.from_numpy(rng.integers(-128, 128, s, np.int8)).to(dev)

    def i32(c):
        return torch.from_numpy(
            rng.integers(-500, 500, c).astype(np.int32)).to(dev)

    x = torch.from_numpy(rng.integers(0, 256, (n, h, h, cin), np.uint8))
    ops = [x.to(dev), i8(3, 3, cin, cout), i32(cout), i8(3, 3, cout, cout),
           i32(cout)]
    if stride == 2:
        ops += [i8(1, 1, cin, cout), i32(cout)]
    return ops


def sms_used(launch, x, blocks, want, what):
    """Run a prepared block-kernel launch of ``blocks`` thread blocks with
    its SM record on, hold its output bitwise against ``want``, and return
    the SMs its thread blocks ran on (distinct ``%smid`` values) and the
    most thread blocks that one SM ran."""
    ids = torch.full((blocks,), -1, dtype=torch.int32, device=x.device)
    out = launch(x, sm_ids=ids)
    torch.cuda.synchronize()
    check(torch.equal(out, want), f"{what} with its SM record differs from "
                                  f"plain")
    check(int(ids.min()) >= 0, f"{what}: a thread block recorded no SM")
    counts = torch.bincount(ids.long())
    return int((counts > 0).sum()), int(counts.max())


def kernels_phase(rng, dev):
    """Bitwise kernel-vs-plain checks and timings; returns the per-forward
    kernel records (ResNet20, bucket 32) with each kernel's largest
    deviation from its plain version."""
    err = dict(conv_stem=0, resblock_fused=0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stem = {}
    for n in (1, 8, BUCKET, 256):
        ops = stem_case(rng, dev, n)
        small = stem_case(rng, dev, n, small=True)
        check(stem_path(ops[0].shape, 16, sms) == "banded",
              f"conv_stem N={n}: the RGB stem is not on the banded path")
        for shift in (9, 0, -1):
            case = ops if shift > 0 else small
            before = dict(conv_stem_op.launches_by_path)
            got = conv_stem_op(*case, shift=shift)
            torch.cuda.synchronize()
            check(conv_stem_op.launches_by_path["banded"] ==
                  before["banded"] + 1, f"conv_stem N={n}: launch not on "
                                        f"the banded path")
            ref = conv_stem_ref(*case, shift=shift)
            err["conv_stem"] = max(err["conv_stem"], max_abs_err(got, ref))
            check(torch.equal(got, ref),
                  f"conv_stem N={n} shift={shift} differs from plain")
            check_unsaturated(got, f"conv_stem N={n} shift={shift}")
        if n not in (BUCKET, 256):
            continue
        out = conv_stem_op(*ops, shift=9)
        band = stem_band_rows(32, n, sms)
        blocks = n * -(-32 // band)
        t = dict(ms=device_ms(lambda: conv_stem_op(*ops, shift=9), REPS),
                 call_ms=call_ms(lambda: conv_stem_op(*ops, shift=9), REPS),
                 plain_ms=device_ms(lambda: conv_stem_ref(*ops, shift=9),
                                    REPS),
                 # an empty kernel of the same grid, launched the same way
                 floor_ms=device_ms(lambda: empty_launch(
                     blocks, BAND_THREADS, dev), REPS),
                 band_rows=band, thread_blocks=blocks)
        t["bound_ms"], t["bound_by"] = bound(nbytes(*ops, out),
                                             2 * out.numel() * 27)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["ms_above_floor"] = t["ms"] - t["floor_ms"]
        emit("kernel", name="conv_stem", n=n, bitwise=True, **t)
        stem[n] = t
    stem = dict(stem[BUCKET], batch256=stem[256],
                max_abs_err=err["conv_stem"])

    tot = dict(ms=0.0, call_ms=0.0, op_ms=0.0, plain_ms=0.0, bytes=0,
               ops=0)
    grid = {n: [] for n in BUCKETS}
    for (h, cin, cout, stride), count in RESNET20_BLOCKS:
        oh = h // stride
        for n in BUCKETS + (256,):
            ops = block_case(rng, dev, n, h, cin, cout, stride)
            band = space.block_band_rows(oh, n, sms)
            for skip_shift in (3, 0, -2):
                kw = dict(stride=stride, shift0=11, shift1=12,
                          skip_shift=skip_shift)
                got = resblock_fused_op(*ops, **kw)
                torch.cuda.synchronize()
                ref = resblock_ref(*ops, **kw)
                err["resblock_fused"] = max(err["resblock_fused"],
                                            max_abs_err(got, ref))
                check(torch.equal(got, ref),
                      f"resblock_fused N={n} {h}x{h} {cin}->{cout} "
                      f"s{stride} band={band} skip_shift={skip_shift} "
                      f"differs from plain")
                check_unsaturated(got, f"resblock_fused N={n} {h}x{h} "
                                       f"{cin}->{cout} "
                                       f"skip_shift={skip_shift}")
            if n in grid:
                kw = dict(stride=stride, shift0=11, shift1=12, skip_shift=-2)
                launch = ResblockLaunch(*ops[1:], **kw)
                blocks = launch.thread_blocks(n, oh)
                check(launch.band_rows(n, oh) == band and
                      blocks == n * -(-oh // band),
                      f"resblock_fused N={n} {h}x{h}: launch band "
                      f"{launch.band_rows(n, oh)} != rule {band}")
                used, most = sms_used(launch, ops[0], blocks,
                                      resblock_ref(*ops, **kw),
                                      f"resblock_fused N={n} {h}x{h}")
                grid[n].append(dict(band=band, blocks=blocks, sms=used,
                                    most=most))
            if n == BUCKET:
                main_ops = ops
        ops = main_ops
        kw = dict(stride=stride, shift0=11, shift1=12, skip_shift=-2)
        # the main path's call form: a launch prepared at lower time
        launch = ResblockLaunch(*ops[1:], **kw)
        out = launch(ops[0])
        check(torch.equal(out, resblock_ref(*ops, **kw)),
              "prepared resblock_fused launch differs from plain")
        t = dict(ms=device_ms(lambda: launch(ops[0]), REPS),
                 call_ms=call_ms(lambda: launch(ops[0]), REPS),
                 op_ms=device_ms(lambda: resblock_fused_op(*ops, **kw), REPS),
                 plain_ms=device_ms(lambda: resblock_ref(*ops, **kw), REPS))
        macs = BUCKET * oh * oh * cout * (9 * cin + 9 * cout +
                                         (cin if stride == 2 else 0))
        t["bound_ms"], t["bound_by"] = bound(nbytes(*ops, out), 2 * macs)
        t["tops"] = 2 * macs / (t["ms"] * 1e-3) / 1e12
        t["bound_share"] = t["bound_ms"] / t["ms"]
        band = space.block_band_rows(oh, BUCKET, sms)
        emit("kernel", name="resblock_fused", n=BUCKET, h=h, cin=cin,
             cout=cout, stride=stride, launches_per_forward=count,
             band_rows=band, thread_blocks=BUCKET * -(-oh // band),
             smem_bytes=smem_bytes(h, h, cin, cout, stride, stride == 2,
                                   band),
             bitwise=True, macs_per_image=macs // BUCKET, **t)
        for k in ("ms", "call_ms", "op_ms", "plain_ms"):
            tot[k] += count * t[k]
        tot["bytes"] += count * nbytes(*ops, out)
        tot["ops"] += count * 2 * macs
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    occupancy = {
        str(n): dict(thread_blocks=[g["blocks"] for g in grid[n]],
                     sms_used=[g["sms"] for g in grid[n]],
                     most_blocks_on_one_sm=[g["most"] for g in grid[n]],
                     band_rows=[g["band"] for g in grid[n]])
        for n in BUCKETS}
    block = dict(ms=tot["ms"], call_ms=tot["call_ms"], op_ms=tot["op_ms"],
                 plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                 tops=tot["ops"] / (tot["ms"] * 1e-3) / 1e12,
                 bound_share=b_ms / tot["ms"], card_sms=sms,
                 by_bucket=occupancy, max_abs_err=err["resblock_fused"])
    emit("kernel", name="resblock_fused", n=BUCKET,
         per="ResNet20 forward (9 launches)", **block)
    return stem, block


def fit_shift(acc):
    """The requant shift that puts the 90th percentile of the positive
    accumulators near 192, so that most outputs lie inside (0, 255)."""
    pos = acc[acc > 0].float()
    q = percentile_linear(pos, 90.0) if pos.numel() else 1.0
    return int(math.ceil(math.log2(max(q, 1.0) / 192)))


def live_chain(rng, dev, shapes, n, stem_och=0, skips=(3, 0, -2)):
    """Random operands for a chain of ``df.BlockShape`` links and a random
    input (the RGB image when ``stem_och``), every requant shift chosen
    link by link from the plain arithmetic so that the maps stay alive
    through the whole chain; skip shifts cycle through ``skips``.  Returns
    ``(x, blocks, specs, stem, stem_shift)``."""
    def i8(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape,
                                             np.int8)).to(dev)

    def i32(c):
        return torch.from_numpy(
            rng.integers(-500, 500, c).astype(np.int32)).to(dev)

    first = shapes[0]
    x = torch.from_numpy(rng.integers(
        0, 256, (n, first.h, first.w, 3 if stem_och else first.ich),
        np.uint8)).to(dev)
    h, stem, stem_shift = x, None, None
    if stem_och:
        stem = (i8(3, 3, 3, stem_och), i32(stem_och))
        acc = conv_i32(x, stem[0]) + stem[1]
        stem_shift = fit_shift(acc)
        h = requant_u8(acc, stem_shift)
    blocks, specs = [], []
    for i, b in enumerate(shapes):
        ws = (i8(3, 3, b.ich, b.och), i32(b.och), i8(3, 3, b.och, b.och),
              i32(b.och))
        if b.downsample:
            ws += (i8(1, 1, b.ich, b.och), i32(b.och))
        acc0 = conv_i32(h, ws[0], b.stride) + ws[1]
        shift0 = fit_shift(acc0)
        skip_shift = skips[i % len(skips)]
        skip = shift_align(conv_i32(h, ws[4], b.stride) + ws[5]
                           if b.downsample else h, skip_shift)
        acc1 = conv_i32(requant_u8(acc0, shift0), ws[2]) + ws[3] + skip
        shift1 = fit_shift(acc1)
        h = requant_u8(acc1, shift1)
        blocks.append(ws)
        specs.append(ChainBlockSpec(stride=b.stride, has_ds=b.downsample,
                                    shift0=shift0, shift1=shift1,
                                    skip_shift=skip_shift))
    return x, tuple(blocks), tuple(specs), stem, stem_shift


def check_chain(what, case, shapes, stem_och, bt):
    """block_chain against its plain version, bitwise, at one batch tile
    and the split tune.space.chain_split picks for it; the kernel's shared
    memory at that split against the planner's formula.  Returns (largest
    deviation, shared memory, split)."""
    x, blocks, specs, stem, stem_shift = case
    cfg = KernelConfig(batch_tile=bt)
    got = block_chain_op(x, blocks, specs=specs, stem=stem,
                         stem_shift=stem_shift, config=cfg)
    torch.cuda.synchronize()
    ref = block_chain_ref(x, blocks, specs=specs, stem=stem,
                          stem_shift=stem_shift)
    check(torch.equal(got, ref),
          f"block_chain {what} batch_tile={bt} differs from plain")
    check_unsaturated(got, f"block_chain {what} batch_tile={bt}")
    n = x.shape[0]
    bt = cfg.normalize(n, shapes[-1].och).batch_tile
    split = space.chain_split(shapes, n // bt, bt, stem_och,
                              capacity=chain_ops.max_clusters)
    launch = ChainLaunch(blocks, specs=specs, in_shape=x.shape[1:],
                         stem=stem, stem_shift=stem_shift, config=cfg)
    check(launch.tiling(n) == (bt, split),
          f"block_chain {what}: launch tiling {launch.tiling(n)} != rule "
          f"{(bt, split)}")
    smem = chain_ops.smem_bytes(shapes, bt, stem_och, split)
    check(smem == df.chain_task_smem_bytes(shapes, bt, stem_och, split),
          f"block_chain {what} batch_tile={bt} split={split}: kernel smem "
          f"{smem} != chain_task_smem_bytes")
    return max_abs_err(got, ref), smem, split


def host_us(fn, reps):
    """Host microseconds one call takes to return (the enqueue, with the
    device left to run behind it), after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def chain_phase(rng, dev):
    """block_chain against its plain version on every tested chain, bucket,
    tile and split, then its timings on ResNet20's chain at buckets 1, 8
    and 32; returns the kernel record with its largest deviation."""
    err, splits = 0, set()
    r20, r8 = df.resnet_block_shapes(3), df.resnet_block_shapes(1)
    cases = [("resnet20", r20, n, 16, bts)
             for n, bts in ((1, (1,)), (8, (1, 2)), (BUCKET, (1, 2)),
                            (256, (1,)))]
    cases += [("resnet8", r8, n, 16, bts)
              for n, bts in ((1, (1,)), (8, (1, 2)), (BUCKET, (1, 2)))]
    for links in NARROW_CHAINS:
        h, shapes = 16, []
        for cin, cout, stride in links:
            shapes.append(df.BlockShape(h, h, cin, cout,
                                        stride != 1 or cin != cout, stride))
            h //= stride
        cases.append((f"{len(links)}-link narrow", shapes, 4, 0, (1, 2)))
    for name, shapes, n, stem_och, bts in cases:
        for skips in SKIP_CYCLES[:1] if len(shapes) >= 3 else SKIP_CYCLES:
            case = live_chain(rng, dev, shapes, n, stem_och, skips)
            for bt in bts:
                e, smem, split = check_chain(f"{name} N={n} skips={skips}",
                                             case, shapes, stem_och, bt)
                err = max(err, e)
                splits.add((name, n, bt, split))
                emit("kernel_check", name="block_chain", chain=name, n=n,
                     batch_tile=bt, split=split, skips=list(skips),
                     bitwise=True, smem_bytes=smem)

    by_bucket = {}
    for n in BUCKETS:
        x, blocks, specs, stem, stem_shift = live_chain(rng, dev, r20, n, 16)
        kw = dict(specs=specs, stem=stem, stem_shift=stem_shift)
        # the main path's call form: a launch prepared at lower time
        launch = ChainLaunch(blocks, in_shape=x.shape[1:], **kw)
        out = launch(x)
        check(torch.equal(out, block_chain_ref(x, blocks, **kw)),
              f"prepared block_chain launch N={n} differs from plain")
        bt, split = launch.tiling(n)
        smem = chain_ops.smem_bytes(r20, bt, 16, split)
        used, most = sms_used(launch, x, launch.thread_blocks(n), out,
                              f"block_chain N={n}")
        rec = dict(ms=device_ms(lambda: launch(x), REPS), split=split,
                   thread_blocks=launch.thread_blocks(n), sms_used=used,
                   most_blocks_on_one_sm=most,
                   max_active_clusters=chain_ops.max_clusters(split, smem),
                   smem_bytes=smem)
        by_bucket[str(n)] = rec
        if n != BUCKET:
            continue
        t = dict(ms=rec["ms"], call_ms=call_ms(lambda: launch(x), REPS),
                 op_ms=device_ms(lambda: block_chain_op(x, blocks, **kw),
                                 REPS),
                 plain_ms=device_ms(lambda: block_chain_ref(x, blocks, **kw),
                                    REPS),
                 # host time of one call: the direct op (validates the chain,
                 # widens the biases, packs the weights and the link table
                 # every call) against the prepared launch
                 host_us_op=host_us(lambda: block_chain_op(x, blocks, **kw),
                                    REPS),
                 host_us_prepared=host_us(lambda: launch(x), REPS))
        bt2 = ChainLaunch(blocks, in_shape=x.shape[1:],
                          config=KernelConfig(batch_tile=2), **kw)
        t["ms_batch_tile_2"] = device_ms(lambda: bt2(x), REPS)
        operands = [x, *stem, *(w for ws in blocks for w in ws), out]
        ops = 2 * BUCKET * macs_per_image(R.RESNET20)
        t["bound_ms"], t["bound_by"] = bound(nbytes(*operands), ops)
        t["bound_bytes_ms"] = nbytes(*operands) / HBM_BYTES_PER_S * 1e3
        t["bound_ops_ms"] = ops / INT8_OPS_PER_S * 1e3
        t["tops"] = ops / (t["ms"] * 1e-3) / 1e12
        t["bound_share"] = t["bound_ms"] / t["ms"]
        main = t
    # clusters the card runs at once, at two thread blocks an SM (60,000 B
    # each) and at one (120,000 B), from the kernel's occupancy query
    capacity = {f"split {sp}, {per} an SM": chain_ops.max_clusters(sp, sm)
                for sp in space.SPLITS for per, sm in ((2, 60_000),
                                                       (1, 120_000))}
    main.update(smem_bytes=by_bucket[str(BUCKET)]["smem_bytes"],
                cluster_capacity=capacity,
                by_bucket=by_bucket,
                splits_checked=sorted({s for *_, s in splits}))
    emit("kernel", name="block_chain", n=BUCKET, chain="ResNet20 stem+b0..b8",
         bitwise=True, **main)
    return dict(main, max_abs_err=err)


# ---------------------------------------------------------------------------
# conv2d_int8: the general int8 conv, off the serving path
# ---------------------------------------------------------------------------

# the sweep of tests/test_kernels.py and its skip case, then the traps of
# the JAX wrapper: (N, H, C, O, fh, stride, relu, out_shift, x dtype, skip)
CONV_SWEEP = [(2, 8, 4, 8, 3, 1, False, None, torch.int8, False),
              (2, 8, 4, 8, 3, 2, False, None, torch.int8, False),
              (1, 16, 8, 16, 3, 1, True, 7, torch.int8, False),
              (2, 8, 3, 16, 3, 2, True, 6, torch.int8, False),
              (2, 8, 4, 4, 3, 1, False, None, torch.int8, True),
              (2, 8, 4, 8, 3, 1, False, -2, torch.int8, True),
              (2, 8, 4, 8, 3, 1, True, -2, torch.int8, False),
              (2, 8, 4, 8, 3, 2, True, 0, torch.int8, True),
              (2, 8, 4, 8, 3, 1, True, 9, torch.uint8, False),
              (2, 9, 3, 5, 3, 2, False, 4, torch.uint8, True),
              (1, 10, 4, 8, 5, 1, True, 10, torch.int8, False),
              (2, 8, 8, 8, 1, 2, False, None, torch.int8, False)]
# ResNet20's conv layers at batch 32 with s8 input, the paper's convolution
# task: (H, Cin, Cout, fh, stride, layers of one forward)
RESNET20_CONVS = [(32, 16, 16, 3, 1, 6), (32, 16, 32, 3, 2, 1),
                  (16, 32, 32, 3, 1, 5), (16, 32, 64, 3, 2, 1),
                  (8, 64, 64, 3, 1, 5), (32, 16, 32, 1, 2, 1),
                  (16, 32, 64, 1, 2, 1)]


def conv_operands(rng, dev, n, h, cin, cout, fh, stride, xdtype=torch.int8,
                  skip=False):
    lo, hi = (0, 256) if xdtype == torch.uint8 else (-128, 128)
    npt = np.uint8 if xdtype == torch.uint8 else np.int8
    x = torch.from_numpy(rng.integers(lo, hi, (n, h, h, cin)).astype(npt))
    w = rng.integers(-128, 128, (fh, fh, cin, cout)).astype(np.int8)
    b = rng.integers(-2000, 2000, cout).astype(np.int32)
    s = rng.integers(-2 ** 16, 2 ** 16, (n, *out_hw(h, h, stride), cout)
                     ).astype(np.int32) if skip else None
    return (x.to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(b).to(dev),
            None if s is None else torch.from_numpy(s).to(dev))


def conv_shift(acc, relu):
    """The requant shift that puts the 90th percentile of the accumulators
    (the positive ones under ReLU, |acc| otherwise) near the middle of the
    clip range's upper half."""
    a = (acc[acc > 0] if relu else acc.abs().flatten()).double()[:1 << 24]
    q = float(torch.quantile(a, 0.9)) if a.numel() else 1.0
    return max(int(math.ceil(math.log2(max(q, 1.0) /
                                       (192 if relu else 100)))), 1)


def conv_inside(out, relu):
    """Share of requantized outputs strictly inside their clip range."""
    o = out.to(torch.int32)
    lo, hi = (0, 255) if relu else (-128, 127)
    return float(((o > lo) & (o < hi)).float().mean())


def check_conv(what, ops, want_path=None, **kw):
    """conv2d_int8 bitwise against its plain version, one launch counted on
    the path its shape picks (``want_path``, where given)."""
    path = conv_path(ops[0].shape, ops[1].shape, kw.get("stride", 1),
                     torch.cuda.get_device_properties(ops[0].device)
                     .multi_processor_count)
    check(want_path in (None, path),
          f"conv2d_int8 {what}: path {path}, expected {want_path}")
    before = dict(conv2d_int8_op.launches_by_path)
    got = conv2d_int8_op(*ops, **kw)
    torch.cuda.synchronize()
    check(conv2d_int8_op.launches_by_path[path] == before[path] + 1,
          f"conv2d_int8 {what}: launch not counted on the {path} path")
    ref = conv2d_int8_plain(*ops, **kw)
    check(got.dtype == ref.dtype and torch.equal(got, ref),
          f"conv2d_int8 {what} {kw} differs from plain")
    return got, max_abs_err(got, ref)


def conv2d_phase(rng, dev):
    """conv2d_int8 bitwise against its plain version on the JAX sweep, the
    skip init, out_shift > 0, = 0 and < 0, ReLU on and off, int32 output
    and uint8 input; then on ResNet20's conv layers at batch 32 (s8 input)
    with requant shifts that keep at least a fifth of the outputs strictly
    inside their clip range; timings there and at the kernels_micro shape.
    Returns the kernel record summed over ResNet20's 20 conv layers."""
    err, cases = 0, 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_path = dict(conv2d_int8_op.launches_by_path)
    for n, h, c, o, fh, stride, relu, shift, xdt, skip in CONV_SWEEP:
        ops = conv_operands(rng, dev, n, h, c, o, fh, stride, xdt, skip)
        err = max(err, check_conv(f"sweep N={n} {h}x{h}x{c}->{o} f{fh} "
                                  f"s{stride} {xdt}", ops, stride=stride,
                                  relu=relu, out_shift=shift)[1])
        cases += 1
    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    layers = []
    for h, cin, cout, fh, stride, count in RESNET20_CONVS:
        what = f"{h}x{h}x{cin}->{cout} f{fh} s{stride}"
        ops = conv_operands(rng, dev, BUCKET, h, cin, cout, fh, stride,
                            skip=True)
        acc = conv2d_int8_plain(*ops, stride=stride)
        kws = [dict(stride=stride), dict(stride=stride, relu=True)]
        for relu in (True, False):
            shift = conv_shift(torch.clamp_min(acc, 0) if relu else acc,
                               relu)
            kws += [dict(stride=stride, relu=relu, out_shift=shift),
                    dict(stride=stride, relu=relu, out_shift=-shift),
                    dict(stride=stride, relu=relu, out_shift=0)]
        for kw in kws:
            for with_skip in (True, False):
                case = ops if with_skip else ops[:3]
                got, e = check_conv(what, case, want_path="mma", **kw)
                err = max(err, e)
                cases += 1
                if (kw.get("out_shift") or 0) > 0:
                    share = conv_inside(got, kw.get("relu", False))
                    check(share >= MIN_UNSATURATED,
                          f"conv2d_int8 {what} {kw}: only {share:.3f} of "
                          f"outputs inside the clip range")
        relu_shift = conv_shift(torch.clamp_min(acc, 0), True)
        kw = dict(stride=stride, relu=True, out_shift=relu_shift)
        out = conv2d_int8_op(*ops[:3], **kw)
        t = dict(ms=device_ms(lambda: conv2d_int8_op(*ops[:3], **kw), REPS),
                 call_ms=call_ms(lambda: conv2d_int8_op(*ops[:3], **kw),
                                 REPS),
                 plain_ms=device_ms(lambda: conv2d_int8_plain(*ops[:3], **kw),
                                    REPS))
        oh = out_hw(h, h, stride)[0]
        macs = BUCKET * oh * oh * cout * fh * fh * cin
        t["bound_ms"], t["bound_by"] = bound(nbytes(*ops[:3], out), 2 * macs)
        t["tops"] = 2 * macs / (t["ms"] * 1e-3) / 1e12
        t["bound_share"] = t["bound_ms"] / t["ms"]
        band, ng = conv_tiles(oh, oh, BUCKET, cin, cout, fh, fh, sms)
        layer = dict(h=h, cin=cin, cout=cout, fh=fh, stride=stride,
                     layers_per_forward=count,
                     path=conv_path(ops[0].shape, ops[1].shape, stride, sms),
                     band_rows=band, channels_a_block=ng,
                     thread_blocks=BUCKET * -(-oh // band) * -(-cout // ng),
                     **t)
        layers.append(layer)
        emit("kernel", name="conv2d_int8", n=BUCKET, relu=True,
             out_shift=relu_shift, bitwise=True,
             inside_clip_share=conv_inside(out, True), **layer)
        for k in ("ms", "call_ms", "plain_ms"):
            tot[k] += count * t[k]
        tot["bytes"] += count * nbytes(*ops[:3], out)
        tot["ops"] += count * 2 * macs
    # benchmarks/run.py's kernels_micro shape: int32 output, zero bias
    x, w, _, _ = conv_operands(rng, dev, 2, 16, 16, 16, 3, 1)
    b = torch.zeros(16, dtype=torch.int32, device=dev)
    err = max(err, check_conv("kernels_micro", (x, w, b), want_path="mma")[1])
    cases += 1
    out = conv2d_int8_op(x, w, b)
    t = dict(ms=device_ms(lambda: conv2d_int8_op(x, w, b), REPS),
             call_ms=call_ms(lambda: conv2d_int8_op(x, w, b), REPS),
             plain_ms=device_ms(lambda: conv2d_int8_plain(x, w, b), REPS))
    t["bound_ms"], t["bound_by"] = bound(nbytes(x, w, b, out),
                                         2 * out.numel() * 9 * 16)
    emit("kernel", name="conv2d_int8", n=2, h=16, cin=16, cout=16, fh=3,
         stride=1, shape="kernels_micro", bitwise=True, **t)
    emit("kernel_check", name="conv2d_int8", cases=cases, bitwise=True)
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    rec = dict(ms=tot["ms"], call_ms=tot["call_ms"],
               plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
               tops=tot["ops"] / (tot["ms"] * 1e-3) / 1e12,
               bound_share=b_ms / tot["ms"], max_abs_err=err,
               kernels_micro_ms=t["ms"], kernels_micro_bound_ms=t["bound_ms"],
               layers=layers,
               checked_launches_by_path={
                   p: conv2d_int8_op.launches_by_path[p] - by_path[p]
                   for p in by_path})
    emit("kernel", name="conv2d_int8", n=BUCKET,
         per="ResNet20's 20 conv layers, one launch each", **rec)
    return rec


def macs_per_image(cfg):
    res, ich = cfg.img, cfg.base_width
    macs = res * res * 27 * ich
    for i, stride in enumerate(R.block_strides(cfg)):
        och = cfg.base_width * 2 ** (i // cfg.blocks_per_stage)
        res //= stride
        macs += res * res * och * (9 * ich + 9 * och +
                                   (ich if stride == 2 else 0))
        ich = och
    return macs


def launch_plan(cfg, backend):
    """Launches of each kernel per bucket run on ``backend``, and its chain
    plan (``cuda`` is the plan with every block a singleton chain)."""
    b = get_backend(backend)
    chains = lowering.plan_chains(
        lowering.plan_model(lowering.optimized_graph(cfg)), cfg,
        cuts=b.cuts, fuse_stem=b.fuse_stem, smem_budget=b.smem_budget)
    singles = sum(len(c.blocks) == 1 and c.stem is None for c in chains)
    return dict(conv_stem=int(chains[0].stem is None),
                resblock_fused=singles,
                block_chain=len(chains) - singles, conv2d_int8=0), \
        [c.describe() for c in chains]


def replay_ms(exe, reps):
    """Device time of one replay of a bucket's own CUDA graph: CUDA events
    around ``reps`` back-to-back replays, the median of five such runs.
    The graph runs longer than its launch takes, so the device stays
    busy between replays."""
    exe.graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            exe.graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


# the port's kernel entry points by the name the profiler gives their
# launches: (the wrapper that counts them, the path it counts them on)
KERNEL_ENTRIES = {
    "conv_stem_banded": ("conv_stem", "banded"),
    "conv_stem_general": ("conv_stem", "general"),
    "resblock_fused_kernel": ("resblock_fused", None),
    "block_chain_kernel": ("block_chain", None),
    "matmul_int8_wgmma": ("matmul_int8", "wgmma"),
    "matmul_int8_mma_sync": ("matmul_int8", "mma_sync"),
    "flash_attention_kernel": ("flash_attention", None),
    "selective_scan_kernel": ("selective_scan", None),
    "conv2d_int8_mma": ("conv2d_int8", "mma"),
    "conv2d_int8_general": ("conv2d_int8", "general"),
}


def traced_launches(fn):
    """Run ``fn()`` under ``torch.profiler`` and count the port's kernels
    the card ran, by entry point: CUPTI reports every kernel a CUDA graph
    replay runs, so this reads the served path's launches directly (the
    wrappers' counters only add what a capture counted at each replay).
    Returns ``(fn(), {kernel: launches}, {kernel: {path: launches}})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ran = {k: 0 for k, _ in KERNEL_ENTRIES.values()}
    by_path = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for entry, (kernel, path) in KERNEL_ENTRIES.items():
            if re.search(rf"\b{entry}\s*[<(]", e.key):
                ran[kernel] += e.count
                if path is not None:
                    d = by_path.setdefault(kernel, {})
                    d[path] = d.get(path, 0) + e.count
    return out, ran, by_path


def check_traced(ran, launches, per_run, runs, what):
    """The kernels the card ran in a served run (``traced_launches``): the
    plan once for every bucket run and no other kernel of the port, and
    the wrappers' counters agree."""
    check_traced_want(ran, launches,
                      {k: runs * v for k, v in per_run.items()},
                      f"{what} ({runs} bucket runs of {per_run})")


def check_traced_want(ran, launches, want, what):
    """The kernels the card ran (``traced_launches``) are ``want`` and no
    other kernel of the port, and the wrappers' counters agree."""
    full = {k: 0 for k in ran}
    full.update(want)
    check(ran == full,
          f"{what}: the profiler saw {ran} kernel launches, want {full}")
    check(all(ran[k] == n for k, n in launches.items()),
          f"{what}: the counters say {launches}, the profiler {ran}")


def build_served_buckets(eng, requests):
    """Build the buckets a run of ``requests`` requests will use, in the
    served model and its shadows, as a server does at start: the served
    run then only replays graphs (a capture under the profiler costs
    minutes on the 64-layer LM).  Returns the buckets."""
    used = sorted({eng.model.bucket_for(min(eng.batch, requests - i))
                   for i in range(0, requests, eng.batch)})
    for m in (eng.model, *eng.shadows.values()):
        for b in used:
            m.executable(b)
    torch.cuda.synchronize()
    return used


def check_graphs(m, buckets_used, what):
    """One capture and one executable a bucket used, none of the others,
    and every executable a CUDA graph."""
    check(m.trace_counts == {b: 1 for b in buckets_used},
          f"{what}: trace_counts {m.trace_counts}, want one capture for "
          f"each of the buckets {sorted(buckets_used)}")
    check(m.compile_count == len(buckets_used) and
          sorted(m.stats()["compiled"]) == sorted(buckets_used),
          f"{what}: compile_count {m.compile_count} for buckets "
          f"{sorted(buckets_used)}")
    check(all(isinstance(m.executable(b), GraphExecutable)
              for b in buckets_used), f"{what}: a bucket is not a graph")


def check_replays(m, x1, x2, what):
    """Two calls of one bucket with different inputs: the first result is
    left as it was; the placed path on the same card gives the default
    path's result bitwise."""
    a = m(x1)
    kept = a.clone()
    b = m(x2)
    torch.cuda.synchronize()
    check(torch.equal(a, kept) and not torch.equal(a, b),
          f"{what}: a second replay changed the first call's result")
    placed = m.run_placed(x1, torch.device("cuda", 0))
    check(torch.equal(placed, kept),
          f"{what}: run_placed on cuda:0 differs from the default path")


def served_times(m, x, reps):
    """The served call (copy in, replay, clone) against the bucket's graph
    and the eager lowered forward, in ms, and the served call's idle
    share."""
    exe = m.executable(x.shape[0])
    served = call_ms(lambda: m(x), reps)
    graph = replay_ms(exe, reps)
    eager = call_ms(lambda: m._forward(x), reps)
    return dict(served_ms=served, graph_ms=graph, eager_ms=eager,
                served_idle_share=1.0 - graph / served,
                eager_idle_share=1.0 - graph / eager)


def serve_phase(cfg, seed, dev, backend):
    """Serve ``REQUESTS`` images through the engine on ``backend``; returns
    the engine and the launch counts of that run."""
    qp = resnet_qparams(cfg, seed)
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.0, 0.999, (REQUESTS, 32, 32, 3)).astype(
        np.float32)
    eng = ResNetEngine(cfg, qp, batch=BUCKET, backend=backend,
                       batch_sizes=(1, 8, BUCKET), ab_backends=("torch-int",))
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    for r in reqs:
        eng.submit(r)
    built = build_served_buckets(eng, REQUESTS)

    conv_stem_op.launches = resblock_fused_op.launches = 0
    block_chain_op.launches = conv2d_int8_op.launches = 0
    for op in (conv_stem_op, conv2d_int8_op):
        op.launches_by_path = dict.fromkeys(op.launches_by_path, 0)
    t0 = time.perf_counter()
    ticks, ran, ran_by_path = traced_launches(eng.run)
    wall = time.perf_counter() - t0
    launches = dict(conv_stem=conv_stem_op.launches,
                    resblock_fused=resblock_fused_op.launches,
                    block_chain=block_chain_op.launches,
                    conv2d_int8=conv2d_int8_op.launches)
    by_path = dict(conv_stem=dict(conv_stem_op.launches_by_path),
                   conv2d_int8=dict(conv2d_int8_op.launches_by_path))

    runs = sum(eng.model.run_counts.values())
    per_run, chains = launch_plan(cfg, backend)
    check(eng.served == REQUESTS and all(r.done for r in reqs),
          "engine left requests unserved")
    check(runs == math.ceil(REQUESTS / BUCKET), f"{runs} bucket runs")
    check(launches == {k: runs * v for k, v in per_run.items()},
          f"{backend}: launch counts {launches} for {runs} bucket runs of "
          f"{per_run} each")
    check(by_path["conv_stem"]["banded"] == launches["conv_stem"],
          f"{backend}: stem launches {by_path['conv_stem']} not all on the "
          f"banded path")
    used = [b for b, k in eng.model.run_counts.items() if k]
    check(used == built, f"buckets {used} used, {built} built")
    check_traced(ran, launches, per_run, runs, f"{cfg.name} {backend}")
    check(ran_by_path.get("conv_stem", {}).get("general", 0) == 0,
          f"{backend}: the profiler saw stem launches {ran_by_path} off the "
          f"banded path")
    m, shadow = eng.model, eng.shadows["torch-int"]
    check_graphs(m, used, f"{cfg.name} {backend}")
    check_graphs(shadow, used, f"{cfg.name} torch-int shadow")

    # the served model's u8 maps on the padded batches of its own bucket
    # runs (32, then 5 padded to 8), bitwise against the torch-int shadow's;
    # the served logits (graph replays) bitwise the eager lowered forward's
    # on the same batches
    feats_fn = m.backend.features(m.graph, cfg, m.params)
    ref_fn = shadow.backend.features(shadow.graph, cfg, shadow.params)
    x = torch.as_tensor(imgs, device=dev)
    logits = torch.from_numpy(np.stack([r.logits for r in reqs]))
    feats = []
    for i in range(0, REQUESTS, BUCKET):
        batch = m.pad(x[i:i + BUCKET])
        n = min(BUCKET, REQUESTS - i)
        got, ref = feats_fn(batch), ref_fn(batch)
        check(torch.equal(got, ref),
              f"u8 feature map of the bucket-{batch.shape[0]} run differs "
              f"from torch-int")
        feats.append(got[:n])
        check(torch.equal(logits[i:i + n], m._forward(batch)[:n].cpu()),
              f"served logits of the bucket-{batch.shape[0]} run differ "
              f"from the eager lowered forward")
    feats = torch.cat(feats)
    check(bool(feats.any()), "u8 feature map is all zero")
    ref_logits = lower_forward(cfg, qp, "torch-int")(imgs).cpu()
    dev_max = float((logits - ref_logits).abs().max())
    check(torch.isfinite(logits).all() and dev_max <= LOGIT_ATOL,
          f"logits deviate {dev_max} from torch-int")
    check(torch.equal(logits.argmax(-1), ref_logits.argmax(-1)),
          "argmax differs from torch-int")
    check(max(eng.ab_stats["torch-int"]) <= LOGIT_ATOL, "A/B shadow")

    bucket_runs = dict(eng.model.run_counts)
    trace_counts = dict(m.trace_counts)
    x = x[:BUCKET]
    check_replays(m, x, x.flip(0), f"{cfg.name} {backend}")
    times = served_times(m, x, REPS)
    summary = dict(bucket32_served_ms=times["served_ms"],
                   bucket32_graph_ms=times["graph_ms"],
                   bucket32_eager_ms=times["eager_ms"],
                   served_idle_share=times["served_idle_share"],
                   eager_idle_share=times["eager_idle_share"],
                   images_per_s_bucket32=BUCKET / (times["served_ms"] * 1e-3),
                   images_per_s_bucket32_graph=BUCKET / (
                       times["graph_ms"] * 1e-3),
                   images_per_s_bucket32_eager=BUCKET / (
                       times["eager_ms"] * 1e-3),
                   launches_by_path=by_path)
    emit("serve", model=cfg.name, backend=backend, chains=chains,
         requests=REQUESTS, ticks=ticks, bucket_runs=bucket_runs,
         trace_counts=trace_counts, launches=launches,
         traced_launches=ran, traced_serve_wall_s=wall, u8_bitwise=True,
         max_abs_logit_dev=dev_max,
         ab_max_abs_dev=max(eng.ab_stats["torch-int"]),
         feature_nonzero_share=float((feats > 0).float().mean()),
         macs_per_image=macs_per_image(cfg), **summary)
    return eng, launches, summary


def eager_compare_phase(models, dev, turns=4):
    """Bucket-32 time of the eager lowered forward of each ResNet on
    ``cuda`` and ``cuda-stream`` (the eager path), measured in
    turns (cuda, cuda-stream, cuda-stream, cuda, ...), so that the host's
    drift within the call falls on both alike; the median of each
    backend's turns."""
    x = torch.rand((BUCKET, 32, 32, 3), device=dev) * 0.999
    out = {}
    for name, (eng, eng_s) in models.items():
        times = {"cuda": [], "cuda-stream": []}
        for turn in range(turns):
            order = ("cuda", "cuda-stream")[::1 if turn % 2 == 0 else -1]
            for b in order:
                fwd = (eng if b == "cuda" else eng_s).model._forward
                times[b].append(call_ms(lambda: fwd(x), REPS))
        ms = {b: float(np.median(t)) for b, t in times.items()}
        out[name] = dict(
            cuda_ms=ms["cuda"], stream_ms=ms["cuda-stream"],
            cuda_images_per_s=BUCKET / (ms["cuda"] * 1e-3),
            stream_images_per_s=BUCKET / (ms["cuda-stream"] * 1e-3),
            turns_ms=times, stream_no_slower=ms["cuda-stream"] <= ms["cuda"])
    emit("eager_compare", **out)
    return out


def top_kernels(prof, n=12):
    """The ``n`` entries of a profile with the most device time."""
    def device_us(e):
        return getattr(e, "self_device_time_total", 0)

    rows = sorted(prof.key_averages(), key=lambda e: -device_us(e))
    return [dict(name=e.key[:60], count=e.count, device_us=device_us(e))
            for e in rows[:n]]


def profile_phase(eng, dev, backend, x, calls):
    """``torch.profiler`` over ``calls`` served calls of ``eng.model`` (copy
    in, graph replay, clone): device time by kernel name, the kernels of
    the replays included."""
    from torch.profiler import ProfilerActivity, profile

    eng.model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            eng.model(x)
        torch.cuda.synchronize()
    emit("profile", model=eng.cfg.name, backend=backend, served_calls=calls,
         bucket=x.shape[0], top=top_kernels(prof))


PROFILE_TOL = 0.25   # a task profile against the kernels phase's time


def task_profile_phase(seed, dev, block, chain):
    """``obs.profile.profile_tasks`` for ResNet20 at batch 32 on both
    backends, attached to one obs session: the rows' kinds, the block rows'
    sum against the kernels phase's ``resblock_fused`` time and the chain
    row against ``block_chain``'s (within ``PROFILE_TOL``), ``vs_roofline``
    per task at ``REFERENCE_HBM_GBPS``, and the session's metrics text
    parsed back through ``obs.metrics.parse_text``."""
    cfg = R.RESNET20
    qp = resnet_qparams(cfg, seed)
    want = {"cuda": ["stem"] + ["block"] * 9, "cuda-stream": ["chain"]}
    out = {}
    with obs_runtime.instrumented() as ob:
        for backend, kinds in want.items():
            rows = profile_tasks(cfg, qp, backend=backend, batch=BUCKET,
                                 reps=REPS, ob=ob, device=dev)
            check([r.kind for r in rows] == kinds,
                  f"profile {backend}: row kinds {[r.kind for r in rows]}")
            out[backend] = [r.to_dict() for r in rows]
        text = ob.metrics.render_text()
        spans = sum(e.cat == "kernel" for e in ob.trace.events)
    blocks_ms = sum(r["wall_us"] for r in out["cuda"]
                    if r["kind"] == "block") * 1e-3
    chain_ms = out["cuda-stream"][0]["wall_us"] * 1e-3
    for what, got, ref in (("block rows", blocks_ms, block["ms"]),
                           ("chain row", chain_ms, chain["ms"])):
        check(abs(got - ref) <= PROFILE_TOL * ref,
              f"profile: the {what} take {got:.5f} ms against the kernels "
              f"phase's {ref:.5f}")
    parsed = parse_text(text)
    check(parsed["kernel_profiles_total"] == {
        '{kind="block",model="resnet20"}': 9,
        '{kind="chain",model="resnet20"}': 1,
        '{kind="stem",model="resnet20"}': 1}, "profile: kernel_profiles_total")
    check(spans == 11, f"profile: {spans} kernel spans")
    check("wall" not in text and "gbps" not in text,
          "profile: a measured value in the metrics registry")
    summary = dict(blocks_ms=blocks_ms, resblock_fused_ms=block["ms"],
                   chain_ms=chain_ms, block_chain_ms=chain["ms"],
                   reference_hbm_gbps=REFERENCE_HBM_GBPS)
    emit("task_profile", model=cfg.name, batch=BUCKET,
         rows={b: [dict(task=r["task"], kind=r["kind"],
                        wall_us=r["wall_us"], hbm_bytes=r["hbm_bytes"],
                        vmem_bytes=r["vmem_bytes"],
                        vs_roofline=r["vs_roofline"]) for r in rows]
               for b, rows in out.items()},
         metrics_text=text, **summary)
    return summary


# ---------------------------------------------------------------------------
# Training, PTQ, QAT and the export evaluated through the served kernels
# ---------------------------------------------------------------------------

TRAIN_BATCH = 128
TRAIN_STEPS = 60
TRAIN_WARMUP = 6
RESUME_STEPS = (10, 5)   # straight run; the run cut at a checkpoint
QAT_STEPS = 20
CALIB_BATCHES = 4
EVAL_N = 1024


class TimedPipeline:
    """A data pipeline that stamps the host clock at each ``next()``: the
    loop asks for a batch at the start of every step and waits for the
    step's metrics on the card at its end, so consecutive stamps bound one
    whole step."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.stamps = []

    @property
    def state(self):
        return self.pipe.state

    @state.setter
    def state(self, value):
        self.pipe.state = value

    def next(self):
        self.stamps.append(time.perf_counter())
        return self.pipe.next()

    def step_ms(self):
        return [1e3 * (b - a) for a, b in zip(self.stamps, self.stamps[1:])]


def step_profile(step, params, opt_state, batch, steps=5):
    """``torch.profiler`` over ``steps`` train steps after one warm-up:
    wall ms a step under the profiler (host clock, ended by a
    synchronisation), the device's busy ms (the kernels and copies it ran,
    one stream, so they do not overlap), the idle share, launches a step
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params, opt_state, _ = step(params, opt_state, 0, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt_state, _ = step(params, opt_state, i + 1, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in dev_events) * 1e-6
    return dict(wall_ms=wall_s * 1e3 / steps, device_ms=busy_s * 1e3 / steps,
                idle_share=1.0 - busy_s / wall_s,
                launches_per_step=sum(e.count for e in dev_events) / steps,
                top=top_kernels(prof, 8))


def resume_check(cfg, params0, seed, dev):
    """The card's version of tests/test_substrate.py's resume case: in
    deterministic mode, 10 steps straight against 5 steps, a checkpoint
    and a resume to step 10; parameters and momenta bitwise."""
    opt = opt_lib.sgdm(lr=0.1, total_steps=TRAIN_STEPS, warmup=TRAIN_WARMUP)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    straight, cut = RESUME_STEPS
    quiet = dict(log_every=10 ** 9)
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ckpt_dir = tempfile.mkdtemp(prefix="repro-resume-")
    try:
        runs = []
        for total, ck in ((straight, None), (cut, ckpt_dir),
                          (straight, ckpt_dir)):
            runs.append(train_loop.run(
                train_loop.LoopConfig(total_steps=total, ckpt_dir=ck,
                                      **quiet),
                params=params0, opt_state=opt.init(params0),
                train_step=step, pipeline=SyntheticCifar(TRAIN_BATCH, seed),
                log=lambda *_: None))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(det[0])
        torch.backends.cudnn.deterministic = det[1]
        torch.backends.cudnn.benchmark = det[2]
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    a, b = runs[0][:2], runs[2][:2]
    same = all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                  tree.leaves(b)))
    check(same, f"train: {cut} steps + checkpoint + resume to {straight} "
                f"differ from {straight} steps straight")
    return dict(steps=straight, cut_at=cut, bitwise=same,
                leaves=len(tree.leaves(a)))


def train_phase(seed, dev):
    """ResNet20 at full width (16/32/64), CIFAR-10 shapes, batch 128, on
    ``SyntheticCifar``, through the port's own training and quantization
    flow, and the export evaluated through the served kernels.

    Float training: 60 steps of ``train.loop.run`` with ``sgdm(lr=0.1,
    warmup=6)`` and a checkpoint directory, ``quant="none"``; the loss
    finite and its mean over the last 10 steps below the first 10's; step
    ms (median, each step ended by a synchronisation), images/s.  Resume
    bitwise in deterministic mode (``resume_check``).  PTQ with the
    percentile observer on ``calibration_batches(4, 128)`` (seconds,
    synchronised), ``validate_export`` bitwise across ``cuda``,
    ``cuda-stream`` and ``torch-int`` on the card, the calibration's JSON
    read back equal.  QAT: ``fine_tune`` for 20 steps on the calibrated
    recipe (step ms), then re-calibration, re-export and the bitwise gate
    again; a profile of five float and five QAT steps
    (``step_profile``).  Evaluation on a 1,024-image
    ``synthetic_eval_set``: the QAT export through ``ResNetEngine`` on
    ``cuda``, ``cuda-stream`` and ``torch-int`` and through
    ``ShardedResNetEngine`` on ``cuda``, top-1 identical and one capture a
    bucket (images/s as the harness times it, the first tick's graph
    capture included, and again on ``cuda`` and ``cuda-stream`` engines
    whose bucket is built first); the PTQ export on ``cuda``; the float
    reference (``evaluate_float``).  The launch counters, zeroed just before the
    evaluation and read just after, show ``conv_stem`` and
    ``resblock_fused`` once a bucket run of each ``cuda`` engine and
    ``block_chain`` once a bucket run on ``cuda-stream``: graph replays."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(R.RESNET20, quant="none")
    params0 = R.params_to(R.init_params(
        cfg, torch.Generator().manual_seed(seed)), dev)

    # -- float training ---------------------------------------------------
    opt = opt_lib.sgdm(lr=0.1, total_steps=TRAIN_STEPS, warmup=TRAIN_WARMUP)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    losses = []

    def logged(p, s, i, b):
        out = step(p, s, i, b)
        losses.append(out[2]["loss"])
        return out

    pipe = TimedPipeline(SyntheticCifar(TRAIN_BATCH, seed))
    ckpt_dir = tempfile.mkdtemp(prefix="repro-train-")
    try:
        params, _, metrics = train_loop.run(
            train_loop.LoopConfig(total_steps=TRAIN_STEPS, ckpt_dir=ckpt_dir,
                                  ckpt_every=TRAIN_STEPS // 2,
                                  log_every=10 ** 9),
            params=params0, opt_state=opt.init(params0), train_step=logged,
            pipeline=pipe, log=lambda *_: None)
        ckpts = checkpoint.latest_steps(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), "train: a loss not finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"train: the loss did not fall ({first} -> {last})")
    check(ckpts == [TRAIN_STEPS // 2 - 1, TRAIN_STEPS - 1],
          f"train: checkpoints at steps {ckpts}")
    # the first steps pick cuDNN's kernels; the median is the steady state
    step_ms = float(np.median(pipe.step_ms()[5:]))
    resume = resume_check(cfg, params0, seed, dev)

    # -- PTQ ----------------------------------------------------------------
    batches = calibration_batches(CALIB_BATCHES, TRAIN_BATCH, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params_bn, calib, qp_ptq = ptq_quantize(cfg, params, batches,
                                            observer="percentile")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    gate = validate_export(cfg, qp_ptq, batches[0]["images"], device=dev)
    check(gate["bit_exact"] and gate["max_abs_dev"] == 0.0,
          f"train: PTQ export not bitwise across {gate['backends']}")
    back = CalibrationResult.from_dict(json.loads(json.dumps(
        calib.to_dict())))
    check(back == calib, "train: the calibration's JSON reads back unequal")

    # -- QAT ----------------------------------------------------------------
    qat_pipe = TimedPipeline(SyntheticCifar(TRAIN_BATCH, seed))
    params_q, qat_metrics = fine_tune(
        cfg, params_bn, QuantRecipe.from_calibration(calib, cfg), qat_pipe,
        steps=QAT_STEPS, lr=0.01, log=lambda *_: None)
    check(math.isfinite(float(qat_metrics["loss"])), "train: QAT loss")
    qat_step_ms = float(np.median(qat_pipe.step_ms()[3:]))
    recipe = QuantRecipe.from_calibration(calib, cfg)
    profiles = {
        "float": step_profile(step, params, opt.init(params), batches[0]),
        "qat": step_profile(make_train_step(
            lambda p, b: qat_loss(p, cfg, recipe, b), opt, dev),
            params_bn, opt.init(params_bn), batches[0])}
    params_qbn, calib_q, qp_qat = ptq_quantize(cfg, params_q, batches,
                                               observer="percentile")
    gate_q = validate_export(cfg, qp_qat, batches[0]["images"], device=dev)
    check(gate_q["bit_exact"] and gate_q["max_abs_dev"] == 0.0,
          f"train: QAT export not bitwise across {gate_q['backends']}")

    # -- evaluation through the served kernels ------------------------------
    images, labels = synthetic_eval_set(EVAL_N, seed=seed)
    float_ref = evaluate_float(cfg, params_bn, images, labels,
                               batch=TRAIN_BATCH, device=dev)
    float_qat = evaluate_float(cfg, params_qbn, images, labels,
                               batch=TRAIN_BATCH, device=dev)
    before = read_launches()
    write_launches({op: (0, {p: 0 for p in by}) for op, (_, by)
                    in before.items()})
    evals = {}
    for name, kw in (("cuda", dict(backend="cuda")),
                     ("cuda-stream", dict(backend="cuda-stream")),
                     ("torch-int", dict(backend="torch-int")),
                     ("sharded-cuda", dict(backend="cuda", replicas=1))):
        evals[name] = evaluate_compiled(cfg, qp_qat, images, labels,
                                        batch=TRAIN_BATCH, device=dev, **kw)
    ptq = evaluate_compiled(cfg, qp_ptq, images, labels, backend="cuda",
                            batch=TRAIN_BATCH, device=dev)
    ran = {op.__name__: n for op, (n, _) in read_launches().items()}
    write_launches(before)
    top1 = {k: v["top1"] for k, v in evals.items()}
    check(len(set(top1.values())) == 1,
          f"train: top-1 differs across the engines: {top1}")
    check(all(v["retraces"] == 1 for v in evals.values()) and
          ptq["retraces"] == 1, "train: a bucket captured twice")
    runs = EVAL_N // TRAIN_BATCH
    want = dict(conv_stem_op=3 * runs, resblock_fused_op=3 * runs * 9,
                block_chain_op=runs)
    check(all(ran[k] == v for k, v in want.items()) and
          sum(ran.values()) == sum(want.values()),
          f"train: eval launches {ran}, want {want}")
    # the harness times the first tick's graph capture too (as the
    # reference does); a served model is captured at start, so also time
    # engines whose buckets are built first
    warm = {}
    for backend in ("cuda", "cuda-stream"):
        eng = ResNetEngine(cfg, qp_qat, batch=TRAIN_BATCH, backend=backend,
                           device=dev)
        eng.model.warmup()
        res = evaluate_engine(eng, images, labels)
        check(res["top1"] == top1["cuda"], f"train: warm {backend} top-1")
        warm[backend] = res["fps"]
    gap = float_ref["top1"] - ptq["top1"]
    summary = dict(
        model=cfg.name, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
        loss_first10=first, loss_last10=last, final=dict(
            loss=float(metrics["loss"]), acc=float(metrics["acc"])),
        train_step_ms=step_ms,
        train_images_per_s=TRAIN_BATCH / (step_ms * 1e-3),
        step_profiles=profiles,
        resume=resume, calibration_s=calib_s,
        ptq_export=dict(gate, backends=list(gate["backends"])),
        qat_steps=QAT_STEPS, qat_step_ms=qat_step_ms,
        qat_export=dict(gate_q, backends=list(gate_q["backends"])),
        eval_n=EVAL_N, float_top1=float_ref["top1"],
        float_top1_after_qat=float_qat["top1"], ptq_top1=ptq["top1"],
        ptq_gap=gap, qat_top1=top1["cuda"],
        qat_recovers_half=top1["cuda"] >= float_ref["top1"] - max(gap, 0) / 2,
        eval_top1=top1,
        eval_images_per_s={k: v["fps"] for k, v in evals.items()},
        eval_images_per_s_built_first=warm,
        eval_launches={k[:-3]: v for k, v in ran.items()},
        phase_s=time.perf_counter() - t_phase)
    emit("train", **summary)
    return summary


# ---------------------------------------------------------------------------
# Serving at scale: ShardedResNetEngine over a replica pool
# ---------------------------------------------------------------------------

SHARDED_REQUESTS = 512
SHARDED_DEADLINE_MS = 5.0
SHARDED_SLACK_MS = 1.0
PACED_RATE = 20_000     # offered images/s of the open-loop pass (Poisson)


def resnet_qparams(cfg, seed):
    return R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(seed))), cfg)


def pct(xs):
    a = np.asarray(xs, np.float64)
    return dict(p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)), max=float(a.max()))


def sharded_serve_phase(cfg, seed, backend):
    """``SHARDED_REQUESTS`` images through ``ShardedResNetEngine`` with a
    replica on every card, each with a 5 ms deadline under a 1 ms
    coalescing window.  The pool is built first (every bucket on every
    card); the same images are then served three times: arriving in seeded
    bursts of 1-48 with a scheduler round after each burst, traced (the
    profiler's kernel events against the plan once a bucket run, and the
    counters) and then timed (the closed-loop rate), and arriving open-loop
    at ``PACED_RATE`` images/s (seeded Poisson gaps), where the coalescer
    dispatches partial batches.  Each micro-batch's logits bitwise equal
    ``ResNetEngine``'s model on the same batch; the whole run against
    ``ResNetEngine`` serving the same images in its own batches (bitwise
    where the float head is batch-invariant, within 1e-5 and equal argmax
    in any case); no capture during any run."""
    qp = resnet_qparams(cfg, seed)
    rng = np.random.default_rng(seed + 17)
    imgs = rng.uniform(0.0, 0.999, (SHARDED_REQUESTS, 32, 32, 3)).astype(
        np.float32)
    bursts = []
    while sum(bursts) < SHARDED_REQUESTS:
        bursts.append(int(min(rng.integers(1, 49),
                              SHARDED_REQUESTS - sum(bursts))))
    n_dev = torch.cuda.device_count()
    eng = ShardedResNetEngine(cfg, qp, batch=BUCKET, backend=backend,
                              replicas=n_dev, batch_sizes=BUCKETS,
                              slack_ms=SHARDED_SLACK_MS)
    m = eng.model
    t0 = time.perf_counter()
    eng.pool.warmup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want_placed = sorted((b, f"cuda:{i}") for b in BUCKETS
                         for i in range(n_dev))
    check(m.trace_counts == {b: n_dev for b in BUCKETS} and
          m.compile_count == len(BUCKETS) * n_dev and
          m.stats()["placed"] == want_placed and not m.stats()["compiled"],
          f"sharded {backend}: pool build {m.stats()}, want one capture of "
          f"each bucket on each of {n_dev} cards")
    built = (dict(m.trace_counts), m.compile_count)

    batches = []                        # (images, logits) of each dispatch
    run = eng.pool.run

    def recorded(index, x):
        out = run(index, x)
        batches.append((x, out))
        return out

    eng.pool.run = recorded

    def drive():
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
        sreqs, i = [], 0
        for k in bursts:
            sreqs += [eng.submit(r, deadline_ms=SHARDED_DEADLINE_MS)
                      for r in reqs[i:i + k]]
            i += k
            eng.tick()
        eng.run()
        return reqs, sreqs

    runs0 = dict(m.run_counts)
    conv_stem_op.launches = resblock_fused_op.launches = 0
    block_chain_op.launches = conv2d_int8_op.launches = 0
    (reqs, _), ran, _ = traced_launches(drive)
    launches = dict(conv_stem=conv_stem_op.launches,
                    resblock_fused=resblock_fused_op.launches,
                    block_chain=block_chain_op.launches,
                    conv2d_int8=conv2d_int8_op.launches)
    runs = sum(m.run_counts.values()) - sum(runs0.values())
    per_run, chains = launch_plan(cfg, backend)
    check(eng.served == SHARDED_REQUESTS and all(r.done for r in reqs),
          f"sharded {backend}: {eng.served} of {SHARDED_REQUESTS} served")
    check(launches == {k: runs * v for k, v in per_run.items()},
          f"sharded {backend}: launch counts {launches} for {runs} bucket "
          f"runs of {per_run}")
    check_traced(ran, launches, per_run, runs, f"sharded {cfg.name} "
                                               f"{backend}")
    traced_batches = len(batches)

    t0 = time.perf_counter()
    reqs2, sreqs = drive()
    wall = time.perf_counter() - t0
    check(eng.served == 2 * SHARDED_REQUESTS and all(r.done for r in reqs2),
          f"sharded {backend}: the timed run left requests unserved")
    timed_batches = len(batches)

    arrivals = np.cumsum(rng.exponential(1.0 / PACED_RATE, len(imgs)))
    reqs3 = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    paced, i = [], 0
    t0 = time.perf_counter()
    while i < len(reqs3):
        now = time.perf_counter() - t0
        while i < len(reqs3) and arrivals[i] <= now:
            paced.append(eng.submit(reqs3[i],
                                    deadline_ms=SHARDED_DEADLINE_MS))
            i += 1
        eng.tick()
    eng.run()
    paced_wall = time.perf_counter() - t0
    check(eng.served == 3 * SHARDED_REQUESTS and all(r.done for r in reqs3),
          f"sharded {backend}: the paced run left requests unserved")
    check((dict(m.trace_counts), m.compile_count) == built,
          f"sharded {backend}: a capture during serving: {m.trace_counts}")
    eng.pool.run = run

    # every micro-batch against ResNetEngine's model on the same batch
    plain = ResNetEngine(cfg, qp, batch=BUCKET, backend=backend,
                         batch_sizes=BUCKETS)
    for x, out in batches:
        check(torch.equal(out, plain.model(x)),
              f"sharded {backend}: a bucket-{m.bucket_for(x.shape[0])} "
              f"micro-batch differs from ResNetEngine's model on it")
    logits = np.stack([r.logits for r in reqs])
    for again in (reqs2, reqs3):
        check(np.array_equal(logits, np.stack([r.logits for r in again])),
              f"sharded {backend}: two runs served different logits")
    preqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    for r in preqs:
        plain.submit(r)
    plain.run()
    plain_logits = np.stack([r.logits for r in preqs])
    dev_max = float(np.abs(logits - plain_logits).max())
    check(dev_max <= LOGIT_ATOL and np.array_equal(
        logits.argmax(-1), plain_logits.argmax(-1)),
          f"sharded {backend}: logits deviate {dev_max} from ResNetEngine")

    used = {b: k - runs0.get(b, 0) for b, k in m.run_counts.items()}

    def buckets(recs):
        out = {}
        for x, _ in recs:
            b = m.bucket_for(x.shape[0])
            out[b] = out.get(b, 0) + 1
        return out

    def latency(srs):
        met = [s.deadline_met for s in srs]
        return dict(queue_wait_ms=pct([s.queue_wait * 1e3 for s in srs]),
                    compute_ms=pct([s.compute_time * 1e3 for s in srs]),
                    deadlines_met=int(sum(met)), deadlines_total=len(met))

    summary = dict(
        replicas=n_dev, requests=SHARDED_REQUESTS, bursts=len(bursts),
        deadline_ms=SHARDED_DEADLINE_MS, slack_ms=SHARDED_SLACK_MS,
        images_per_s=SHARDED_REQUESTS / wall, wall_s=wall,
        pool_build_s=build_s,
        dispatches=timed_batches - traced_batches,
        bucket_runs_timed=buckets(batches[traced_batches:timed_batches]),
        bucket_runs_all=used, **latency(sreqs),
        paced=dict(offered_images_per_s=PACED_RATE,
                   images_per_s=SHARDED_REQUESTS / paced_wall,
                   dispatches=len(batches) - timed_batches,
                   bucket_runs=buckets(batches[timed_batches:]),
                   **latency(paced)),
        per_replica_served=[r.served for r in eng.sched.replicas],
        bitwise_with_resnet_engine=bool(dev_max == 0.0),
        max_abs_dev_resnet_engine=dev_max,
        micro_batches_bitwise=True, trace_counts=dict(m.trace_counts),
        traced_launches=ran, launches=launches, traced_runs=runs,
        chains=chains)
    emit("sharded_serve", model=cfg.name, backend=backend, **summary)
    return summary


# ---------------------------------------------------------------------------
# Traffic and health: repro_torch.traffic over the port's engines
# ---------------------------------------------------------------------------

TRAFFIC_BATCH = 8       # the simulator's bucket (the traffic CLI's --batch)
SIM_RATE = 2400.0       # mean arrivals/s of the simulated bursty trace
SIM_DURATION = 0.5      # seconds of virtual time
SIM_BURST_S = 0.05      # mean ON and OFF periods of the bursty trace
SIM_REPLICAS = 4        # the primary autoscales over 1..4 replicas
HEALTH_INTERVAL_S = 0.02
LIVE_SLACK_MS = 1.0
LIVE_IMAGES = 256       # request i carries image i % 256
# the live legs: (name, arrival process, SLO classes; None = the defaults)
LIVE_LEGS = (
    ("steady", dict(pattern="poisson", rate=20_000.0, duration=0.5), None),
    ("overload", dict(pattern="onoff", on_rate=120_000.0, on_s=0.05,
                      off_s=0.05, duration=0.5),
     "interactive:2:0:strict,standard:3:1:degrade,bulk:5:2:drop"),
)
CLI_REQUESTS = 256
CLI_RATE = 20_000.0


def zero_resnet_launches():
    conv_stem_op.launches = resblock_fused_op.launches = 0
    block_chain_op.launches = conv2d_int8_op.launches = 0


def resnet_launches():
    return dict(conv_stem=conv_stem_op.launches,
                resblock_fused=resblock_fused_op.launches,
                block_chain=block_chain_op.launches,
                conv2d_int8=conv2d_int8_op.launches)


class RecordedModel:
    """A ``CompiledModel`` that keeps each call's input batch and logits:
    what the simulator's dispatches computed, to be checked after the
    run (its own calls are not the run's)."""

    def __init__(self, model):
        self.model = model
        self.calls = []

    def __call__(self, x):
        out = self.model(x)
        self.calls.append((np.asarray(x), out))
        return out


def traffic_sim_run(models, classes, arrivals, images, bundle_dir):
    """One run of the traffic CLI's virtual-time simulation: ResNet20 as the
    primary (``SIM_REPLICAS`` replicas behind the autoscaler), ResNet8 as
    the degrade variant, each served at the paper's Kria KV260 FPGA rate
    (``PAPER_FPS``; the card's own speed is invisible in virtual time),
    a passive ``HealthMonitor`` with a ``FlightRecorder`` on a session
    bound to the simulation's clock, dumping a bundle into ``bundle_dir``
    on each alert.  ``models`` maps a variant to its model (none: queueing
    only).  Returns (sim, report, alert log, the bundles read back)."""
    clock = FakeClock()
    ob = obs_runtime.instrument(clock=clock)
    try:
        rec = FlightRecorder()
        rec.attach(ob.trace)
        health = HealthMonitor(ob, rules=default_rules(
            [c.name for c in classes]), interval_s=HEALTH_INTERVAL_S,
            recorder=rec, bundle_dir=bundle_dir)
        ob.health = health
        scaler = Autoscaler(AutoscaleConfig(
            min_replicas=1, max_replicas=SIM_REPLICAS, cooldown_s=0.05),
            clock=clock)
        servers = {arch: SimServer(
            arch, ServiceModel.from_fps(PAPER_FPS[arch]), clock,
            replicas=SIM_REPLICAS if arch == "resnet20" else 1,
            max_batch=TRAFFIC_BATCH, slack_ms=2.0, model=models.get(arch),
            active=scaler.active if arch == "resnet20" else None)
            for arch in ("resnet20", "resnet8")}
        router = OverloadRouter(classes, primary="resnet20",
                                degraded="resnet8")
        sim = TrafficSim(servers, classes, router, clock, autoscaler=scaler,
                         health=health)
        report = sim.run(arrivals, images=images)
    finally:
        obs_runtime.disable()
    return sim, report, health.alert_log_jsonl(), [
        read_bundle(b) for b in health.bundles]


def class_summary(report):
    return {name: dict(submitted=c["submitted"], served=c["count"],
                       degraded=c["degraded"], dropped=c["dropped"],
                       deadline_hit_rate=c["deadline_hit_rate"],
                       queue_wait_ms=c["queue_wait_ms"],
                       compute_ms=c["compute_ms"])
            for name, c in report["classes"].items()}


def traffic_sim_phase(qps, dev, seed, out_dir):
    """(a) The simulator with real models on the card: ``cuda-stream``
    ``CompiledModel``s at bucket ``TRAFFIC_BATCH`` (so ``block_chain``
    runs), replaying the bursty trace of the CPU cross-check.  Every
    request's logits bitwise the same model's eager forward on its
    dispatch's batch and within 1e-5 of ``torch-int`` with equal argmax;
    the schedule and report equal to a run with no model; the alert log
    and the bundles of two runs identical; ``block_chain``'s counter =
    dispatches x plan, and so are the kernels the profiler saw the card
    run."""
    classes = parse_classes(None)
    arrivals = make_process(
        "bursty", SIM_RATE, seed=seed,
        class_mix={c.name: 1.0 for c in classes}, burst_on_s=SIM_BURST_S,
        burst_off_s=SIM_BURST_S).generate(horizon_s=SIM_DURATION)
    rng = np.random.default_rng(seed + 29)
    images = rng.uniform(0.0, 0.999, (len(arrivals), 32, 32, 3)).astype(
        np.float32)
    row_of = {im.tobytes(): i for i, im in enumerate(images)}
    served_models = {arch: compile_model(cfg, qp, backend="cuda-stream",
                                         batch_sizes=(TRAFFIC_BATCH,),
                                         device=dev).warmup()
                     for arch, (cfg, qp) in qps.items()}
    int_models = {arch: compile_model(cfg, qp, backend="torch-int",
                                      batch_sizes=(TRAFFIC_BATCH,),
                                      device=dev)
                  for arch, (cfg, qp) in qps.items()}
    recorded = {arch: RecordedModel(m) for arch, m in served_models.items()}
    def timed_run():
        t0 = time.perf_counter()
        out = traffic_sim_run(recorded, classes, arrivals, images,
                              os.path.join(out_dir, "sim1"))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    zero_resnet_launches()
    ((sim, report, log, bundles), wall), ran, _ = traced_launches(timed_run)
    launches = resnet_launches()
    dispatches = {arch: len(r.calls) for arch, r in recorded.items()}
    want = {k: 0 for k in launches}
    for arch, (cfg, _) in qps.items():
        per_run, _ = launch_plan(cfg, "cuda-stream")
        for k, v in per_run.items():
            want[k] += dispatches[arch] * v
    check(launches == want and launches["block_chain"] > 0,
          f"traffic sim: launch counts {launches} for {dispatches} "
          f"dispatches, want {want}")
    check_traced_want(ran, launches, want,
                      f"traffic sim ({dispatches} dispatches)")

    where = {}
    max_dev = 0.0
    for arch, rec in recorded.items():
        m = served_models[arch]
        for k, (x, out) in enumerate(rec.calls):
            xt = torch.as_tensor(x, device=dev)
            n = x.shape[0]
            check(torch.equal(out, m._forward(m.pad(xt))[:n]),
                  f"traffic sim {arch}: dispatch {k} differs from the "
                  f"eager lowered forward on its batch")
            ref = int_models[arch](xt)
            dev_k = float((out - ref).abs().max())
            check(dev_k <= LOGIT_ATOL and torch.equal(out.argmax(-1),
                                                      ref.argmax(-1)),
                  f"traffic sim {arch}: dispatch {k} deviates {dev_k} from "
                  f"torch-int")
            max_dev = max(max_dev, dev_k)
            host = out.cpu().numpy()
            for j in range(n):
                where[row_of[x[j].tobytes()]] = (arch, host[j])
    done = [r for r in sim.requests if r.done]
    check(len(done) == report["totals"]["served"] == len(where),
          f"traffic sim: {len(done)} served, {len(where)} dispatched rows")
    for r in done:
        arch, logits = where[r.rid]
        check(r.variant == arch and np.array_equal(r.logits, logits),
              f"traffic sim: request {r.rid} was not served the logits of "
              f"its dispatch")

    _, again, log2, bundles2 = traffic_sim_run(
        served_models, classes, arrivals, images,
        os.path.join(out_dir, "sim2"))
    _, queueing, log3, _ = traffic_sim_run(
        {}, classes, arrivals, images, os.path.join(out_dir, "sim3"))
    check(log == log2,
          "traffic sim: the alert logs of two runs on the card differ")
    check(len(bundles) == len(bundles2) and all(
        a == b for a, b in zip(bundles, bundles2)),
        "traffic sim: the bundles of two runs on the card differ")
    for key in ("totals", "classes", "servers", "autoscaler"):
        check(report[key] == again[key] == queueing[key],
              f"traffic sim: {key} depends on the arithmetic: {report[key]}"
              f" / {again[key]} / {queueing[key]}")
    check(log == log3, "traffic sim: the alert log depends on the model")
    summary = dict(
        arrivals=len(arrivals), offered_rate=SIM_RATE,
        duration_s=SIM_DURATION, dispatches=dispatches,
        launches=launches, traced_launches=ran, wall_s=wall, max_abs_dev_torch_int=max_dev,
        totals=report["totals"], classes=class_summary(report),
        autoscaler={k: report["autoscaler"][k] for k in (
            "active", "scale_events", "last_reason")},
        alerts=report["health"]["alerts"],
        alerts_by_rule=report["health"]["by_rule"],
        alert_log_bytes=len(log), bundles=len(bundles),
        bundle_reasons=[b["manifest"]["reason"] for b in bundles],
        bitwise_eager=True,
        schedule_equals_no_model=True)
    emit("traffic_sim", backend="cuda-stream", bucket=TRAFFIC_BATCH,
         service_model="paper Table 3, Kria KV260 FPGA", **summary)
    return summary


def live_images(seed):
    rng = np.random.default_rng(seed + 31)
    return rng.uniform(0.0, 0.999, (LIVE_IMAGES, 32, 32, 3)).astype(
        np.float32)


def leg_arrivals(spec, seed, classes):
    mix = {c.name: 1.0 for c in classes}
    if spec["pattern"] == "onoff":
        return OnOffProcess(spec["on_rate"], mean_on_s=spec["on_s"],
                            mean_off_s=spec["off_s"], seed=seed,
                            class_mix=mix).generate(
                                horizon_s=spec["duration"])
    return make_process(spec["pattern"], spec["rate"], seed=seed,
                        class_mix=mix).generate(horizon_s=spec["duration"])


def record_dispatches(eng, arch, records):
    """Record each dispatch of ``eng`` through its ``dispatch_listeners``:
    the payloads of the micro-batch and the logits its replica computed."""
    eng.dispatch_listeners.append(lambda d, out: records.append(
        (arch, [r.payload for r in d.requests], out)))


def counter_by_class(ob, name, **match):
    c = ob.metrics.get(name)
    out = {}
    if c is None:
        return out
    for key, value in c.labelled():
        labels = dict(key)
        if all(labels.get(k) == v for k, v in match.items()):
            out[labels["cls"]] = out.get(labels["cls"], 0) + value
    return out


def live_leg(name, spec, classes_spec, qps, devices, refs, seed, out_dir,
             observed=True, traced=False):
    """One leg of (b): ``LiveTrafficRunner`` over a ``ShardedResNetEngine``
    a variant on ``cuda`` (one replica a card for the primary), buckets
    (1, 8, 32), a 1 ms coalescing window, a ``HealthMonitor`` with a
    ``FlightRecorder`` writing bundles, alerts actuating the router and
    the autoscaler.  ``observed=False`` runs the same leg with no obs
    session and no monitor: what the obs instrumentation costs the loop.
    ``traced=True`` runs it under ``traced_launches``: the kernels the
    card ran are the plan once a bucket run, and the counters agree.  The
    profiler slows the host loop, so a traced leg's rates are not the
    leg's rates."""
    classes = parse_classes(classes_spec)
    arrivals = leg_arrivals(spec, seed, classes)
    images = live_images(seed)
    variants, records = {}, []
    for arch, (cfg, qp) in qps.items():
        eng = ShardedResNetEngine(
            cfg, qp, batch=BUCKET, backend="cuda",
            devices=devices if arch == "resnet20" else devices[:1],
            batch_sizes=BUCKETS, slack_ms=LIVE_SLACK_MS)
        eng.pool.warmup()
        record_dispatches(eng, arch, records)
        variants[arch] = eng
    runs0 = {arch: sum(e.model.run_counts.values())
             for arch, e in variants.items()}
    bundle_dir = os.path.join(out_dir, name)
    ob = obs_runtime.instrument() if observed else None
    health = None
    try:
        if observed:
            rec = FlightRecorder()
            rec.attach(ob.trace)
            health = HealthMonitor(ob, rules=default_rules(
                [c.name for c in classes]), interval_s=HEALTH_INTERVAL_S,
                recorder=rec, bundle_dir=bundle_dir)
            health.census_extra.update(arch="resnet20",
                                       degrade_arch="resnet8",
                                       backend="cuda", leg=name)
            ob.health = health
        scaler = Autoscaler(AutoscaleConfig(
            min_replicas=1, max_replicas=len(devices)),
            clock=variants["resnet20"].clock, health=health)
        variants["resnet20"].set_active_replicas(scaler.active)
        router = OverloadRouter(classes, primary="resnet20",
                                degraded="resnet8", health=health)
        runner = LiveTrafficRunner(variants, classes, router,
                                   autoscaler=scaler, health=health)
        def timed_run():
            t0 = time.perf_counter()
            out = runner.run(arrivals, images)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        zero_resnet_launches()
        if traced:
            (report, wall), ran, _ = traced_launches(timed_run)
        else:
            (report, wall), ran = timed_run(), None
        launches = resnet_launches()
    finally:
        if observed:
            obs_runtime.disable()

    runs = {arch: sum(e.model.run_counts.values()) - runs0[arch]
            for arch, e in variants.items()}
    want = {k: 0 for k in launches}
    for arch, (cfg, _) in qps.items():
        per_run, _ = launch_plan(cfg, "cuda")
        for k, v in per_run.items():
            want[k] += runs[arch] * v
    check(launches == want and launches["conv_stem"] > 0 and
          launches["resblock_fused"] > 0,
          f"traffic {name}: launch counts {launches} for bucket runs "
          f"{runs}, want {want}")
    if traced:
        check_traced_want(ran, launches, want,
                          f"traffic {name} ({runs} bucket runs)")

    # every dispatch bitwise ResNetEngine's model on the same batch, every
    # request its row of it and bitwise what ResNetEngine serving the
    # image in its own batches gave; every logit within 1e-5 of torch-int
    served = 0
    dev_int = 0.0
    for arch, payloads, out in records:
        x = np.stack([p.image for p in payloads])
        check(torch.equal(out, refs[arch]["engine"].model(x)),
              f"traffic {name} {arch}: a dispatch differs from "
              f"ResNetEngine's model on its batch")
        host = out.cpu().numpy()
        for j, p in enumerate(payloads):
            check(p.done and np.array_equal(p.logits, host[j]),
                  f"traffic {name}: request {p.rid} was not served its "
                  f"dispatch's logits")
            k = p.rid % LIVE_IMAGES
            check(np.array_equal(p.logits, refs[arch]["served"][k]),
                  f"traffic {name} {arch}: request {p.rid} differs from "
                  f"ResNetEngine serving image {k}")
            d_int = float(np.abs(p.logits - refs[arch]["int"][k]).max())
            check(d_int <= LOGIT_ATOL and
                  p.logits.argmax() == refs[arch]["int"][k].argmax(),
                  f"traffic {name} {arch}: request {p.rid} deviates "
                  f"{d_int} from torch-int")
            dev_int = max(dev_int, d_int)
            served += 1

    t = report["totals"]
    check(served == t["served"] and
          t["submitted"] == len(arrivals) == t["served"] + t["dropped"],
          f"traffic {name}: {len(arrivals)} arrivals, report {t}, "
          f"{served} dispatched rows")
    strict = [c.name for c in classes if c.policy == "strict"]
    for c in classes:
        r = report["classes"][c.name]
        check(r["submitted"] == r["count"] + r["dropped"],
              f"traffic {name} {c.name}: {r['submitted']} submitted, "
              f"{r['count']} served, {r['dropped']} dropped")
        check(c.name not in strict or r["degraded"] == r["dropped"] == 0,
              f"traffic {name}: strict class {c.name} was degraded or "
              f"dropped")
    summary = dict(
        arrivals=len(arrivals), spec=spec, observed=observed, traced=traced,
        wall_s=wall,
        host_us_per_arrival=wall / len(arrivals) * 1e6,
        duration_s=report["duration_s"],
        images_per_s=t["served"] / report["duration_s"],
        totals=t, classes=class_summary(report),
        compute_ms=report["servers"]["resnet20"]["compute_ms"],
        queue_wait_ms=report["servers"]["resnet20"]["queue_wait_ms"],
        bucket_runs=runs, launches=launches, traced_launches=ran,
        autoscaler={k: report["autoscaler"][k] for k in (
            "active", "scale_events", "last_reason")},
        strict_classes=strict, max_abs_dev_torch_int=dev_int,
        bitwise_resnet_engine=True)
    if observed:
        summary.update(leg_health(name, ob, health, report, classes,
                                  bundle_dir))
    emit("traffic_live", leg=name, backend="cuda", **summary)
    return summary


def leg_health(name, ob, health, report, classes, bundle_dir):
    """The observed leg's checks: the registry's ``slo_*`` counters equal
    the report, every bundle reads back, the alert log parses."""
    submitted = counter_by_class(ob, "slo_submitted_total")
    dropped = counter_by_class(ob, "slo_dropped_total")
    served_c = counter_by_class(ob, "slo_served_total")
    degraded_c = counter_by_class(ob, "slo_served_total", degraded="true")
    for c in classes:
        r = report["classes"][c.name]
        check((submitted.get(c.name, 0), dropped.get(c.name, 0),
               served_c.get(c.name, 0), degraded_c.get(c.name, 0)) ==
              (r["submitted"], r["dropped"], r["count"], r["degraded"]),
              f"traffic {name} {c.name}: the slo_* counters disagree with "
              f"the report")
    bundles = [read_bundle(b) for b in health.bundles]
    check(all(b["manifest"]["census"]["leg"] == name for b in bundles),
          f"traffic {name}: a bundle lacks its census")
    log = os.path.join(bundle_dir, "alerts.jsonl")
    os.makedirs(bundle_dir, exist_ok=True)
    health.write_alert_log(log)
    alerts = load_alerts(log)
    check(len(alerts) == report["health"]["alerts"],
          f"traffic {name}: the alert log has {len(alerts)} alerts")
    return dict(alerts=len(alerts),
                alerts_by_rule=report["health"]["by_rule"],
                bundles=len(bundles))


def traffic_cli(out_dir, device):
    """(c) One in-process call of the ``launch.serve`` CLI on its SLO path:
    its metrics, alert log, bundles and trace each parse."""
    d = os.path.join(out_dir, "cli")
    os.makedirs(d, exist_ok=True)
    metrics, trace = os.path.join(d, "metrics.txt"), os.path.join(
        d, "trace.json")
    bundles = os.path.join(d, "bundles")
    t0 = time.perf_counter()
    report = launch_serve.main([
        "--arch", "resnet20", "--replicas", "1", "--batch", str(BUCKET),
        "--buckets", ",".join(map(str, BUCKETS)), "--requests",
        str(CLI_REQUESTS), "--arrival-rate", str(CLI_RATE),
        "--slo-classes",
        "interactive:25:0:strict,standard:50:1:degrade,bulk:200:2:drop",
        "--degrade-arch", "resnet8", "--alerts", "--bundle-dir", bundles,
        "--metrics-out", metrics, "--trace-out", trace,
        "--device", str(device)])
    wall = time.perf_counter() - t0
    t = report["totals"]
    check(t["submitted"] == CLI_REQUESTS == t["served"] + t["dropped"],
          f"traffic cli: {t}")
    with open(metrics) as f:
        parsed = parse_text(f.read())
    check("slo_submitted_total" in parsed and "sched_served_total" in parsed,
          "traffic cli: the metrics lack the slo/sched counters")
    alerts = load_alerts(alert_log_path(metrics))
    check(alerts == load_alerts(os.path.join(bundles, "alerts.jsonl")) and
          len(alerts) == report["health"]["alerts"],
          "traffic cli: the alert logs disagree")
    n_bundles = len([read_bundle(os.path.join(bundles, b))
                     for b in sorted(os.listdir(bundles))
                     if b.startswith("bundle_")])
    check(n_bundles == len(report["health"]["bundles"]),
          "traffic cli: bundles on disk and in the report differ")
    events = load_chrome_trace(trace)
    summary = dict(requests=CLI_REQUESTS, offered_rate=CLI_RATE,
                   wall_s=wall, totals=t, alerts=len(alerts),
                   bundles=n_bundles, trace_events=len(events),
                   metrics_series=len(parsed))
    emit("traffic_cli", **summary)
    return summary


def traffic_line(traffic):
    """The traffic summary that rides on the kernels line."""
    def leg(v):
        return dict(arrivals=v["arrivals"], images_per_s=v["images_per_s"],
                    totals={k: v["totals"][k] for k in (
                        "submitted", "served", "degraded", "dropped",
                        "deadline_hit_rate")},
                    hit_rates={c: d["deadline_hit_rate"]
                               for c, d in v["classes"].items()},
                    queue_wait_ms=v["queue_wait_ms"],
                    compute_ms=v["compute_ms"],
                    host_us_per_arrival=v["host_us_per_arrival"],
                    alerts_by_rule=v.get("alerts_by_rule"),
                    bundles=v.get("bundles"), autoscaler=v["autoscaler"])

    sim = traffic["sim"]
    return dict(sim={k: sim[k] for k in (
        "arrivals", "dispatches", "totals", "autoscaler", "alerts_by_rule",
        "max_abs_dev_torch_int")},
        live={name: leg(v) for name, v in traffic["live"].items()},
        live_traced={name: {k: v[k] for k in (
            "images_per_s", "host_us_per_arrival", "traced_launches")}
            for name, v in traffic["live_traced"].items()},
        cli={k: traffic["cli"][k] for k in ("totals", "alerts", "bundles")},
        launches=traffic["launches"], phase_s=traffic["phase_s"])


def traffic_phase(seed, dev, devices):
    """Phase 5a': ``repro_torch.traffic`` and ``obs.health`` on the card
    with ResNet20 (``init_params(seed)``) as the primary and ResNet8
    (``init_params(seed + 1)``) as the degrade variant, at full width:
    (a) the simulator, (b) the live legs, (c) the CLI.  The launch counters
    are zeroed just before each run and read just after it; the launches
    the phase reports are the kernels the profiler saw the card run in the
    simulator's run and in the traced live legs."""
    qps = {"resnet20": (R.RESNET20, resnet_qparams(R.RESNET20, seed)),
           "resnet8": (R.RESNET8, resnet_qparams(R.RESNET8, seed + 1))}
    t0 = time.perf_counter()

    # what each variant gives for each live image: ResNetEngine on cuda
    # serving the images in its own batches, and torch-int
    images = live_images(seed)
    refs = {}
    for arch, (cfg, qp) in qps.items():
        eng = ResNetEngine(cfg, qp, batch=BUCKET, backend="cuda",
                           batch_sizes=BUCKETS, device=dev)
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        refs[arch] = dict(engine=eng,
                          served=np.stack([r.logits for r in reqs]),
                          int=compile_model(
                              cfg, qp, backend="torch-int",
                              batch_sizes=(LIVE_IMAGES,),
                              device=dev)(images).cpu().numpy())

    out_dir = tempfile.mkdtemp(prefix="repro-traffic-")
    try:
        sim = traffic_sim_phase(qps, dev, seed, out_dir)
        torch.cuda.empty_cache()
        # the legs, and the steady leg again with no obs session (the
        # instrumentation's cost to the loop)
        name, spec, classes = LIVE_LEGS[0]
        runs = [(*leg, True) for leg in LIVE_LEGS] + [
            (name + "_no_obs", spec, classes, False)]
        legs = {name: live_leg(name, spec, classes, qps, devices, refs,
                               seed, out_dir, observed=observed)
                for name, spec, classes, observed in runs}
        # each of them again under the profiler, for the kernels the card
        # ran: the profiler slows the loop, so the rates are the runs above
        traced = {name: live_leg(name + "_traced", spec, classes, qps,
                                 devices, refs, seed, out_dir,
                                 observed=observed, traced=True)
                  for name, spec, classes, observed in runs}
        torch.cuda.empty_cache()
        cli = traffic_cli(out_dir, dev)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del refs
    torch.cuda.empty_cache()
    launches = dict(
        conv_stem=sum(v["traced_launches"]["conv_stem"]
                      for v in traced.values()),
        resblock_fused=sum(v["traced_launches"]["resblock_fused"]
                           for v in traced.values()),
        block_chain=sim["traced_launches"]["block_chain"])
    summary = dict(sim=sim, live=legs, live_traced=traced, cli=cli,
                   launches=launches,
                   phase_s=time.perf_counter() - t0)
    emit("traffic", launches=launches, phase_s=summary["phase_s"])
    return summary


# ---------------------------------------------------------------------------
# Tuning on the card's own knobs: repro_torch.tune
# ---------------------------------------------------------------------------

TUNE_TOP_K = 6
TUNE_REPS = 9         # interleaved samples a candidate pair
TUNE_CALLS = 20       # served calls a sample


def tuned_kernel_times(backend, tuning, dev, rng):
    """Device ms at bucket 32 of the kernels a backend runs, at the tuned
    knobs against each kernel's own rule (random operands at ResNet20's
    shapes, prepared launches, CUDA-graph replay)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    if backend == "cuda-stream":
        c = tuning["stem"]
        x, blocks, specs, stem, stem_shift = live_chain(
            rng, dev, df.resnet_block_shapes(3), BUCKET, 16)
        kw = dict(specs=specs, stem=stem, stem_shift=stem_shift)
        rule = ChainLaunch(blocks, in_shape=x.shape[1:], **kw)
        tuned = ChainLaunch(blocks, in_shape=x.shape[1:], config=c, **kw)
        check(torch.equal(tuned(x), rule(x)), "tuned block_chain differs")
        out["block_chain"] = dict(
            default_tiling=list(rule.tiling(BUCKET)),
            tuned_tiling=list(tuned.tiling(BUCKET)),
            default_ms=device_ms(lambda: rule(x), REPS),
            tuned_ms=device_ms(lambda: tuned(x), REPS))
        return out
    x, w, b = stem_case(rng, dev, BUCKET)
    c = tuning["stem"]
    check(torch.equal(conv_stem_op(x, w, b, shift=9, config=c),
                      conv_stem_op(x, w, b, shift=9)),
          "tuned conv_stem differs")
    out["conv_stem"] = dict(
        default_band=stem_band_rows(32, BUCKET, sms),
        tuned_band=c.band_rows or stem_band_rows(32, BUCKET, sms),
        default_ms=device_ms(lambda: conv_stem_op(x, w, b, shift=9), REPS),
        tuned_ms=device_ms(lambda: conv_stem_op(x, w, b, shift=9,
                                                config=c), REPS))
    rows = dict(default_bands=[], tuned_bands=[], default_ms=0.0,
                tuned_ms=0.0)
    for i, shp in enumerate(df.resnet_block_shapes(3)):
        ops = block_case(rng, dev, BUCKET, shp.h, shp.ich, shp.och,
                         shp.stride)
        kw = dict(stride=shp.stride, shift0=11, shift1=12, skip_shift=-2)
        rule = ResblockLaunch(*ops[1:], **kw)
        tuned = ResblockLaunch(*ops[1:], config=tuning[f"block{i}"], **kw)
        check(torch.equal(tuned(ops[0]), rule(ops[0])),
              f"tuned resblock_fused block{i} differs")
        rows["default_bands"].append(rule.band_rows(BUCKET, shp.oh))
        rows["tuned_bands"].append(tuned.band_rows(BUCKET, shp.oh))
        rows["default_ms"] += device_ms(lambda: rule(ops[0]), REPS)
        rows["tuned_ms"] += device_ms(lambda: tuned(ops[0]), REPS)
    out["resblock_fused"] = rows
    return out


def enumerated_configs_bitwise(backend, dev, rng):
    """Every config ``tune.space`` enumerates for ResNet20 at bucket 32 on
    ``backend`` (on the card, with its occupancy query), each kernel at it
    bitwise with its plain version on random operands of its shape, and the
    kernel's shared memory at it equal to the Python formula.  Returns the
    configs checked per kernel."""
    layers = {l.name: l for l in df.resnet20_layers()}
    checked = {}
    if backend == "cuda-stream":
        shapes = df.resnet_block_shapes(3)
        x, blocks, specs, stem, stem_shift = live_chain(rng, dev, shapes,
                                                        BUCKET, 16)
        kw = dict(specs=specs, stem=stem, stem_shift=stem_shift)
        want = block_chain_ref(x, blocks, **kw)
        tilings = space.chain_tilings(shapes, BUCKET, 16,
                                      capacity=chain_ops.max_clusters)
        for c in tilings:
            launch = ChainLaunch(blocks, in_shape=x.shape[1:], config=c, **kw)
            check(launch.tiling(BUCKET) == (c.batch_tile, c.split) and
                  chain_ops.smem_bytes(shapes, c.batch_tile, 16, c.split) ==
                  df.chain_task_smem_bytes(shapes, c.batch_tile, 16,
                                           c.split),
                  f"block_chain {c.describe()}: tiling or shared memory")
            check(torch.equal(launch(x), want),
                  f"block_chain at {c.describe()} differs from plain")
        checked["block_chain"] = [c.describe() for c in tilings]
        return checked
    x, w, b = stem_case(rng, dev, BUCKET)
    want = conv_stem_ref(x, w, b, shift=9)
    stems = space.stem_space(layers["stem"], BUCKET)
    for c in stems:
        check(band_smem_bytes(c.band_rows, 32, 3, 16) ==
              stem_ops._lib().conv_stem_band_smem_bytes(c.band_rows, 32, 3,
                                                        16),
              f"conv_stem band {c.band_rows}: shared memory formula")
        check(torch.equal(conv_stem_op(x, w, b, shift=9, config=c), want),
              f"conv_stem at {c.describe()} differs from plain")
    checked["conv_stem"] = [c.band_rows for c in stems]
    seen = {}
    for i, shp in enumerate(df.resnet_block_shapes(3)):
        key = (shp.h, shp.ich, shp.och, shp.stride)
        if key in seen:
            continue
        l0 = layers[f"c{i}_0"]
        ops = block_case(rng, dev, BUCKET, shp.h, shp.ich, shp.och,
                         shp.stride)
        kw = dict(stride=shp.stride, shift0=11, shift1=12, skip_shift=-2)
        want = resblock_ref(*ops, **kw)
        bands = space.block_space(l0, BUCKET, shp.downsample)
        for c in bands:
            check(smem_bytes(shp.h, shp.w, shp.ich, shp.och, shp.stride,
                             shp.downsample, c.band_rows) ==
                  df.resblock_task_smem_bytes(shp.h, shp.w, shp.ich, shp.och,
                                              shp.stride, shp.downsample,
                                              c.band_rows),
                  f"resblock_fused {key} band {c.band_rows}: shared memory")
            launch = ResblockLaunch(*ops[1:], config=c, **kw)
            check(torch.equal(launch(ops[0]), want),
                  f"resblock_fused {key} at {c.describe()} differs from "
                  f"plain")
        seen[key] = [c.band_rows for c in bands]
    checked["resblock_fused"] = {str(k): v for k, v in seen.items()}
    return checked


def tune_phase(seed, dev, backend, rng):
    """``tune.search`` for ResNet20 at bucket 32 on ``backend`` with device
    timing and validation: the winner measured (``source == "device"``,
    never a fallback), a second search answered from the cache, the tuned
    model bitwise with ``torch-int`` at every bucket, every enumerated
    config's kernel bitwise with its plain version, the tuned and default
    served images/s at bucket 32 measured interleaved, and the tuned
    kernels' times against their rules."""
    cfg = R.RESNET20
    qp = resnet_qparams(cfg, seed)
    t0 = time.perf_counter()
    res = T.search(cfg, qp, backend=backend, batch=BUCKET, top_k=TUNE_TOP_K,
                   device=True, validate=True, reps=TUNE_REPS,
                   calls=TUNE_CALLS)
    search_s = time.perf_counter() - t0
    check(res.source == "device",
          f"tune {backend}: source {res.source!r}, want 'device'")
    again = T.search(cfg, qp, backend=backend, batch=BUCKET)
    check(again.source == "cache" and again.tuning == res.tuning,
          f"tune {backend}: the second search was {again.source!r}")
    tuned = compile_model(cfg, qp, backend=backend, batch_sizes=BUCKETS,
                          tune=res.tuning)
    default = compile_model(cfg, qp, backend=backend, batch_sizes=BUCKETS)
    ref = compile_model(cfg, qp, backend="torch-int", batch_sizes=BUCKETS)
    x = torch.rand((REQUESTS, 32, 32, 3), device=dev,
                   generator=torch.Generator(dev).manual_seed(seed)) * 0.999
    for n in (REQUESTS, 1, 8):
        check(torch.equal(tuned(x[:n]), ref(x[:n])),
              f"tune {backend}: the tuned model differs from torch-int at "
              f"{n} images")
    check(tuned.stats()["tuning"] == res.config_dict(),
          f"tune {backend}: stats()['tuning'] is not the search's")
    us_t, us_d = T.interleaved_time(tuned, default, x[:BUCKET], reps=21,
                                    calls=50)
    checked = enumerated_configs_bitwise(backend, dev, rng)
    kernels = tuned_kernel_times(backend, res.tuning, dev, rng)
    summary = dict(
        tuning=res.config_dict(), chosen=res.describe(),
        candidates=res.candidates, space_size=res.space_size,
        timings_us=res.timings_us, search_s=search_s,
        served_us_tuned=us_t, served_us_default=us_d,
        images_per_s_tuned=BUCKET / (us_t * 1e-6),
        images_per_s_default=BUCKET / (us_d * 1e-6),
        cache_hit=True, enumerated_bitwise=checked, kernels=kernels)
    emit("tune", model=cfg.name, backend=backend, batch=BUCKET,
         source=res.source, **summary)
    return summary


# ---------------------------------------------------------------------------
# The LM path: matmul_int8, flash_attention, selective_scan
# ---------------------------------------------------------------------------

LM_MODELS = ("gemma-2b", "falcon-mamba-7b")
LM_SEQ = 512
LM_BUCKET = 4
LM_REQUESTS = 6   # one full bucket of 4, then 2 padded up to 4
LM_REPS = 10      # timed calls per LM kernel measurement
# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet, dense,
# at 700 W), the roofline of the two float kernels
F32_FLOPS_PER_S = 67e12
FLASH_TOL = 2e-5  # tests/test_kernels.py's flash tolerance (abs and rel)
SCAN_TOL = 1e-5   # tests/test_kernels.py's scan tolerance (abs and rel)
BF16_TOL = 2e-2   # tests/test_kernels.py's bf16 flash tolerance
ACC_INIT_RANGE = 1 << 20   # bias plus a skip shifted left by 10


def lm_cfg(name):
    return lm_config(get_config(name), seq_len=LM_SEQ)


def lm_matmul_shapes(cfg):
    """(roles, K, N, launches per layer) of every projection of ``cfg``."""
    d = cfg.d_model
    if cfg.family == "dense":
        qkv, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        return [("wq", d, qkv, 1), ("wk/wv", d, kv, 2), ("wo", qkv, d, 1),
                ("up", d, cfg.d_ff, 1), ("down", cfg.d_ff, d, 1)]
    return [("wu/wz/wdt", d, cfg.d_inner, 3), ("wb/wc", d, cfg.ssm_state, 2),
            ("wo", cfg.d_inner, d, 1)]


def close_err(got, ref, tol):
    """Largest excess of ``|got - ref|`` over ``tol * (1 + |ref|)`` (the
    assert_allclose criterion with rtol = atol = tol; <= 0 passes) and the
    largest absolute deviation."""
    got, ref = got.double(), ref.double()
    diff = (got - ref).abs()
    return float((diff - tol * (1 + ref.abs())).max()), float(diff.max())


def library_ms(fn, reps):
    """Device time of one PyTorch library call computing the kernel's
    function (the yardstick, used nowhere in the port), or None with the
    reason printed when this PyTorch refuses the call."""
    try:
        return device_ms(fn, reps)
    except RuntimeError as e:
        emit("library_call_refused", error=str(e)[:300])
        return None


def s8_unsaturated(acc):
    """Share of the int8 outputs strictly inside (-128, 127) when ``acc``
    is requantized by the shift that puts its 90th percentile of |acc| near
    100, as an LM grid would."""
    a = acc.abs().flatten()[:1 << 24].double()
    q = float(torch.quantile(a, 0.9)) if a.numel() else 1.0
    shift = max(int(math.ceil(math.log2(max(q, 1.0) / 100))), 0)
    y = shift_align(acc, -shift) if shift else acc
    return float(((y > -128) & (y < 127)).float().mean())


def matmul_ptxas():
    """``{path: [ptxas lines]}`` of the matmul_int8 library: ``wgmma/<bn>``
    per instantiated tile width, and ``mma_sync``."""
    out = {}
    for entry, lines in ptxas_by_entry("matmul_int8").items():
        if "matmul_int8_wgmmaILi" in entry:
            bn = entry.split("matmul_int8_wgmmaILi")[1].split("E")[0]
            out[f"wgmma/{bn}"] = lines
        elif "mma_sync" in entry:
            out["mma_sync"] = lines
    return out


def path_taken(before):
    """The one matmul_int8 path whose launch count rose since ``before``."""
    now = matmul_int8_op.launches_by_path
    rose = [p for p in now if now[p] != before[p]]
    check(len(rose) == 1 and now[rose[0]] == before[rose[0]] + 1,
          f"one matmul_int8 launch expected, paths {before} -> {now}")
    return rose[0]


def matmul_cases(what, a, b, inits, want_path):
    """matmul_int8 on ``b`` as (K, N) and packed, with each acc_init of
    ``inits``, bitwise against the plain version; every launch on
    ``want_path``.  Returns (cases, largest |error|)."""
    w = pack_weight(b)
    cases, err = 0, 0
    for init_name, acc in inits.items():
        ref = matmul_int8_ref(a, b, acc)
        for form, bb in (("(K,N)", b), ("packed", w)):
            before = dict(matmul_int8_op.launches_by_path)
            got = matmul_int8_op(a, bb, acc)
            torch.cuda.synchronize()
            path = path_taken(before)
            check(path == want_path, f"matmul_int8 {what} {form}: path {path}"
                                     f", expected {want_path}")
            err = max(err, max_abs_err(got, ref))
            check(torch.equal(got, ref),
                  f"matmul_int8 {what} {form} init={init_name} differs from "
                  f"plain")
            cases += 1
    return cases, err


def lm_matmul_phase(rng, dev):
    """matmul_int8 bitwise against its plain version at every projection
    shape of gemma-2b and falcon-mamba-7b at M = 2048 (bucket 4) and 512
    (bucket 1): B as (K, N) and packed, acc_init full, broadcast (the
    main path's bias, row stride 0) and none, every launch on the wgmma
    path; a wrap case (acc_init near +-2^31); the ragged shapes on the
    path their shape picks.  Timings at bucket 4: ``ms`` with packed B and
    a full M x N init (the generic form, bound counting that init), and
    ``main_ms`` in the main path's call form (packed B, broadcast bias,
    bound counting N x 4 bias bytes).  Returns the kernel record summed
    over one bucket-4 forward of each LM."""
    def i8(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape,
                                             dtype=np.int8)).to(dev)

    def i32(*shape, lo=-ACC_INIT_RANGE, hi=ACC_INIT_RANGE):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    ptx = matmul_ptxas()
    err, per_model, cases, shapes = 0, {}, 0, []
    sums = ("ms", "main_ms", "call_ms", "plain_ms", "library_ms")
    for name in LM_MODELS:
        cfg = lm_cfg(name)
        tot = dict({k: 0.0 for k in sums}, bytes=0, main_bytes=0, ops=0,
                   launches=0)
        for roles, K, N, count in lm_matmul_shapes(cfg):
            for M in (LM_BUCKET * LM_SEQ, LM_SEQ):
                a, b, init = i8(M, K), i8(K, N), i32(M, N)
                bias = i32(1, N).expand(M, N)
                what = f"{name} {roles} M={M} K={K} N={N}"
                c, e = matmul_cases(what, a, b, dict(
                    full=init, bias=bias, none=None), "wgmma")
                cases, err = cases + c, max(err, e)
                share = s8_unsaturated(matmul_int8_ref(a, b, init))
                check(share >= MIN_UNSATURATED,
                      f"matmul_int8 {what}: only {share:.3f} of int8 outputs "
                      f"inside (-128, 127)")
                if M != LM_BUCKET * LM_SEQ:
                    continue
                w = pack_weight(b)
                out = matmul_int8_op(a, w, init)
                bt = w.t
                t = dict(
                    ms=device_ms(lambda: matmul_int8_op(a, w, init), LM_REPS),
                    main_ms=device_ms(lambda: matmul_int8_op(a, w, bias),
                                      LM_REPS),
                    call_ms=call_ms(lambda: matmul_int8_op(a, w, bias),
                                    LM_REPS),
                    plain_ms=device_ms(lambda: matmul_int8_ref(a, b, init),
                                       LM_REPS),
                    library_rowmajor_ms=library_ms(
                        lambda: torch._int_mm(a, b) + init, LM_REPS),
                    library_colmajor_ms=library_ms(
                        lambda: torch._int_mm(a, bt.t()) + init, LM_REPS))
                libs = [v for v in (t["library_rowmajor_ms"],
                                    t["library_colmajor_ms"]) if v is not None]
                t["library_ms"] = min(libs) if libs else None
                ops = 2 * M * K * N
                moved = nbytes(a, b, init, out)
                main_moved = nbytes(a, b, out) + 4 * N
                t["bound_ms"], t["bound_by"] = bound(moved, ops)
                t["main_bound_ms"], t["main_bound_by"] = bound(main_moved, ops)
                t["tops"] = ops / (t["ms"] * 1e-3) / 1e12
                t["main_tops"] = ops / (t["main_ms"] * 1e-3) / 1e12
                t["main_peak_share"] = t["main_tops"] * 1e12 / INT8_OPS_PER_S
                bm, bn, bk, split = matmul_tiles(M, N, K)
                rec = dict(model=name, roles=roles, M=M, K=K, N=N,
                           launches_per_layer=count, path="wgmma",
                           tiles=[bm, bn, bk], split_k=split,
                           smem_bytes=mm_smem_bytes(bn),
                           ptxas=ptx.get(f"wgmma/{bn}"), bitwise=True,
                           int8_unsaturated_share=share, **t)
                shapes.append(rec)
                emit("kernel", name="matmul_int8", **rec)
                n = count * cfg.num_layers
                for k in sums:
                    tot[k] = None if tot[k] is None or t[k] is None \
                        else tot[k] + n * t[k]
                tot["bytes"] += n * moved
                tot["main_bytes"] += n * main_moved
                tot["ops"] += n * ops
                tot["launches"] += n
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"])
        tot["main_bound_ms"], _ = bound(tot.pop("main_bytes"), tot["ops"])
        per_model[name] = tot
    # the wrap case: acc_init within 2^16 of +-2^31 wraps on the add
    M, K, N = LM_SEQ, 2048, 2048
    a, b = i8(M, K), i8(K, N)
    near = i32(M, N, lo=0, hi=1 << 16)
    wrap = torch.where(near % 2 == 0, (2 ** 31 - 1) - near, -2 ** 31 + near)
    c, e = matmul_cases(f"wrap M={M} K={K} N={N}", a, b, dict(
        full=wrap, bias=wrap[:1].expand(M, N)), "wgmma")
    wrapped = int(((matmul_int8_ref(a, b).to(torch.int64) +
                    wrap.to(torch.int64)) !=
                   matmul_int8_ref(a, b, wrap).to(torch.int64)).sum())
    check(wrapped > 0, "the wrap case did not wrap")
    cases, err = cases + c, max(err, e)
    ragged = []
    for M, K, N in ((1000, 2048, 200), (77, 30, 18), (129, 4096, 16)):
        a, b = i8(M, K), i8(K, N)
        path = matmul_path(M, N, K)
        c, e = matmul_cases(f"ragged M={M} K={K} N={N}", a, b, dict(
            full=i32(M, N), bias=i32(1, N).expand(M, N), none=None), path)
        cases, err = cases + c, max(err, e)
        ragged.append(dict(M=M, K=K, N=N, path=path,
                           tiles=list(matmul_tiles(M, N, K))))
    emit("kernel_check", name="matmul_int8", cases=cases, bitwise=True,
         wrapped_elements=wrapped, ragged=ragged,
         launches_by_path=dict(matmul_int8_op.launches_by_path),
         ptxas=ptx)
    both = {k: None if any(per_model[m][k] is None for m in LM_MODELS)
            else sum(per_model[m][k] for m in LM_MODELS)
            for k in sums + ("bytes", "ops", "main_bound_ms")}
    b_ms, b_by = bound(both.pop("bytes"), both.pop("ops"))
    rec = dict(both, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               per_model={m: {k: v for k, v in t.items()
                              if k not in ("bytes", "ops")}
                          for m, t in per_model.items()},
               per_shape={f"{r['model']} {r['roles']}": dict(
                   ms=r["ms"], main_ms=r["main_ms"], tops=r["main_tops"],
                   bound_ms=r["main_bound_ms"], library_ms=r["library_ms"],
                   tiles=r["tiles"], split_k=r["split_k"])
                   for r in shapes})
    emit("kernel", name="matmul_int8",
         per="one bucket-4 forward of each LM", **rec)
    return rec


def flash_case(rng, dev, Sq, Sk, dtype=torch.float32, heads=None,
               kv_heads=None, head_dim=None):
    """q, k, v at gemma-2b's bucket-4 shape, or with its heads, kv heads or
    head dim replaced."""
    cfg = lm_cfg("gemma-2b")
    B = LM_BUCKET
    H = heads or cfg.num_heads
    KV = kv_heads or cfg.num_kv_heads
    hd = head_dim or cfg.head_dim

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return normal(B, Sq, H, hd), normal(B, Sk, KV, hd), normal(B, Sk, KV, hd)


def flash_bytes_ops(q, k, causal):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    off = Sk - Sq
    keys = sum(min(off + r + 1, Sk) for r in range(Sq)) if causal \
        else Sq * Sk
    return nbytes(q, k, k, q), 4 * B * H * hd * keys


def ptxas_by_entry(name):
    """``{entry function: [ptxas lines]}`` from the last build log of
    kernel ``name`` (registers, shared memory, spills per instantiation)."""
    out, entry = {}, None
    for ln in _build.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
            out[entry] = []
        elif entry and ("registers" in ln or "spill" in ln or
                        "smem" in ln):
            out[entry].append(ln.strip())
    return out


# flash_attention cases: (what, Sq, Sk, causal, dtype, H, KV, hd); None
# keeps gemma-2b's value (H 8, KV 1, hd 256)
FLASH_CASES = [
    ("causal", LM_SEQ, LM_SEQ, True, torch.float32, None, None, None),
    ("non-causal", LM_SEQ, LM_SEQ, False, torch.float32, None, None, None),
    ("decode", LM_SEQ // 4, LM_SEQ, True, torch.float32, None, None, None),
    ("bf16", LM_SEQ, LM_SEQ, True, torch.bfloat16, None, None, None),
    ("KV = H", LM_SEQ, LM_SEQ, True, torch.float32, None, 8, None),
    ("KV = 2", LM_SEQ, LM_SEQ, True, torch.float32, None, 2, None),
    ("hd 64", LM_SEQ, LM_SEQ, True, torch.float32, None, None, 64),
    ("hd 128", LM_SEQ, LM_SEQ, True, torch.float32, None, None, 128),
    ("ragged Sk", 300, 500, True, torch.float32, None, None, None),
    ("ragged non-causal", 300, 500, False, torch.float32, None, 2, 128),
]


def lm_flash_phase(rng, dev):
    """flash_attention against its plain version at gemma-2b's bucket-4
    shape: causal, non-causal, decode (Sq = 128 < Sk = 512), bf16, no head
    grouping (KV = H), KV = 2, head dims 64 and 128, and Sq, Sk that are
    not tile multiples; timings, occupancy and achieved rate on the causal
    float32 case."""
    err = 0.0
    for what, Sq, Sk, causal, dtype, H, KV, hd in FLASH_CASES:
        q, k, v = flash_case(rng, dev, Sq, Sk, dtype, H, KV, hd)
        got = flash_attention_op(q, k, v, causal=causal)
        torch.cuda.synchronize()
        bq, bk = attn_tiles(Sq, Sk, q.shape[2] // k.shape[2])
        ref = flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
        tol = BF16_TOL if dtype == torch.bfloat16 else FLASH_TOL
        excess, dev_max = close_err(got, ref, tol)
        check(got.dtype == dtype and excess <= 0,
              f"flash_attention {what}: deviates {dev_max} from plain "
              f"(tolerance {tol} abs and rel)")
        if dtype == torch.float32:
            err = max(err, dev_max)
        emit("kernel_check", name="flash_attention", case=what, Sq=Sq,
             Sk=Sk, shape=list(q.shape), kv_heads=k.shape[2],
             dtype=str(dtype), max_abs_err=dev_max, tolerance=tol)
    q, k, v = flash_case(rng, dev, LM_SEQ, LM_SEQ)
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    t = dict(ms=device_ms(lambda: flash_attention_op(q, k, v), LM_REPS),
             call_ms=call_ms(lambda: flash_attention_op(q, k, v), LM_REPS),
             plain_ms=device_ms(lambda: flash_attention_plain(q, k, v),
                                LM_REPS),
             library_ms=library_ms(lambda: F.scaled_dot_product_attention(
                 qs, ks, vs, is_causal=True, enable_gqa=True), LM_REPS))
    moved, ops = flash_bytes_ops(q, k, True)
    t["bound_ms"], t["bound_by"] = bound(moved, ops, F32_FLOPS_PER_S)
    t["max_abs_err"] = err
    t["smem_bytes"] = flash_smem_bytes(q.shape[3])
    t["blocks_per_sm"] = flash_blocks_per_sm(q.shape[3])
    t["achieved_tflops"] = ops / (t["ms"] * 1e-3) / 1e12
    t["ptxas"] = ptxas_by_entry("flash_attention")
    emit("kernel", name="flash_attention", shape=list(q.shape), causal=True,
         **t)
    return t


def scan_case(rng, dev, B, S, di, N):
    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    u, dt = normal(B, S, di), softplus(normal(B, S, di))
    A = -(0.5 + torch.from_numpy(rng.random((di, N)).astype(
        np.float32)).to(dev))
    return u, dt, A, normal(B, S, N), normal(B, S, N), normal(B, di, N)


def lm_scan_phase(rng, dev):
    """selective_scan against its plain version at falcon-mamba-7b's
    bucket-4 shape from a nonzero state, and on a ragged one; timings."""
    cfg = lm_cfg("falcon-mamba-7b")
    err = 0.0
    for shape in ((LM_BUCKET, LM_SEQ, cfg.d_inner, cfg.ssm_state),
                  (3, 100, 1000, 7)):
        ops = scan_case(rng, dev, *shape)
        y, h = selective_scan_op(*ops)
        torch.cuda.synchronize()
        y_ref, h_ref = selective_scan_ref(*ops)
        for what, got, ref in (("y", y, y_ref), ("h_last", h, h_ref)):
            excess, dev_max = close_err(got, ref, SCAN_TOL)
            check(excess <= 0, f"selective_scan {shape} {what}: deviates "
                               f"{dev_max} from plain")
            err = max(err, dev_max)
        emit("kernel_check", name="selective_scan", shape=list(shape),
             max_abs_err=err, bitwise=bool(torch.equal(y, y_ref) and
                                           torch.equal(h, h_ref)),
             tolerance=SCAN_TOL)
    ops = scan_case(rng, dev, LM_BUCKET, LM_SEQ, cfg.d_inner, cfg.ssm_state)
    y, h = selective_scan_op(*ops)
    B, S, di = ops[0].shape
    N = ops[2].shape[1]
    t = dict(ms=device_ms(lambda: selective_scan_op(*ops), LM_REPS),
             call_ms=call_ms(lambda: selective_scan_op(*ops), LM_REPS),
             plain_ms=device_ms(lambda: selective_scan_ref(*ops), 2),
             library_ms=None)
    t["bound_ms"], t["bound_by"] = bound(nbytes(*ops, y, h),
                                         B * S * di * (1 + 7 * N),
                                         F32_FLOPS_PER_S)
    t["max_abs_err"] = err
    t["threads"] = scan_threads(B, di)
    t["warps_per_sm"] = t["threads"] / 32 / torch.cuda.get_device_properties(
        dev).multi_processor_count
    t["ptxas"] = ptxas_by_entry("selective_scan")
    emit("kernel", name="selective_scan", shape=[B, S, di, N], **t)
    return t


LM_KERNEL_OPS = dict(matmul_int8=matmul_int8_op,
                     flash_attention=flash_attention_op,
                     selective_scan=selective_scan_op,
                     conv2d_int8=conv2d_int8_op)


def lm_launch_plan(cfg):
    """Launches of each LM kernel per bucket run of ``cfg`` on ``cuda``."""
    plan = plan_lm(lowering.optimized_graph(cfg))
    kinds = [t.kind for t in plan.tasks]
    return dict(matmul_int8=kinds.count("matmul"),
                flash_attention=kinds.count("attention"),
                selective_scan=kinds.count("scan"), conv2d_int8=0)


def lm_task_check(cfg, params, tokens):
    """One _LMContext driven by the torch-int impls; every task replayed
    through the cuda impl on the same environment.  matmul: int32
    accumulator and int8 output bitwise; attention and scan: the float
    output within the kernel's tolerance of the plain version's, the int8
    output within one grid step.  Returns per-kind summaries."""
    plan = plan_lm(lowering.optimized_graph(cfg), params)
    packed = BK.pack_lm_weights(plan, params)
    ctx = BK.lm_context(plan, params, cfg)
    BK.embed_tokens(ctx, plan, tokens)
    summary = {}
    for t in plan.tasks:
        shadow = BK.lm_context(plan, params, cfg, packed)
        shadow.env, shadow.specs = dict(ctx.env), dict(ctx.specs)
        s = summary.setdefault(t.kind, dict(tasks=0, max_abs_err=0.0,
                                            int8_max_step=0,
                                            int8_differ_share=0.0))
        if t.kind == "matmul":
            mp, x2d, acc0, _ = BK._lm_matmul_prologue(t, ctx)
            got = matmul_int8_op(x2d, packed[t.node], acc0)
            ref = matmul_int8_ref(x2d, mp.wq, acc0)
            check(torch.equal(got, ref),
                  f"{cfg.name} {t.node}: int32 accumulator differs")
            un = requantize_shift(ref, mp.product_exp, mp.y_spec)
            share = float(((un > -128) & (un < 127)).float().mean())
            s.setdefault("unsaturated_share", {})[t.role] = min(
                share, s.get("unsaturated_share", {}).get(t.role, 1.0))
        elif t.kind == "attention":
            q, k, v = BK._lm_attn_qkv(t, ctx)
            bq, bk = attn_tiles(q.shape[1], k.shape[1])
            excess, dmax = close_err(
                flash_attention_op(q, k, v, causal=t.causal),
                flash_attention_plain(q, k, v, causal=t.causal, bq=bq,
                                      bk=bk), FLASH_TOL)
            check(excess <= 0, f"{cfg.name} {t.node}: attention deviates "
                               f"{dmax} from plain")
            s["max_abs_err"] = max(s["max_abs_err"], dmax)
        else:
            ops = BK._lm_scan_operands(t, ctx)
            excess, dmax = close_err(selective_scan_op(*ops)[0],
                                     selective_scan_ref(*ops)[0], SCAN_TOL)
            check(excess <= 0, f"{cfg.name} {t.node}: scan deviates {dmax} "
                               f"from plain")
            s["max_abs_err"] = max(s["max_abs_err"], dmax)
        get_task_impl("torch-int", t.kind)(t, ctx)
        get_task_impl("cuda", t.kind)(t, shadow)
        got, ref = shadow.env[t.output], ctx.env[t.output]
        step = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        if t.kind == "matmul":
            check(torch.equal(got, ref), f"{cfg.name} {t.node}: int8 output "
                                         f"differs from torch-int")
        check(int(step.max()) <= 1, f"{cfg.name} {t.node}: int8 output "
                                    f"{int(step.max())} steps off torch-int")
        s["tasks"] += 1
        s["int8_max_step"] = max(s["int8_max_step"], int(step.max()))
        s["int8_differ_share"] = max(s["int8_differ_share"],
                                     float((step > 0).float().mean()))
    return summary


def flip_propagation(cfg, params, tokens):
    """How far one int8 step travels: the cuda program run twice on the
    same tokens, the second time with one element of the first float
    interlude's int8 output (layer 0's attention or scan) moved by one
    grid step.  Returns the share of the final hidden state's int8 values
    that then differ, and the largest difference in steps."""
    plan = plan_lm(lowering.optimized_graph(cfg), params)
    impls = {t.node: get_task_impl("cuda", t.kind) for t in plan.tasks}
    first = next(t for t in plan.tasks if t.kind in ("attention", "scan"))
    packed = BK.pack_lm_weights(plan, params)
    hidden = []
    for flip in (False, True):
        ctx = BK.lm_context(plan, params, cfg, packed)
        BK.embed_tokens(ctx, plan, tokens)
        for t in plan.tasks:
            impls[t.node](t, ctx)
            if flip and t is first:
                out = ctx.env[t.output]
                flat = out.view(-1)
                i = int(torch.nonzero((flat > -128) & (flat < 127))[0])
                flat[i] += 1
        hidden.append(ctx.env[plan.logits_in].to(torch.int32))
    step = (hidden[0] - hidden[1]).abs()
    return float((step > 0).float().mean()), int(step.max())


def lm_serve_phase(name, seed, dev):
    """Serve ``LM_REQUESTS`` token requests of ``name`` at full width
    through ResNetEngine on ``cuda`` with a torch-int shadow; check the
    launches against the plan, every task against torch-int on the same
    inputs, and the logits against torch-int within the tolerance carried
    from the final hidden states (``lm_params.logit_tolerance``)."""
    cfg = lm_cfg(name)
    t0 = time.perf_counter()
    params = init_lm_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (LM_REQUESTS, LM_SEQ)).astype(
        np.int32)
    eng = ResNetEngine(cfg, params, batch=LM_BUCKET, backend="cuda",
                       batch_sizes=(1, LM_BUCKET), ab_backends=("torch-int",))
    reqs = [ImageRequest(rid=i, image=t) for i, t in enumerate(toks)]
    for r in reqs:
        eng.submit(r)
    built = build_served_buckets(eng, LM_REQUESTS)
    for op in LM_KERNEL_OPS.values():
        op.launches = 0
    matmul_int8_op.launches_by_path = dict.fromkeys(
        matmul_int8_op.launches_by_path, 0)
    t0 = time.perf_counter()
    ticks, ran, ran_by_path = traced_launches(eng.run)
    wall = time.perf_counter() - t0
    launches = {k: op.launches for k, op in LM_KERNEL_OPS.items()}
    by_path = dict(matmul_int8_op.launches_by_path)
    bucket_runs = dict(eng.model.run_counts)

    runs = sum(bucket_runs.values())
    per_run = lm_launch_plan(cfg)
    check(eng.served == LM_REQUESTS and all(r.done for r in reqs),
          "engine left requests unserved")
    check(runs == math.ceil(LM_REQUESTS / LM_BUCKET), f"{runs} bucket runs")
    check(launches == {k: runs * v for k, v in per_run.items()},
          f"{name}: launch counts {launches} for {runs} bucket runs of "
          f"{per_run} each")
    check(by_path == dict(wgmma=launches["matmul_int8"], mma_sync=0),
          f"{name}: matmul_int8 launches by path {by_path}: every LM "
          f"projection must take the wgmma path")
    used = [b for b, k in bucket_runs.items() if k]
    check(used == built, f"{name}: buckets {used} used, {built} built")
    check_traced(ran, launches, per_run, runs, f"{name} cuda")
    check(ran_by_path.get("matmul_int8", {}).get("mma_sync", 0) == 0,
          f"{name}: the profiler saw matmul launches {ran_by_path} off the "
          f"wgmma path")
    check_graphs(eng.model, used, f"{name} cuda")
    check_graphs(eng.shadows["torch-int"], used, f"{name} torch-int shadow")

    x = torch.as_tensor(toks, device=dev)
    tasks = lm_task_check(cfg, eng.model.params, x[:LM_BUCKET])
    flip_share, flip_step = flip_propagation(cfg, eng.model.params,
                                             x[:LM_BUCKET])

    m, shadow = eng.model, eng.shadows["torch-int"]
    feats_fn = m.backend.features(m.graph, cfg, m.params)
    ref_fn = shadow.backend.features(shadow.graph, cfg, shadow.params)
    spec = hidden_out_spec(m.params)
    logits = torch.from_numpy(np.stack([r.logits for r in reqs]))
    ref_logits = []
    differ, max_step, n_el, excess = 0, 0, 0, -math.inf
    for i in range(0, LM_REQUESTS, LM_BUCKET):
        batch = m.pad(x[i:i + LM_BUCKET])
        n = min(LM_BUCKET, LM_REQUESTS - i)
        h, h_ref = feats_fn(batch)[:n], ref_fn(batch)[:n]
        step = (h.to(torch.int32) - h_ref.to(torch.int32)).abs()
        differ += int((step > 0).sum())
        max_step = max(max_step, int(step.max()))
        n_el += step.numel()
        tol = logit_tolerance(h, h_ref, spec, m.params.unembed).cpu()
        check(torch.equal(logits[i:i + n], m._forward(batch)[:n].cpu()),
              f"{name}: served logits of the bucket-{batch.shape[0]} run "
              f"differ from the eager lowered forward")
        got = logits[i:i + n].double()
        # the shadow's unembed of its own hidden state, as lower_lm does
        ref = (dequantize(h_ref, spec)[:, -1, :] @ m.params.unembed).cpu()
        ref_logits.append(ref)
        excess = max(excess, float(((got - ref.double()).abs() - tol).max()))
    ref_logits = torch.cat(ref_logits)
    check(bool(torch.isfinite(logits).all()), "logits not finite")
    check(excess <= 0, f"{name}: logits exceed the tolerance carried from "
                       f"the hidden states by {excess}")
    argmax_equal = int((logits.argmax(-1) == ref_logits.argmax(-1)).sum())

    trace_counts = dict(m.trace_counts)
    xb = x[:LM_BUCKET]
    check_replays(m, xb, xb.flip(0), f"{name} cuda")
    times = served_times(m, xb, 3)
    tokens = LM_BUCKET * LM_SEQ
    summary = dict(
        bucket4_served_ms=times["served_ms"],
        bucket4_graph_ms=times["graph_ms"],
        bucket4_eager_ms=times["eager_ms"],
        served_idle_share=times["served_idle_share"],
        eager_idle_share=times["eager_idle_share"],
        tokens_per_s_bucket4=tokens / (times["served_ms"] * 1e-3),
        tokens_per_s_bucket4_graph=tokens / (times["graph_ms"] * 1e-3),
        tokens_per_s_bucket4_eager=tokens / (times["eager_ms"] * 1e-3))
    emit("lm_serve", model=name, layers=cfg.num_layers, seq_len=LM_SEQ,
         d_model=cfg.d_model, requests=LM_REQUESTS, ticks=ticks,
         bucket_runs=bucket_runs, trace_counts=trace_counts,
         launches=launches,
         matmul_launches_by_path=by_path, launches_per_run=per_run,
         traced_launches=ran, init_s=init_s, traced_serve_wall_s=wall,
         tasks=tasks, hidden_differ_share=differ / n_el,
         hidden_max_step=max_step, one_step_flip_differ_share=flip_share,
         one_step_flip_max_step=flip_step,
         logit_excess_over_tolerance=excess,
         max_abs_logit_dev=float((logits - ref_logits).abs().max()),
         ab_max_abs_dev=max(eng.ab_stats["torch-int"]),
         argmax_equal=f"{argmax_equal}/{LM_REQUESTS}", **summary)
    return eng, dict(launches, matmul_int8_by_path=by_path), summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and inputs")
    args = ap.parse_args(argv)
    # the train phase's resume check runs cuBLAS in deterministic mode,
    # which needs this set before the first cuBLAS call (32 MiB of
    # workspace, the size PyTorch picks on Hopper anyway)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    device_phase()
    dev = torch.device("cuda")
    # full float32 in every reference product (the unembed, the float
    # plain versions); cuDNN's TF32 default would round the conv references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("numerics", cuda_matmul_allow_tf32=torch.backends.cuda.matmul
         .allow_tf32, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    sass = build_phase()
    rng = np.random.default_rng(args.seed)
    stem, block = kernels_phase(rng, dev)
    chain = chain_phase(rng, dev)
    eng20, launches, serve20 = serve_phase(R.RESNET20, args.seed, dev,
                                           "cuda")
    eng8, launches8, serve8 = serve_phase(R.RESNET8, args.seed, dev, "cuda")
    eng20s, launches_s, serve20s = serve_phase(R.RESNET20, args.seed, dev,
                                               "cuda-stream")
    eng8s, launches8s, serve8s = serve_phase(R.RESNET8, args.seed, dev,
                                             "cuda-stream")
    eager = eager_compare_phase({"resnet20": (eng20, eng20s),
                                 "resnet8": (eng8, eng8s)}, dev)
    x = torch.zeros((BUCKET, 32, 32, 3), device=dev)
    profile_phase(eng20, dev, "cuda", x, 5)
    profile_phase(eng20s, dev, "cuda-stream", x, 5)
    del eng20, eng20s, eng8, eng8s
    torch.cuda.empty_cache()
    sharded = {b: sharded_serve_phase(R.RESNET20, args.seed, b)
               for b in ("cuda", "cuda-stream")}
    torch.cuda.empty_cache()
    traffic = traffic_phase(args.seed, dev, [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    cache_dir = tempfile.mkdtemp(prefix="repro-tune-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(cache_dir, "tune.json")
    try:
        tuned = {b: tune_phase(args.seed, dev, b, rng)
                 for b in ("cuda", "cuda-stream")}
    finally:
        os.environ.pop("REPRO_TUNE_CACHE")
        shutil.rmtree(cache_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    task_profile = task_profile_phase(args.seed, dev, block, chain)
    train = train_phase(args.seed, dev)
    torch.cuda.empty_cache()

    conv = conv2d_phase(rng, dev)
    mm = lm_matmul_phase(rng, dev)
    flash = lm_flash_phase(rng, dev)
    scan = lm_scan_phase(rng, dev)
    lm_serve, lm_launches = {}, {}
    for name in LM_MODELS:
        eng, lm_launches[name], lm_serve[name] = lm_serve_phase(
            name, args.seed, dev)
        profile_phase(eng, dev, "cuda", torch.zeros(
            (LM_BUCKET, LM_SEQ), dtype=torch.int32, device=dev), 1)
        del eng
        torch.cuda.empty_cache()

    conv_launches = sum(d["conv2d_int8"] for d in (
        launches, launches_s, launches8, launches8s, *lm_launches.values()))
    src = "src/repro_torch/kernels/csrc/"
    rows = [
        dict(name="conv_stem", route="cuda", source=src + "conv_stem.cu",
             replaces="src/repro/kernels/conv_stem/conv_stem.py:49",
             launches=launches["conv_stem"],
             launches_train_eval=train["eval_launches"]["conv_stem"],
             launches_traffic=traffic["launches"]["conv_stem"],
             launches_by_path=serve20["launches_by_path"]["conv_stem"],
             bitwise=True, library_ms=None, sass=sass["conv_stem"],
             ptxas=ptxas_by_entry("conv_stem"),
             tuned=dict(knob="band_rows",
                        **tuned["cuda"]["kernels"]["conv_stem"]),
             per="one launch at batch 32", **stem),
        dict(name="resblock_fused", route="cuda",
             source=src + "resblock_fused.cu",
             replaces="src/repro/kernels/resblock_fused/"
                      "resblock_fused.py:120",
             launches=launches["resblock_fused"],
             launches_train_eval=train["eval_launches"]["resblock_fused"],
             launches_traffic=traffic["launches"]["resblock_fused"],
             bitwise=True,
             library_ms=None, sass=sass["resblock_fused"],
             tuned=dict(knob="band_rows",
                        **tuned["cuda"]["kernels"]["resblock_fused"]),
             per="the 9 launches of one ResNet20 forward at batch 32",
             **block),
        dict(name="block_chain", route="cuda", source=src + "block_chain.cu",
             replaces="src/repro/kernels/megakernel/megakernel.py:203",
             launches=launches_s["block_chain"],
             launches_train_eval=train["eval_launches"]["block_chain"],
             launches_traffic=traffic["launches"]["block_chain"],
             bitwise=True,
             library_ms=None, sass=sass["block_chain"],
             tuned=dict(knob="(batch_tile, split)",
                        **tuned["cuda-stream"]["kernels"]["block_chain"]),
             per="the one launch of a cuda-stream ResNet20 forward at "
                 "batch 32", **chain),
        dict(name="matmul_int8", route="cuda", source=src + "matmul_int8.cu",
             replaces="src/repro/kernels/matmul_int8/matmul_int8.py:43",
             launches=sum(v["matmul_int8"] for v in lm_launches.values()),
             launches_by_model={k: v["matmul_int8"]
                                for k, v in lm_launches.items()},
             launches_by_path={p: sum(v["matmul_int8_by_path"][p]
                                      for v in lm_launches.values())
                               for p in ("wgmma", "mma_sync")},
             bitwise=True,
             per="the 108 launches of one gemma-2b and the 384 of one "
                 "falcon-mamba-7b forward at bucket 4 (S = 512)", **mm),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:62",
             launches=lm_launches["gemma-2b"]["flash_attention"],
             bitwise=False, tolerance=FLASH_TOL,
             per="one launch at gemma-2b's bucket-4 shape, causal", **flash),
        dict(name="selective_scan", route="cuda",
             source=src + "selective_scan.cu",
             replaces="src/repro/kernels/selective_scan/"
                      "selective_scan.py:47",
             launches=lm_launches["falcon-mamba-7b"]["selective_scan"],
             bitwise=False, tolerance=SCAN_TOL,
             per="one launch at falcon-mamba-7b's bucket-4 shape",
             library_reason="no PyTorch call computes the selective scan",
             **scan),
        dict(name="conv2d_int8", route="cuda", source=src + "conv2d_int8.cu",
             replaces="src/repro/kernels/conv2d_int8/conv2d_int8.py:57",
             launches=conv_launches,
             launches_by_path={p: sum(d["launches_by_path"]["conv2d_int8"][p]
                                      for d in (serve20, serve8, serve20s,
                                                serve8s))
                               for p in conv2d_int8_op.launches_by_path},
             bitwise=True, library_ms=None, sass=sass["conv2d_int8"],
             ptxas=ptxas_by_entry("conv2d_int8"),
             library_reason="none: F.conv2d refuses int8 on CUDA, and a "
                            "float conv has no integer epilogue",
             per="off the serving path (0 launches on it); timed on "
                 "ResNet20's 20 conv layers at batch 32, s8 input, one "
                 "launch each", **conv),
    ]
    # the serve summary rides on the kernels line so that it survives in
    # any tail of the output that keeps the last lines
    print(json.dumps({"kernels": rows, "serve": {
        "resnet20": serve20, "resnet8": serve8,
        "resnet20_stream": serve20s, "resnet8_stream": serve8s,
        "eager_in_turns": eager, "task_profile": task_profile,
        "sharded": {b: {k: v[k] for k in (
            "replicas", "images_per_s", "queue_wait_ms", "compute_ms",
            "deadlines_met", "deadlines_total", "bucket_runs_timed",
            "paced", "bitwise_with_resnet_engine")}
            for b, v in sharded.items()},
        "tuned": {b: {k: v[k] for k in (
            "chosen", "images_per_s_tuned", "images_per_s_default",
            "served_us_tuned", "served_us_default", "timings_us")}
                  for b, v in tuned.items()},
        **lm_serve}, "train": train, "traffic": traffic_line(traffic),
        "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
