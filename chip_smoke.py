#!/usr/bin/env python3
"""GPU smoke test of ``repro_torch``, the PyTorch/CUDA port.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each:

  1. device   — requires a CUDA GPU (exits 2 without one); prints the card's
                name and power limit as nvidia-smi reports them.
  2. build    — compiles the kernels from ``src/repro_torch/kernels/csrc``.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, bitwise (``torch.equal``): conv_stem at N=256 and
                N=32 for shifts > 0, = 0, < 0; resblock_fused at every
                ResNet20 block shape for skip shifts > 0, = 0, < 0; in
                every case at least a fifth of the outputs lie strictly
                inside (0, 255).  Device time (``ms``, CUDA-graph replay),
                eager call time with host launch overhead (``call_ms``), the
                plain version's device time and the roofline bound, at the
                main path's shapes (batch 32).
  4. serve    — full-width ResNet20 and ResNet8 from the port's own
                ``init_params(seed) -> fold_params -> quantize_params``,
                requests served through ``ResNetEngine(backend="cuda")``
                with buckets (1, 8, 32); the u8 maps of the served model's
                padded bucket batches bitwise equal to the ``torch-int``
                backend's, logits within 1e-5; launch counters show the
                kernels ran; images per second at bucket 32, eager and
                as a CUDA-graph replay (the device time alone).
  5. the ``{"kernels": [...], "serve": {...}}`` line, then
     ``{"ok": true, "device": ...}``.

A ``torch.profiler`` breakdown of five ResNet20 bucket-32 forwards closes
phase 4.  Any failure raises, and the script exits non-zero without the
last line.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.compile import lower_forward  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv_stem.ops import conv_stem_op  # noqa: E402
from repro_torch.kernels.conv_stem.ref import conv_stem_ref  # noqa: E402
from repro_torch.kernels.resblock_fused.ops import (  # noqa: E402
    resblock_fused_op, smem_bytes)
from repro_torch.kernels.resblock_fused.ref import resblock_ref  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.serve import ImageRequest, ResNetEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
LOGIT_ATOL = 1e-5
MIN_UNSATURATED = 0.2    # share of kernel outputs strictly inside (0, 255)
BUCKET = 32
REQUESTS = 37     # one full bucket of 32, then 5 padded up to bucket 8
REPS = 50         # timed calls per measurement
# ResNet20's residual block shapes (H, Cin, Cout, stride) and how many of
# each one forward runs
RESNET20_BLOCKS = [((32, 16, 16, 1), 3), ((32, 16, 32, 2), 1),
                   ((16, 32, 32, 1), 2), ((16, 32, 64, 2), 1),
                   ((8, 64, 64, 1), 2)]


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def device_ms(fn, reps):
    """Device time of one call: ``reps`` calls captured into one CUDA graph,
    the graph replayed five times, the median replay over ``reps``.  Host
    launch overhead is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def bound(bytes_moved, ops):
    """Least time in ms the card could take: bytes over HBM bandwidth vs
    int8 operations over the tensor-core peak, the larger of the two."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
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
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_kernel=secs, ptxas=ptxas)


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


def kernels_phase(rng, dev):
    """Bitwise kernel-vs-plain checks and timings; returns the per-forward
    kernel records (ResNet20, bucket 32) with each kernel's largest
    deviation from its plain version."""
    err = dict(conv_stem=0, resblock_fused=0)
    for n in (256, BUCKET):
        ops = stem_case(rng, dev, n)
        small = stem_case(rng, dev, n, small=True)
        for shift in (9, 0, -1):
            case = ops if shift > 0 else small
            got = conv_stem_op(*case, shift=shift)
            torch.cuda.synchronize()
            ref = conv_stem_ref(*case, shift=shift)
            err["conv_stem"] = max(err["conv_stem"], max_abs_err(got, ref))
            check(torch.equal(got, ref),
                  f"conv_stem N={n} shift={shift} differs from plain")
            check_unsaturated(got, f"conv_stem N={n} shift={shift}")
        out = conv_stem_op(*ops, shift=9)
        t = dict(ms=device_ms(lambda: conv_stem_op(*ops, shift=9), REPS),
                 call_ms=call_ms(lambda: conv_stem_op(*ops, shift=9), REPS),
                 plain_ms=device_ms(lambda: conv_stem_ref(*ops, shift=9),
                                    REPS))
        t["bound_ms"], t["bound_by"] = bound(nbytes(*ops, out),
                                             2 * out.numel() * 27)
        emit("kernel", name="conv_stem", n=n, bitwise=True, **t)
        if n == BUCKET:
            stem = dict(t, max_abs_err=err["conv_stem"])

    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    for (h, cin, cout, stride), count in RESNET20_BLOCKS:
        ops = block_case(rng, dev, BUCKET, h, cin, cout, stride)
        for skip_shift in (3, 0, -2):
            kw = dict(stride=stride, shift0=11, shift1=12,
                      skip_shift=skip_shift)
            got = resblock_fused_op(*ops, **kw)
            torch.cuda.synchronize()
            ref = resblock_ref(*ops, **kw)
            err["resblock_fused"] = max(err["resblock_fused"],
                                        max_abs_err(got, ref))
            check(torch.equal(got, ref),
                  f"resblock_fused {h}x{h} {cin}->{cout} s{stride} "
                  f"skip_shift={skip_shift} differs from plain")
            check_unsaturated(got, f"resblock_fused {h}x{h} {cin}->{cout} "
                                   f"skip_shift={skip_shift}")
        kw = dict(stride=stride, shift0=11, shift1=12, skip_shift=-2)
        out = resblock_fused_op(*ops, **kw)
        t = dict(ms=device_ms(lambda: resblock_fused_op(*ops, **kw), REPS),
                 call_ms=call_ms(lambda: resblock_fused_op(*ops, **kw), REPS),
                 plain_ms=device_ms(lambda: resblock_ref(*ops, **kw), REPS))
        oh = h // stride
        macs = BUCKET * oh * oh * cout * (9 * cin + 9 * cout +
                                         (cin if stride == 2 else 0))
        t["bound_ms"], t["bound_by"] = bound(nbytes(*ops, out), 2 * macs)
        emit("kernel", name="resblock_fused", n=BUCKET, h=h, cin=cin,
             cout=cout, stride=stride, launches_per_forward=count,
             smem_bytes=smem_bytes(h, h, cin, cout, stride, stride == 2),
             bitwise=True, macs_per_image=macs // BUCKET, **t)
        for k in ("ms", "call_ms", "plain_ms"):
            tot[k] += count * t[k]
        tot["bytes"] += count * nbytes(*ops, out)
        tot["ops"] += count * 2 * macs
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    block = dict(ms=tot["ms"], call_ms=tot["call_ms"],
                 plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                 max_abs_err=err["resblock_fused"])
    emit("kernel", name="resblock_fused", n=BUCKET,
         per="ResNet20 forward (9 launches)", **block)
    return stem, block


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


def serve_phase(cfg, seed, dev):
    """Serve ``REQUESTS`` images through the engine; returns the engine and
    the launch counts of that run."""
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(seed))), cfg)
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.0, 0.999, (REQUESTS, 32, 32, 3)).astype(
        np.float32)
    eng = ResNetEngine(cfg, qp, batch=BUCKET, backend="cuda",
                       batch_sizes=(1, 8, BUCKET), ab_backends=("torch-int",))
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    for r in reqs:
        eng.submit(r)

    conv_stem_op.launches = resblock_fused_op.launches = 0
    t0 = time.perf_counter()
    ticks = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(conv_stem=conv_stem_op.launches,
                    resblock_fused=resblock_fused_op.launches)

    runs = sum(eng.model.run_counts.values())
    n_blocks = len(R.block_strides(cfg))
    check(eng.served == REQUESTS and all(r.done for r in reqs),
          "engine left requests unserved")
    check(runs == math.ceil(REQUESTS / BUCKET), f"{runs} bucket runs")
    check(launches == dict(conv_stem=runs, resblock_fused=runs * n_blocks),
          f"launch counts {launches} for {runs} bucket runs")

    # the served model's u8 maps on the padded batches of its own bucket
    # runs (32, then 5 padded to 8), bitwise against the torch-int shadow's
    m, shadow = eng.model, eng.shadows["torch-int"]
    feats_fn = m.backend.features(m.graph, cfg, m.params)
    ref_fn = shadow.backend.features(shadow.graph, cfg, shadow.params)
    x = torch.as_tensor(imgs, device=dev)
    feats = []
    for i in range(0, REQUESTS, BUCKET):
        batch = m.pad(x[i:i + BUCKET])
        got, ref = feats_fn(batch), ref_fn(batch)
        check(torch.equal(got, ref),
              f"u8 feature map of the bucket-{batch.shape[0]} run differs "
              f"from torch-int")
        feats.append(got[:min(BUCKET, REQUESTS - i)])
    feats = torch.cat(feats)
    check(bool(feats.any()), "u8 feature map is all zero")
    logits = torch.from_numpy(np.stack([r.logits for r in reqs]))
    ref_logits = lower_forward(cfg, qp, "torch-int")(imgs).cpu()
    dev_max = float((logits - ref_logits).abs().max())
    check(torch.isfinite(logits).all() and dev_max <= LOGIT_ATOL,
          f"logits deviate {dev_max} from torch-int")
    check(torch.equal(logits.argmax(-1), ref_logits.argmax(-1)),
          "argmax differs from torch-int")
    check(max(eng.ab_stats["torch-int"]) <= LOGIT_ATOL, "A/B shadow")

    bucket_runs = dict(eng.model.run_counts)
    x = x[:BUCKET]
    eager = call_ms(lambda: eng.model(x), REPS)
    graphed = device_ms(lambda: eng.model(x), REPS)
    summary = dict(bucket32_forward_ms=eager,
                   bucket32_forward_device_ms=graphed,
                   device_idle_share=1.0 - graphed / eager,
                   images_per_s_bucket32=BUCKET / (eager * 1e-3),
                   images_per_s_bucket32_graphed=BUCKET / (graphed * 1e-3))
    emit("serve", model=cfg.name, requests=REQUESTS, ticks=ticks,
         bucket_runs=bucket_runs, launches=launches,
         serve_wall_s=wall, u8_bitwise=True, max_abs_logit_dev=dev_max,
         ab_max_abs_dev=max(eng.ab_stats["torch-int"]),
         feature_nonzero_share=float((feats > 0).float().mean()),
         macs_per_image=macs_per_image(cfg), **summary)
    return eng, launches, summary


def profile_phase(eng, dev):
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros((BUCKET, 32, 32, 3), device=dev)
    eng.model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eng.model(x)
        torch.cuda.synchronize()
    def device_us(e):
        return getattr(e, "self_device_time_total", 0)

    rows = sorted(prof.key_averages(), key=lambda e: -device_us(e))
    emit("profile", model=eng.cfg.name, forwards=5,
         top=[dict(name=e.key[:60], count=e.count, device_us=device_us(e))
              for e in rows[:12]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and inputs")
    args = ap.parse_args(argv)

    device_phase()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    stem, block = kernels_phase(np.random.default_rng(args.seed), dev)
    eng20, launches, serve20 = serve_phase(R.RESNET20, args.seed, dev)
    serve8 = serve_phase(R.RESNET8, args.seed, dev)[2]
    profile_phase(eng20, dev)

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        dict(name="conv_stem", route="cuda", source=src + "conv_stem.cu",
             replaces="src/repro/kernels/conv_stem/conv_stem.py:49",
             launches=launches["conv_stem"], bitwise=True, library_ms=None,
             per="one launch at batch 32", **stem),
        dict(name="resblock_fused", route="cuda",
             source=src + "resblock_fused.cu",
             replaces="src/repro/kernels/resblock_fused/"
                      "resblock_fused.py:120",
             launches=launches["resblock_fused"], bitwise=True,
             library_ms=None,
             per="the 9 launches of one ResNet20 forward at batch 32",
             **block),
    ]
    # the serve summary rides on the kernels line so that it survives in
    # any tail of the output that keeps the last lines
    print(json.dumps({"kernels": rows, "serve": {
        "resnet20": serve20, "resnet8": serve8}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
