"""Serving launcher: compiled ResNet image serving on the GPU.

The port's copy of the ResNet part of ``repro.launch.serve``.  The
optimized graph is lowered once per batch bucket and served by
``ResNetEngine``, one CUDA graph a bucket:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet8 \
        --backend cuda --requests 64 --batch 8 --buckets 1,8

Scale-out serving (replica pool + deadline-based batch coalescing; one
model replica per device, least-loaded dispatch, p50/p99 latency split):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet20 \
        --replicas 1 --deadline-ms 5

Weights are random from seed 0, the request images from ``--seed``.
``--device cpu`` runs the kernels' plain versions on the CPU (a pool of
``--replicas`` CPU replicas).  The LM workload and the trace-driven SLO
path of the reference are not ported here yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

RESNET_ARCHS = ("resnet8", "resnet20")


def _print_tuning(tuning) -> None:
    if tuning:
        print(f"  tuned: {({t: c.to_dict() for t, c in tuning.items()})}")


def serve_resnet_sharded(args, cfg, qp, buckets):
    """Replica-pool serving: one compiled replica per device, deadline-based
    coalescing, least-loaded dispatch."""
    from repro_torch.serve.engine import ImageRequest, ShardedResNetEngine

    if args.ab:
        raise SystemExit(
            "--ab shadow backends are not supported with --replicas; run "
            "the A/B probe on the single-device engine (drop --replicas)")
    devices = None if args.device == "cuda" else \
        [args.device] * args.replicas
    eng = ShardedResNetEngine(
        cfg, qp, batch=args.batch, backend=args.backend,
        replicas=args.replicas, devices=devices, batch_sizes=buckets,
        slack_ms=args.slack_ms, tune=args.tune or None)
    _print_tuning(eng.tuning)
    eng.pool.warmup()                 # serve-only timings below
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        eng.submit(ImageRequest(
            rid=i, image=rng.random((cfg.img, cfg.img, 3), np.float32)),
            deadline_ms=args.deadline_ms or None)
    ticks = eng.run()
    dt = time.time() - t0
    st = eng.latency_stats()
    print(f"served {eng.served} images in {ticks} ticks, {dt:.2f}s "
          f"({eng.served / dt:.1f} img/s) via backend={args.backend!r} "
          f"x{len(eng.pool)} replicas")
    print(f"  queue wait ms p50/p99: {st['queue_wait_ms']['p50']:.2f}/"
          f"{st['queue_wait_ms']['p99']:.2f}   compute ms p50/p99: "
          f"{st['compute_ms']['p50']:.2f}/{st['compute_ms']['p99']:.2f}")
    print(f"  deadlines: {st['deadline_total'] - st['deadline_misses']}/"
          f"{st['deadline_total']} met; per-replica served: "
          f"{[r['served'] for r in st['replicas']]}")
    return eng


def _serve_resnet_single(args, cfg, qp, buckets):
    from repro_torch.serve.engine import ImageRequest, ResNetEngine

    eng = ResNetEngine(cfg, qp, batch=args.batch, backend=args.backend,
                       batch_sizes=buckets,
                       ab_backends=tuple(b for b in args.ab.split(",") if b),
                       device=args.device, tune=args.tune or None)
    _print_tuning(eng.tuning)
    # build every bucket of the primary and the A/B shadows so the timing
    # below is serve-only
    eng.model.warmup()
    for shadow in eng.shadows.values():
        shadow.warmup()
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(ImageRequest(
            rid=i, image=rng.random((cfg.img, cfg.img, 3), np.float32)))
    t0 = time.time()
    ticks = eng.run()
    dt = time.time() - t0
    print(f"served {eng.served} images in {ticks} ticks, {dt:.2f}s "
          f"({eng.served / dt:.1f} img/s) via backend={args.backend!r}")
    print(f"  compiled: {eng.model.stats()}")
    for name, devs in eng.ab_stats.items():
        print(f"  A/B vs {name}: max|dlogit| = {max(devs):.3g} "
              f"over {len(devs)} ticks")
    return eng


def serve_resnet(args):
    from repro_torch.models import resnet as R

    cfg = {"resnet8": R.RESNET8, "resnet20": R.RESNET20}[args.arch]
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(0))), cfg)
    buckets = tuple(int(b) for b in args.buckets.split(",")) \
        if args.buckets else (args.batch,)
    if args.replicas:
        return serve_resnet_sharded(args, cfg, qp, buckets)
    return _serve_resnet_single(args, cfg, qp, buckets)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=RESNET_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="max images per tick")
    ap.add_argument("--buckets", default="",
                    help="comma-separated compiled batch buckets (default: "
                         "just --batch)")
    ap.add_argument("--backend", default="cuda",
                    help="a repro_torch.compile registered backend")
    ap.add_argument("--ab", default="",
                    help="comma-separated shadow backends to A/B")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a replica pool of this many devices "
                         "(0 = single-device ResNetEngine)")
    ap.add_argument("--slack-ms", type=float, default=5.0,
                    help="batch-coalescing window — how long a micro-batch "
                         "may be held open waiting to fill (larger = "
                         "better throughput, worse p99 wait)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request completion deadline (0 = best-effort "
                         "under --slack-ms only)")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for the synthetic request images")
    ap.add_argument("--tune", default="",
                    choices=("", "auto", "analytic", "device"),
                    help="kernel autotuning — 'auto' serves from the "
                         "REPRO_TUNE_CACHE config cache (searching on "
                         "miss), 'analytic' is cost-model-only, 'device' "
                         "forces a fresh two-stage search")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    return serve_resnet(args)


if __name__ == "__main__":
    main()
