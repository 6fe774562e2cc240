"""Serving launcher: LM continuous batching or compiled ResNet image
serving, on the GPU (the port of ``repro.launch.serve``).

LM workload (the float LMs through the continuous-batching ``Engine``,
every architecture of ``configs.ARCH_IDS``; ``--smoke`` serves the smoke
config, ``--device cpu`` serves on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --smoke --requests 8 --max-new 16

Image-classification workload: the optimized graph is lowered once per
batch bucket and served by ``ResNetEngine``, one CUDA graph a bucket:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet8 \
        --backend cuda --requests 64 --batch 8 --buckets 1,8

Scale-out serving (replica pool + deadline-based batch coalescing; one
model replica per device, least-loaded dispatch, p50/p99 latency split):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet20 \
        --replicas 1 --deadline-ms 5

Trace-driven SLO serving (``repro_torch.traffic``: arrivals from a JSON
trace or a seeded Poisson process, per-class deadlines/priorities/
policies, optional autoscaling and accuracy-aware degradation to a cheaper
variant, health alerts and debug bundles):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet20 \
        --trace results/trace.json --slo-classes \
        "interactive:25:0:strict,standard:50:1:degrade" \
        --autoscale --replicas 1 --degrade-arch resnet8 \
        --alerts --bundle-dir results/bundles --metrics-out results/m.txt

Weights are random from seed 0 (the degrade variant's from ``--seed +
1``), the request images from ``--seed``.  ``--device cpu`` runs the
kernels' plain versions on the CPU (a pool of ``--replicas`` CPU
replicas).  The LM prompts are the reference's: request ``i`` is ``[1 + i
% 7, 2, 3 + i % 5]``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import ARCH_IDS

RESNET_ARCHS = ("resnet8", "resnet20")


def serve_lm(args):
    """Serve ``--requests`` prompts through ``Engine``; returns the
    requests, ticks, tokens and seconds."""
    import torch

    from repro_torch.compile.compiler import resolve_device
    from repro_torch.configs import base as cbase
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, Request

    dev = resolve_device(args.device)
    cfg = (cbase.get_smoke_config(args.arch) if args.smoke
           else cbase.get_config(args.arch))
    params = M.init_params(cfg, 0, dev)
    eng = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                 device=dev)
    reqs = [Request(rid=i, prompt=[1 + i % 7, 2, 3 + i % 5],
                    max_new=args.max_new) for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    ticks = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {tokens} tokens in {ticks} ticks, "
          f"{dt:.2f}s ({tokens/dt:.1f} tok/s) on {dev}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out[:10]}")
    return dict(requests=reqs, ticks=ticks, tokens=tokens, seconds=dt)


def _print_tuning(tuning) -> None:
    if tuning:
        print(f"  tuned: {({t: c.to_dict() for t, c in tuning.items()})}")


def serve_resnet_sharded(args, cfg, qp, buckets):
    """Replica-pool serving: one compiled replica per device, deadline-based
    coalescing, least-loaded dispatch."""
    from repro_torch.serve.engine import ImageRequest, ShardedResNetEngine
    from repro_torch.traffic.wiring import pool_devices

    if args.ab:
        raise SystemExit(
            "--ab shadow backends are not supported with --replicas; run "
            "the A/B probe on the single-device engine (drop --replicas)")
    eng = ShardedResNetEngine(
        cfg, qp, batch=args.batch, backend=args.backend,
        replicas=args.replicas,
        devices=pool_devices(args.device, args.replicas), batch_sizes=buckets,
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


def _make_launch_health(args, classes=None):
    """HealthMonitor on the active obs session when --alerts/--bundle-dir/
    --health-actuate is set (observe-only unless --health-actuate)."""
    if not (args.alerts or args.bundle_dir or args.health_actuate):
        return None
    from repro_torch.traffic.wiring import make_health

    return make_health(classes, bundle_dir=args.bundle_dir, arch=args.arch,
                       backend=args.backend, batch=args.batch,
                       seed=args.seed)


def serve_resnet_traffic(args, cfg, qp, buckets):
    """Trace-driven SLO serving via ``repro_torch.traffic``: the live runner
    over ``ShardedResNetEngine`` replicas, with per-class deadline
    accounting, optional autoscaling, and overload degradation to
    ``--degrade-arch``."""
    from repro_torch.serve.engine import ShardedResNetEngine
    from repro_torch.traffic import (
        Autoscaler, AutoscaleConfig, LiveTrafficRunner, OverloadRouter,
        PoissonProcess, TraceReplay, parse_classes)
    from repro_torch.traffic.wiring import (pool_devices, pool_size,
                                            print_report, quantized)

    classes = parse_classes(args.slo_classes)
    if args.trace:
        arrivals = TraceReplay.from_file(args.trace).generate(
            n=args.requests or None)
    else:
        arrivals = PoissonProcess(
            args.arrival_rate, seed=args.seed,
            class_mix={c.name: 1.0 for c in classes}).generate(
                n=args.requests)
    replicas = pool_size(args.device, args.replicas)
    variants = {args.arch: ShardedResNetEngine(
        cfg, qp, batch=args.batch, backend=args.backend, replicas=replicas,
        devices=pool_devices(args.device, replicas), batch_sizes=buckets,
        slack_ms=args.slack_ms, tune=args.tune or None)}
    if args.degrade_arch:
        dcfg, dqp = quantized(args.degrade_arch, args.seed + 1)
        variants[args.degrade_arch] = ShardedResNetEngine(
            dcfg, dqp, batch=args.batch,
            backend=args.backend, replicas=1,
            devices=pool_devices(args.device, 1), slack_ms=args.slack_ms)
    for eng in variants.values():
        eng.pool.warmup()
    health = _make_launch_health(args, classes)
    actuating = health if args.health_actuate else None
    autoscaler = None
    if args.autoscale:
        autoscaler = Autoscaler(
            AutoscaleConfig(min_replicas=1, max_replicas=replicas),
            clock=variants[args.arch].clock, health=actuating)
        variants[args.arch].set_active_replicas(autoscaler.active)
    router = OverloadRouter(classes, primary=args.arch,
                            degraded=args.degrade_arch or None,
                            health=actuating)
    rng = np.random.default_rng(args.seed)
    images = rng.random((64, cfg.img, cfg.img, 3)).astype(np.float32)
    runner = LiveTrafficRunner(variants, classes, router,
                               autoscaler=autoscaler, health=health)
    report = runner.run(arrivals, images)
    print(f"served trace of {len(arrivals)} arrivals through "
          f"{list(variants)} (replicas={replicas}, "
          f"autoscale={'on' if autoscaler else 'off'})")
    print_report(report)
    return report


def serve_resnet(args):
    """Serve ``--arch``; returns the engine, or the traffic report on the
    SLO path (``--trace``, ``--slo-classes`` or ``--autoscale``)."""
    from repro_torch.traffic.wiring import quantized

    cfg, qp = quantized(args.arch, 0)
    buckets = tuple(int(b) for b in args.buckets.split(",")) \
        if args.buckets else (args.batch,)
    ob = None
    if args.trace_out or args.metrics_out or args.alerts \
            or args.bundle_dir or args.health_actuate:
        from repro_torch import obs as _o
        ob = _o.instrument()     # engines run on the same monotonic domain
    try:
        if args.trace or args.slo_classes or args.autoscale:
            return serve_resnet_traffic(args, cfg, qp, buckets)
        # single/sharded paths have no event loop: the monitor (if asked
        # for) is ticked once after the run, in the finally block below
        _make_launch_health(args)
        if args.replicas:
            return serve_resnet_sharded(args, cfg, qp, buckets)
        return _serve_resnet_single(args, cfg, qp, buckets)
    finally:
        if ob is not None:
            _finish_obs(args, ob)


def _finish_obs(args, ob) -> None:
    """Export the session's trace/metrics and the alert log, then
    uninstall it."""
    from repro_torch.traffic.wiring import finish_obs

    if ob.health is not None and ob.health.ticks == 0:
        # non-traffic paths have no event loop: one final tick evaluates
        # the rules (the A/B bitwise sentinel in particular) over the
        # finished run
        ob.health.tick(ob.now())
    written = finish_obs(ob, trace_out=args.trace_out,
                         metrics_out=args.metrics_out,
                         bundle_dir=args.bundle_dir)
    if ob.health is not None:
        h = ob.health.summary()
        print(f"health: {h['alerts']} alerts {h['by_rule']}, "
              f"{len(h['bundles'])} bundles")
    for kind, path in sorted(written.items()):
        print(f"wrote {kind} to {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    choices=RESNET_ARCHS + tuple(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="lm: serve the architecture's smoke config")
    ap.add_argument("--slots", type=int, default=4,
                    help="lm: concurrent sequences (continuous batching)")
    ap.add_argument("--max-new", type=int, default=16,
                    help="lm: tokens generated per request")
    ap.add_argument("--max-len", type=int, default=128,
                    help="lm: cache length per slot")
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
                         "runs the kernels' plain versions, or the LM on "
                         "the CPU)")
    ap.add_argument("--trace", default="",
                    help="serve a repro_torch.traffic JSON trace file "
                         "(engages the SLO-class serving path)")
    ap.add_argument("--slo-classes", default="",
                    help="SLO class spec name:deadline_ms:priority[:policy]"
                         ",... or a JSON file (engages the SLO-class "
                         "serving path)")
    ap.add_argument("--autoscale", action="store_true",
                    help="autoscale the active replica set from queue "
                         "depth + utilization (ceiling = --replicas)")
    ap.add_argument("--degrade-arch", default="", choices=("",) +
                    RESNET_ARCHS,
                    help="cheaper variant that degrade-policy SLO classes "
                         "fall back to under overload")
    ap.add_argument("--arrival-rate", type=float, default=200.0,
                    help="Poisson arrival rate (req/s) when serving SLO "
                         "classes without a --trace file")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace_event JSON of the serving "
                         "run (repro_torch.obs; load in Perfetto)")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus-style metrics text "
                         "(repro_torch.obs); the alert log lands next to "
                         "it when alerting is on")
    ap.add_argument("--alerts", action="store_true",
                    help="run the repro_torch.obs.health alert engine "
                         "(passive)")
    ap.add_argument("--bundle-dir", default="",
                    help="dump debug bundles here on alert or "
                         "missed-deadline drain (implies --alerts)")
    ap.add_argument("--health-actuate", action="store_true",
                    help="let active alerts drive the autoscaler and "
                         "overload router (implies --alerts)")
    args = ap.parse_args(argv)
    if args.arch in RESNET_ARCHS:
        return serve_resnet(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
