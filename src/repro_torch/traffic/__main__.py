"""CLI for the traffic subsystem (the port's ``python -m repro.traffic``).

    # deterministic overload simulation (FakeClock, no real sleeping): a
    # bursty trace against ResNet20 with ResNet8 as the degrade variant,
    # autoscaling 1..4 replicas, accuracy cost accounted
    PYTHONPATH=src python -m repro_torch.traffic --arch resnet20 \
        --degrade-arch resnet8 --pattern bursty --rate 2400 --duration 0.5 \
        --fps-primary 800 --fps-degraded 3200 --autoscale --replicas 4 \
        --eval-n 64 --seed 0 --json results/traffic.json

    # replay a recorded trace file instead of generating one
    PYTHONPATH=src python -m repro_torch.traffic --arch resnet20 \
        --trace results/trace.json --fps-primary 800

    # live mode: the same control plane over real ShardedResNetEngine
    # replicas (one a card) on the wall clock
    PYTHONPATH=src python -m repro_torch.traffic --mode live --arch resnet8 \
        --rate 200 --duration 1.0 --requests 64

``--mode sim`` (default) runs the virtual-time simulator: service times come
from a ServiceModel (``--fps-primary`` / ``--fps-degraded``, defaulting to
the paper's Kria KV260 FPGA Table-3 FPS), logits from the real compiled
model (``--backend``, default ``cuda``), and the whole run is deterministic
per ``--seed``.  Models, the accuracy references and the live engines run
on ``--device`` (default ``cuda``, which raises without a GPU); ``--device
cpu`` runs the kernels' plain versions.  Weights are random:
``init_params`` from ``--seed`` for the primary, ``--seed + 1`` for the
degrade variant.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.serve.sched import FakeClock
from repro_torch.traffic import (
    Autoscaler, AutoscaleConfig, LiveTrafficRunner, OverloadRouter,
    PAPER_FPS, ServiceModel, SimServer, TraceReplay, TrafficSim,
    make_process, parse_classes, save_trace, variant_accuracies)
from repro_torch.traffic.wiring import (
    RESNET_CFGS, finish_obs, make_health, pool_devices, pool_size,
    print_report, quantized)


def _class_mix(classes, spec: str):
    if not spec:
        return {c.name: 1.0 for c in classes}
    mix = {}
    for part in spec.split(","):
        name, w = part.split("=")
        mix[name.strip()] = float(w)
    unknown = sorted(set(mix) - {c.name for c in classes})
    if unknown:
        raise SystemExit(f"--class-mix names undefined classes {unknown}")
    return mix


def _arrivals(args, classes):
    if args.trace:
        return TraceReplay.from_file(args.trace).generate(
            horizon_s=args.duration or None, n=args.requests or None)
    proc = make_process(args.pattern, args.rate, seed=args.seed,
                        class_mix=_class_mix(classes, args.class_mix),
                        period_s=args.period,
                        burst_on_s=args.burst_on, burst_off_s=args.burst_off)
    return proc.generate(horizon_s=args.duration,
                         n=args.requests or None)


def _eval_data(args):
    """Eval images/labels + per-variant top-1 references through the
    repro_torch.quantize harness (None when --eval-n 0 / --no-model)."""
    if args.no_model or args.eval_n <= 0:
        return None, None, None
    from repro_torch.quantize import load_eval_set

    images, labels, source = load_eval_set(args.eval_n, seed=args.seed)
    variants = {args.arch: quantized(args.arch, args.seed)}
    if args.degrade_arch:
        variants[args.degrade_arch] = quantized(args.degrade_arch,
                                                 args.seed + 1)
    acc = variant_accuracies(variants, images, labels, backend=args.backend,
                             batch=min(args.batch, len(images)),
                             device=args.device)
    print(f"variant top-1 on {len(images)} {source} images: "
          f"{({k: round(v, 4) for k, v in acc.items()})}")
    return images, labels, acc


def _make_health(args, classes):
    """The HealthMonitor (+ flight recorder) on the active obs session when
    any alerting flag is set, else None."""
    if not (args.alerts or args.bundle_dir or args.health_actuate):
        return None
    return make_health(
        classes, interval_s=args.health_interval_ms * 1e-3,
        bundle_dir=args.bundle_dir, arch=args.arch,
        degrade_arch=args.degrade_arch or None, backend=args.backend,
        batch=args.batch, seed=args.seed)


def run_sim(args, classes, arrivals):
    clock = FakeClock()
    from repro_torch.obs import runtime as _obsrt
    if _obsrt.active() is not None:
        # bind the obs session to the sim's virtual clock: every span and
        # metric then lives in deterministic FakeClock time
        _obsrt.active().set_clock(clock)
    health = _make_health(args, classes)
    images, labels, acc = _eval_data(args)
    models = {}
    if not args.no_model:
        from repro_torch.compile import compile_model

        for arch in ([args.arch] + ([args.degrade_arch]
                                    if args.degrade_arch else [])):
            cfg, qp = quantized(
                arch, args.seed + (0 if arch == args.arch else 1))
            models[arch] = compile_model(cfg, qp, backend=args.backend,
                                         batch_sizes=(args.batch,),
                                         device=args.device)
    autoscaler = None
    active = args.replicas
    actuating = health if args.health_actuate else None
    if args.autoscale:
        autoscaler = Autoscaler(AutoscaleConfig(
            min_replicas=args.min_replicas, max_replicas=args.replicas,
            cooldown_s=args.cooldown_ms * 1e-3), clock=clock,
            health=actuating)
        active = autoscaler.active
    servers = {args.arch: SimServer(
        args.arch, ServiceModel.from_fps(
            args.fps_primary or PAPER_FPS[args.arch]),
        clock, replicas=args.replicas, max_batch=args.batch,
        slack_ms=args.slack_ms, model=models.get(args.arch), active=active)}
    if args.degrade_arch:
        servers[args.degrade_arch] = SimServer(
            args.degrade_arch, ServiceModel.from_fps(
                args.fps_degraded or PAPER_FPS[args.degrade_arch]),
            clock, replicas=args.degrade_replicas, max_batch=args.batch,
            slack_ms=args.slack_ms, model=models.get(args.degrade_arch))
    router = OverloadRouter(classes, primary=args.arch,
                            degraded=args.degrade_arch or None,
                            enabled=not args.no_degrade, health=actuating)
    sim = TrafficSim(servers, classes, router, clock, autoscaler=autoscaler,
                     health=health)
    return sim.run(arrivals, images=images, labels=labels,
                   accuracy_by_variant=acc)


def run_live(args, classes, arrivals):
    from repro_torch.serve.engine import ShardedResNetEngine

    health = _make_health(args, classes)
    images, labels, acc = _eval_data(args)
    if images is None:
        rng = np.random.default_rng(args.seed)
        images = rng.random(
            (64, RESNET_CFGS[args.arch].img, RESNET_CFGS[args.arch].img, 3)
        ).astype(np.float32)
    replicas = pool_size(args.device, args.replicas)
    variants = {}
    for arch in ([args.arch] + ([args.degrade_arch]
                                if args.degrade_arch else [])):
        cfg, qp = quantized(arch,
                             args.seed + (0 if arch == args.arch else 1))
        eng = ShardedResNetEngine(
            cfg, qp, batch=args.batch, backend=args.backend,
            replicas=replicas, devices=pool_devices(args.device, replicas),
            slack_ms=args.slack_ms)
        eng.pool.warmup()
        variants[arch] = eng
    autoscaler = None
    actuating = health if args.health_actuate else None
    if args.autoscale:
        autoscaler = Autoscaler(AutoscaleConfig(
            min_replicas=args.min_replicas,
            max_replicas=replicas,
            cooldown_s=args.cooldown_ms * 1e-3),
            clock=variants[args.arch].clock, health=actuating)
        variants[args.arch].set_active_replicas(autoscaler.active)
    router = OverloadRouter(classes, primary=args.arch,
                            degraded=args.degrade_arch or None,
                            enabled=not args.no_degrade, health=actuating)
    runner = LiveTrafficRunner(variants, classes, router,
                               autoscaler=autoscaler, health=health)
    return runner.run(arrivals, images, labels=labels,
                      accuracy_by_variant=acc)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.traffic",
        description="trace-driven load generation, SLO classes, autoscaling "
                    "and accuracy-aware graceful degradation")
    ap.add_argument("mode_pos", nargs="?", choices=("sim", "live"),
                    metavar="mode",
                    help="positional alias for --mode: "
                         "`python -m repro_torch.traffic sim ...`")
    ap.add_argument("--mode", choices=("sim", "live"), default="sim")
    ap.add_argument("--arch", default="resnet20", choices=sorted(RESNET_CFGS),
                    help="primary (full-accuracy) model")
    ap.add_argument("--degrade-arch", default="resnet8",
                    help="cheaper variant for degrade-policy classes "
                         "('' disables the variant entirely)")
    ap.add_argument("--backend", default="cuda",
                    help="a repro_torch.compile registered backend")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models and the live engines "
                         "(default cuda; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=4,
                    help="primary replica pool size (autoscale ceiling)")
    ap.add_argument("--degrade-replicas", type=int, default=1)
    ap.add_argument("--slack-ms", type=float, default=2.0)
    # traffic shape
    ap.add_argument("--trace", default="", help="replay this JSON trace")
    ap.add_argument("--save-trace", default="",
                    help="write the generated arrivals to this JSON file")
    ap.add_argument("--pattern", default="bursty",
                    choices=("poisson", "bursty", "diurnal"))
    ap.add_argument("--rate", type=float, default=2400.0,
                    help="mean arrival rate (req/s)")
    ap.add_argument("--duration", type=float, default=0.5,
                    help="trace horizon in seconds")
    ap.add_argument("--requests", type=int, default=0,
                    help="cap on generated/replayed arrivals (0 = horizon "
                         "only)")
    ap.add_argument("--burst-on", type=float, default=0.05)
    ap.add_argument("--burst-off", type=float, default=0.05)
    ap.add_argument("--period", type=float, default=10.0,
                    help="diurnal pattern period (s)")
    ap.add_argument("--class-mix", default="",
                    help="per-class arrival weights, e.g. "
                         "'interactive=1,standard=2,bulk=1' (default "
                         "uniform)")
    ap.add_argument("--slo-classes", dest="classes", default="",
                    help="inline name:deadline_ms:priority[:policy] spec or "
                         "a JSON file (default: the three-tier mix)")
    # policies
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--cooldown-ms", type=float, default=50.0)
    ap.add_argument("--no-degrade", action="store_true",
                    help="disable overload degradation/shedding (A/B arm)")
    # sim service model
    ap.add_argument("--fps-primary", type=float, default=0.0,
                    help="sim: primary per-replica FPS (default: paper "
                         "Table 3, the Kria KV260 FPGA)")
    ap.add_argument("--fps-degraded", type=float, default=0.0)
    # accuracy accounting
    ap.add_argument("--eval-n", type=int, default=64,
                    help="eval-set size for the per-variant top-1 "
                         "references (0 disables accuracy accounting)")
    ap.add_argument("--no-model", action="store_true",
                    help="sim: pure queueing simulation, no compiled model")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="", help="write the report here")
    # observability (repro_torch.obs)
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace_event JSON (Perfetto-loadable)"
                         " of the run here")
    ap.add_argument("--jsonl-out", default="",
                    help="write the JSONL event log here")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus-style metrics text here")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the per-task kernel profiling pass that "
                         "--trace-out runs after the traffic run")
    ap.add_argument("--profile-backend", default="cuda",
                    choices=("cuda", "cuda-stream"),
                    help="kernel pipeline the profiling pass times")
    # health / alerting (repro_torch.obs.health; observe-only unless
    # --health-actuate closes the loop)
    ap.add_argument("--alerts", action="store_true",
                    help="run the HealthMonitor alert engine (passive: "
                         "never changes a routing or scaling decision)")
    ap.add_argument("--bundle-dir", default="",
                    help="dump debug bundles here on alert / missed-deadline "
                         "drain (implies --alerts); the alert log is "
                         "written to <dir>/alerts.jsonl")
    ap.add_argument("--health-actuate", action="store_true",
                    help="wire active alerts into the autoscaler and the "
                         "overload router (implies --alerts); every "
                         "actuation is recorded with reason='alert:<rule>'")
    ap.add_argument("--health-interval-ms", type=float, default=20.0,
                    help="health-rule evaluation cadence (default 20ms)")
    args = ap.parse_args(argv)
    if args.mode_pos:
        args.mode = args.mode_pos
    if args.degrade_arch and args.degrade_arch not in RESNET_CFGS:
        ap.error(f"--degrade-arch must be one of {sorted(RESNET_CFGS)} "
                 f"or ''")
    if args.degrade_arch == args.arch:
        args.degrade_arch = ""

    classes = parse_classes(args.classes)
    arrivals = _arrivals(args, classes)
    print(f"{len(arrivals)} arrivals over "
          f"{arrivals[-1].t if arrivals else 0:.3f}s "
          f"({args.trace or args.pattern}, seed={args.seed})")
    if args.save_trace:
        save_trace(args.save_trace, arrivals,
                   meta=dict(pattern=args.pattern, rate=args.rate,
                             seed=args.seed))
        print(f"wrote trace to {args.save_trace}")

    ob = None
    if args.trace_out or args.metrics_out or args.jsonl_out \
            or args.alerts or args.bundle_dir or args.health_actuate:
        from repro_torch import obs as _o
        ob = _o.instrument()     # run_sim re-binds to its FakeClock

    report = (run_sim if args.mode == "sim" else run_live)(
        args, classes, arrivals)
    report["mode"] = args.mode
    report["seed"] = args.seed

    if ob is not None:
        if args.trace_out and not args.no_model and not args.no_profile:
            # per-task kernel profiles ride along in the same trace: device
            # timings of the production kernels + modeled HBM/VMEM bytes
            from repro_torch.obs.profile import profile_tasks
            cfg, qp = quantized(args.arch, args.seed)
            profile_tasks(cfg, qp, backend=args.profile_backend,
                          batch=args.batch, reps=1, seed=args.seed, ob=ob,
                          device=args.device)
        written = finish_obs(ob, trace_out=args.trace_out,
                             metrics_out=args.metrics_out,
                             jsonl_out=args.jsonl_out,
                             bundle_dir=args.bundle_dir)
        report["obs"] = dict(trace=ob.trace.summary(),
                             profiles=[p.to_dict() for p in ob.profiles],
                             written=written)
        for kind, path in sorted(written.items()):
            print(f"wrote {kind} to {path}")

    print_report(report)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote report to {args.json}")
    return report


if __name__ == "__main__":
    main()
