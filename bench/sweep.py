#!/usr/bin/env python3
"""Run one cell several times, one process a run, and report the spread.

    python3 bench/sweep.py --workload resnet20.b32 --seeds 11,12,13 \
        --seconds 51 --trace 0 --out results/resnet20.b32.jsonl

Each run is ``bench/run.py`` with one seed, in turn, never two at once.
Every run's result line (or its failure) is appended to ``--out`` with the
wall seconds it took, the end of its standard error, and what was sampled
every ``SAMPLE_S`` seconds while it ran: the CPU the run was on and that
CPU's clock, and the card's clocks, power and temperature.  At the end it
prints, per metric, the median and the spread: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median, over the runs given and over them without the first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SAMPLE_S = 10.0
GPU_QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def cpu_of(pid):
    """``(cpu, MHz)``: the CPU process ``pid`` last ran on and its clock."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
        cpu = int(stat[stat.rindex(")") + 2:].split()[36])
        block = Path("/proc/cpuinfo").read_text().split("\n\n")[cpu]
        mhz = [ln.split(":")[1] for ln in block.splitlines()
               if ln.startswith("cpu MHz")]
        return cpu, (float(mhz[0]) if mhz else None)
    except (OSError, ValueError, IndexError):
        return None, None


def gpu_sample():
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={GPU_QUERY}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run_sampled(cmd):
    """Run ``cmd``; returns ``(proc result, samples)``."""
    samples = []
    with subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        while True:
            try:
                out, err = proc.communicate(timeout=SAMPLE_S)
                break
            except subprocess.TimeoutExpired:
                samples.append(dict(cpu=cpu_of(proc.pid), gpu=gpu_sample()))
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err), \
        samples


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values, ok = {}, True
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, str(ROOT / "bench" / "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc, samples = run_sampled(cmd)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if proc.returncode == 0 else None
        except (IndexError, json.JSONDecodeError):
            line = None
        rec = dict(workload=args.workload, seed=seed, trace=args.trace,
                   rc=proc.returncode, wall_s=wall, result=line,
                   samples=samples, stderr=proc.stderr[-3000:])
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if line is None or not line["correct"]:
            ok = False
        short = {k: v["value"] for k, v in (line or {}).get(
            "metrics", {}).items()}
        print(f"{args.workload} seed {seed} rc {proc.returncode} "
              f"wall {wall:.1f}s correct {line and line['correct']} "
              f"{short} {line and line.get('checks')}", flush=True)
        for k, v in short.items():
            values.setdefault(k, []).append(v)
    for k, vs in values.items():
        print(f"{args.workload} {k}: median {statistics.median(vs)!r} "
              f"spread {spread(vs)!r} without the first "
              f"{spread(vs[1:])!r} n {len(vs)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
