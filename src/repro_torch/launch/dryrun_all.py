"""The sweep: run every (arch x shape x mesh) dry-run cell in a fresh
subprocess (one ``fake`` process group each), collect JSON results.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
        --results results/dryrun [--only single|multi] [--arch ...] \\
        [--timeout 2400] [--device cpu]

The port of ``repro.launch.dryrun_all``.  A cell whose result file exists
is not run again (cached); cells an arch does not support (long_500k on
pure full-attention archs) are recorded as skipped with the reason; a
failed or timed-out cell leaves ``<cell>.json.err``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import base as cbase

ORDER = [  # smallest first: bank results early
    "internvl2-1b", "gemma-2b", "llama3.2-3b", "whisper-large-v3",
    "granite-8b", "falcon-mamba-7b", "zamba2-7b", "mixtral-8x22b",
    "nemotron-4-340b", "deepseek-v3-671b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cells(archs, only):
    for multi in ([False, True] if only is None else
                  [only == "multi"]):
        for a in archs:
            for s in SHAPES:
                yield a, s, multi


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun_all")
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--only", choices=["single", "multi"], default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default: the GPU)")
    args = ap.parse_args(argv)
    os.makedirs(args.results, exist_ok=True)
    archs = [args.arch] if args.arch else ORDER
    todo = list(cells(archs, args.only))
    t00 = time.time()
    statuses = {}
    for i, (arch, shape, multi) in enumerate(todo):
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        out = os.path.join(args.results, tag + ".json")
        if os.path.exists(out):
            print(f"[{i+1}/{len(todo)}] {tag}: cached", flush=True)
            statuses[tag] = "cached"
            continue
        cfg = cbase.get_config(arch)
        if not cfg.supports_shape(shape):
            with open(out, "w") as f:
                json.dump(dict(arch=arch, shape=shape, multi_pod=multi,
                               skipped=True,
                               reason="full attention: 500k dense decode "
                                      "unsupported"), f)
            print(f"[{i+1}/{len(todo)}] {tag}: SKIP (full attention)",
                  flush=True)
            statuses[tag] = "skip"
            continue
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out, "--device", args.device]
        if multi:
            cmd.append("--multi-pod")
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            ok = r.returncode == 0 and os.path.exists(out)
            status = "ok" if ok else f"FAIL rc={r.returncode}"
            if not ok:
                with open(out + ".err", "w") as f:
                    f.write(r.stdout[-4000:] + "\n---\n" + r.stderr[-8000:])
        except subprocess.TimeoutExpired:
            status = "TIMEOUT"
            with open(out + ".err", "w") as f:
                f.write("timeout")
        statuses[tag] = status
        dt = time.time() - t0
        print(f"[{i+1}/{len(todo)}] {tag}: {status} ({dt:.0f}s, "
              f"total {(time.time()-t00)/60:.1f}m)", flush=True)
    return statuses


if __name__ == "__main__":
    main()
