"""Tuner CLI — run the design-space search from the command line.

    # full two-stage search (analytic rank + timing of the top-K on the
    # card), written to the config cache:
    PYTHONPATH=src python -m repro_torch.tune --arch resnet20 \
        --backend cuda --batch 32

    # analytic stage only, nothing built, no cache write, on the CPU:
    PYTHONPATH=src python -m repro_torch.tune --arch resnet8 \
        --analytic-only --no-validate --no-cache --device cpu

The cache honors REPRO_TUNE_CACHE (default ~/.cache/repro_torch/tune.json).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.tune import TuneCache, search, space as tspace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--arch", required=True, choices=("resnet8", "resnet20"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "cuda-stream"))
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--analytic-only", action="store_true",
                    help="stage 1 only: rank by the cost model, time "
                         "nothing (the bitwise probe still compiles one "
                         "model pair unless --no-validate)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the bitwise probe against torch-int")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the config cache")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="cache file (overrides REPRO_TUNE_CACHE)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the models are built and timed on "
                         "(default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the TuneResult as JSON")
    args = ap.parse_args(argv)

    from repro_torch.models import resnet as R
    cfg = {"resnet8": R.RESNET8, "resnet20": R.RESNET20}[args.arch]
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(args.seed))), cfg)

    spaces = tspace.model_space(cfg, args.batch, args.backend)
    print(f"{cfg.name} @ batch {args.batch} on {args.backend}: "
          f"{sum(len(v) for v in spaces.values())} legal per-task configs, "
          f"joint space {tspace.space_size(spaces)}")

    res = search(cfg, qp, backend=args.backend, batch=args.batch,
                 top_k=args.top_k, device=not args.analytic_only,
                 validate=not args.no_validate,
                 cache=TuneCache(args.cache) if args.cache else None,
                 use_cache=not args.no_cache, target=args.device)

    print(f"source={res.source}  chosen={res.describe()}")
    for task in sorted(res.modeled):
        m = res.modeled[task]
        print(f"  {task:8s} {res.tuning[task].describe():24s} "
              f"bytes={m['hbm_bytes']} ai={m['arithmetic_intensity']} "
              f"thread_blocks={m['thread_blocks']} waves={m['waves']} "
              f"modeled={m['modeled_us']}us")
    for label, us in res.timings_us.items():
        print(f"  timed {label}: {us}us")
    print(f"cache: {res.cache_stats}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res.to_dict(), f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
