#!/usr/bin/env python3
"""The control of the check: the plain reference computed one precision
below the configuration's, put in the program's place.

    python3 bench/control.py --workload resnet20.b32 --seeds 1,2,3

For each seed it makes the cell's weights and pool as a run does, drives
the run's closed loop (``run.Loop``) at the cell's batch and depth with the
reference at the configuration's ``control`` widths (W4A8: 4-bit weights)
in place of the compiled model, over every slice of the pool once, and
makes the run's check (``run.check``).  The control has to read a
``logit_gap`` above the configuration's limit on every seed.  ``--bits``
replaces the widths (a JSON object, e.g. ``{"bw_w": 4, "bw_x": 4}``);
``--head float16`` keeps the configuration's widths and computes the float
head (pool and classifier) in float16, the step below the program's
float32 head.
The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from bench import cells, run, weights  # noqa: E402


def control_gap(cell, seed, device, bits=None, head=None) -> dict:
    """The check's numbers with the reference serving every slice of the
    pool once: at ``bits`` (default: the configuration's ``control``), or
    with the configuration's widths and the head in ``head``."""
    cfg, mix = cell.cfg, cell.mix
    ref = importlib.import_module(f"bench.reference.{cfg['family']}")
    params, pool = weights.make(cfg, mix, seed, device)
    net = ref.prepare(params, cfg, None if head else bits or cfg["control"])
    dtype = getattr(torch, head or "float64")

    def model(x):
        with weights.exact_float():
            return ref.logits(net, x, dtype).to(torch.float32)

    loop = run.Loop(model, pool, mix, seed, cfg["num_classes"])
    loop.run(calls=len(loop.order))
    return run.check(loop, params, pool, cfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--bits", default=None)
    p.add_argument("--head", choices=("float16",), default=None)
    args = p.parse_args(argv)
    cell = cells.cell(cells.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bits = json.loads(args.bits) if args.bits else None
    limit = cell.cfg["limits"]["logit_gap"]
    fails = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        chk = control_gap(cell, seed, torch.device("cuda", 0), bits,
                          args.head)
        over = chk["logit_gap"] > limit
        fails += not over
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              bits=None if args.head
                              else bits or cell.cfg["control"],
                              head=args.head or "float64",
                              limit=limit, above_limit=over, **chk)),
              flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
