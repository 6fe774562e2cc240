#!/usr/bin/env python3
"""The controls of an LM cell's check: the plain reference one step below
the configuration, put in the program's place.

    python3 bench/control_lm.py --workload falcon-mamba-7b.p4x512 --seeds 1,2,3
    python3 bench/control_lm.py --workload falcon-mamba-7b.p4x512 --seeds 1,2,3 \\
        --interludes bfloat16

For each seed it makes the cell's prompt pool as a run does, computes the
reference's logits of the slices the run's check samples at the
configuration's ``control`` widths (W4A8: 4-bit weights; ``--bits``
replaces them, a JSON object), or at the configuration's widths with the
float interludes in ``--interludes`` (bfloat16, the step below float32),
drives the run's closed loop (``run.Loop``) over those slices with the
control's logits in place of the compiled model, and makes the run's check
(``run.check``).  The control has to read a ``logit_gap`` above the
configuration's limit on every seed.  ``bench/control.py`` is the same for
the ResNet cells.  The benchmark's runs never run this.
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


def control_gap(cell, seed, device, bits=None, interludes=None) -> dict:
    """The check's numbers with the reference's control serving every
    sampled slice once."""
    cfg, mix = cell.cfg, cell.mix
    ref = importlib.import_module(f"bench.reference.{cfg['family']}")
    family = importlib.import_module(f"bench.models.{cfg['family']}")
    pool = family.prompt_pool(cfg, mix, seed, device)
    params = dict(seed=int(seed), device=str(device))
    if interludes:
        net = ref.prepare(params, cfg, dtype=getattr(torch, interludes))
    else:
        net = ref.prepare(params, cfg, bits or cfg["control"])
    out = {}

    def model(x):
        return out[x.data_ptr()]

    loop = run.Loop(model, pool, mix, seed, cfg["vocab_size"])
    b = loop.batch
    x = torch.cat([loop.inputs[s] for s in loop.sampled])
    with weights.exact_float():
        logits = ref.logits(net, x).to(torch.float32)
    for i, s in enumerate(loop.sampled):
        out[loop.inputs[s].data_ptr()] = logits[i * b:(i + 1) * b]
    loop.order = list(loop.sampled)
    loop.run(calls=len(loop.order))
    return run.check(loop, params, pool, cfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--bits", default=None)
    p.add_argument("--interludes", choices=("bfloat16",), default=None)
    args = p.parse_args(argv)
    cell = cells.cell(cells.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("control_lm: no CUDA card", file=sys.stderr)
        return 2
    bits = json.loads(args.bits) if args.bits else None
    limit = cell.cfg["limits"]["logit_gap"]
    fails = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        chk = control_gap(cell, seed, torch.device("cuda", 0), bits,
                          args.interludes)
        over = chk["logit_gap"] > limit
        fails += not over
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              bits=None if args.interludes
                              else bits or cell.cfg["control"],
                              interludes=args.interludes or "float32",
                              limit=limit, above_limit=over, **chk)),
              flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
