"""``python -m repro_torch.compile`` — compile-smoke CLI of the generic
compiler, the port's twin of ``python -m repro.compile``.

Lowers every LM smoke model the graph->task registry supports — the
reduced int8 transformer (gemma-2b smoke) and Mamba1 stack
(falcon-mamba-7b smoke) — through the ``cuda`` backend and its
``torch-int`` reference, serves a seeded batch through each bucket's
executable (one CUDA graph a bucket on the card), and checks:

  * ``cuda`` logits within ``lm_params.logit_tolerance`` of ``torch-int``
    (the bound carried from the two final hidden states), equal argmax;
  * logits finite with the expected ``(batch, vocab)`` shape;
  * exactly one capture per compiled bucket (no per-call recapture);
  * every lowered task kind has an impl on both backends.

``bit_exact`` reports whether the logits are equal bitwise: on the CPU
(``--device cpu``, the kernels' plain versions) they are; on the card the
float interludes (attention, scan) may move an int8 value by a grid step,
so only the tolerance is a check there.

Runs on the card unless ``--device cpu``; without a GPU the default exits
non-zero (no CPU fallback).  Exit status is nonzero unless every check on
every model passes; ``--json`` writes the record (the reference's keys,
plus ``device``, ``bit_exact`` and ``max_abs_dev``)::

    PYTHONPATH=src python -m repro_torch.compile --seed 0 --json smoke.json
    PYTHONPATH=src python -m repro_torch.compile --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.compile import (compile_model, get_task_impl,
                                 hidden_out_spec, init_lm_params, lm_config,
                                 lowering)
from repro_torch.compile.compiler import resolve_device
from repro_torch.compile.lm_params import logit_tolerance
from repro_torch.configs import get_smoke_config

SMOKE_MODELS = ("gemma-2b", "falcon-mamba-7b")
BACKENDS = ("cuda", "torch-int")


def _registry_closed(kinds) -> bool:
    try:
        for k in kinds:
            for b in BACKENDS:
                get_task_impl(b, k)
    except lowering.LoweringError:
        return False
    return True


def smoke_one(name: str, *, seq_len: int, batch: int, seed: int,
              device) -> dict:
    """Compile and serve one smoke model on both backends; returns the
    check record (``ok`` holds the verdict)."""
    t0 = time.perf_counter()
    cfg = lm_config(get_smoke_config(name), seq_len=seq_len)
    params = init_lm_params(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq_len)).astype(np.int32)

    plan = lowering.plan_lm(lowering.optimized_graph(cfg), params)
    kinds = sorted({t.kind for t in plan.tasks})
    cms = {b: compile_model(cfg, params, backend=b, batch_sizes=(batch,),
                            device=device) for b in BACKENDS}
    out = {b: cm(toks) for b, cm in cms.items()}
    cms["cuda"](toks)                    # second call: must not recapture

    x = torch.as_tensor(toks, device=cms["cuda"].device)
    hidden = {b: cm.backend.features(cm.graph, cfg, cm.params)(x)
              for b, cm in cms.items()}
    tol = logit_tolerance(hidden["cuda"], hidden["torch-int"],
                          hidden_out_spec(cms["cuda"].params),
                          cms["cuda"].params.unembed).cpu()
    got, ref = out["cuda"].cpu(), out["torch-int"].cpu()
    dev = (got.double() - ref.double()).abs()
    checks = {
        "within_tolerance": bool((dev <= tol).all()),
        "argmax_equal": bool(torch.equal(got.argmax(-1), ref.argmax(-1))),
        "finite": bool(torch.isfinite(got).all()),
        "shape_ok": tuple(got.shape) == (batch, cfg.vocab_size),
        "single_trace": max(cms["cuda"].trace_counts.values()) == 1,
        "registry_closed": _registry_closed(kinds),
    }
    return {
        "model": name,
        "family": cfg.family,
        "tasks": len(plan.tasks),
        "task_kinds": kinds,
        "seq_len": seq_len,
        "batch": batch,
        "vocab": cfg.vocab_size,
        "device": str(cms["cuda"].device),
        "bit_exact": bool(torch.equal(got, ref)),
        "max_abs_dev": float(dev.max()),
        "checks": checks,
        "ok": all(checks.values()),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compile",
        description="compile-smoke: lower, serve and hold cuda against "
                    "torch-int on every LM smoke model")
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable check record here")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    results = [smoke_one(name, seq_len=args.seq_len, batch=args.batch,
                         seed=args.seed, device=device)
               for name in SMOKE_MODELS]
    record = {
        "seed": args.seed,
        "device": str(device),
        "models": results,
        "ok": all(r["ok"] for r in results),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)

    for r in results:
        verdict = "OK " if r["ok"] else "FAIL"
        failed = [k for k, v in r["checks"].items() if not v]
        extra = f"  failed={failed}" if failed else ""
        print(f"{verdict} {r['model']:<18} family={r['family']:<6} "
              f"tasks={r['tasks']:>3} kinds={','.join(r['task_kinds'])} "
              f"bit_exact={r['bit_exact']} max_abs_dev={r['max_abs_dev']:.3g}"
              f" ({r['wall_s']}s){extra}")
    print(("OK" if record["ok"] else "FAIL")
          + f": {len(results)} model(s) on {device} in {record['wall_s']}s")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
