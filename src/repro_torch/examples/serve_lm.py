"""Serve a small LM with batched requests through the continuous-batching
engine on the port (the decode path with a KV cache, optionally int8
pow2-quantized: the paper's scheme applied to the cache).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
          [--arch llama3.2-3b] [--int8-kv] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.compile.compiler import resolve_device
from repro_torch.configs import base as cbase
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cbase.get_smoke_config(args.arch)
    if args.int8_kv:
        cfg = cfg.with_(kv_cache_dtype="int8")
    params = M.init_params(cfg, 0, dev)
    eng = Engine(cfg, params, slots=4, max_len=64, device=dev)
    reqs = [Request(rid=i, prompt=[1 + i, 5, 9], max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    ticks = eng.run()
    dt = time.time() - t0
    total = args.requests * args.max_new
    print(f"{args.arch}{' (int8 KV)' if args.int8_kv else ''}: "
          f"{total} tokens / {ticks} ticks / {dt:.1f}s")
    return dict(arch=args.arch, int8_kv=args.int8_kv, tokens=total,
                ticks=ticks, seconds=dt, outputs=[list(r.out) for r in reqs])


if __name__ == "__main__":
    main()
