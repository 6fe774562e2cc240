"""Host microseconds of one ``block_chain_op`` call: ResNet20's chain with
the stem fused, at batch 32, on the CUDA GPU.

    python3 src/repro_torch/kernels/megakernel/host_us.py --src SRC

``SRC`` is the ``src`` directory of a checkout of this repository; the
``repro_torch`` package found there is the one timed, so two versions of
the wrapper can be compared in one session on one card by running the
script once for each (in turns: A, B, B, A).  The operands are made with
numpy from ``--seed`` and do not depend on the version.  Prints one JSON
line: the host microseconds until the direct op returns (the device left
to run behind it), and, where the version has ``ChainLaunch``, the same
for a prepared launch and the microseconds its preparation takes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# ResNet20's chain: (cin, cout, stride) of each link, on a 32x32 image
RESNET20_LINKS = [(16, 16, 1)] * 3 + [(16, 32, 2)] + [(32, 32, 1)] * 2 + \
    [(32, 64, 2)] + [(64, 64, 1)] * 2


def operands(seed: int, n: int):
    """(x, blocks, specs, stem, stem_shift) for ResNet20's chain, on the
    GPU."""
    import numpy as np
    import torch

    from repro_torch.kernels.megakernel.ops import ChainBlockSpec

    rng = np.random.default_rng(seed)

    def t(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)
                                ).cuda()

    x = t(0, 256, (n, 32, 32, 3), np.uint8)
    stem = (t(-128, 128, (3, 3, 3, 16), np.int8),
            t(-500, 500, (16,), np.int32))
    blocks, specs = [], []
    for cin, cout, stride in RESNET20_LINKS:
        ws = (t(-128, 128, (3, 3, cin, cout), np.int8),
              t(-500, 500, (cout,), np.int32),
              t(-128, 128, (3, 3, cout, cout), np.int8),
              t(-500, 500, (cout,), np.int32))
        has_ds = stride == 2 or cin != cout
        if has_ds:
            ws += (t(-128, 128, (1, 1, cin, cout), np.int8),
                   t(-500, 500, (cout,), np.int32))
        blocks.append(ws)
        specs.append(ChainBlockSpec(stride=stride, has_ds=has_ds, shift0=11,
                                    shift1=12, skip_shift=0))
    return x, tuple(blocks), tuple(specs), stem, 9


def host_us(fn, reps: int) -> float:
    """Host microseconds one call takes to return, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, type=Path,
                    help="src directory holding the repro_torch to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=32, help="batch")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("host_us.py: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.megakernel import ops

    x, blocks, specs, stem, stem_shift = operands(args.seed, args.n)
    kw = dict(specs=specs, stem=stem, stem_shift=stem_shift)
    rec = dict(src=str(args.src), package=ops.__file__, n=args.n,
               reps=args.reps,
               direct_op_us=host_us(lambda: ops.block_chain_op(x, blocks,
                                                               **kw),
                                    args.reps))
    if hasattr(ops, "ChainLaunch"):
        launch = ops.ChainLaunch(blocks, in_shape=x.shape[1:], **kw)
        check = torch.equal(launch(x), ops.block_chain_op(x, blocks, **kw))
        rec.update(prepared_us=host_us(lambda: launch(x), args.reps),
                   prepare_us=host_us(lambda: ops.ChainLaunch(
                       blocks, in_shape=x.shape[1:], **kw), 20),
                   prepared_equals_direct=check)
    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
