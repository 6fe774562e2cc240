"""Training launcher: ResNet8/20 on the synthetic CIFAR task, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet20 \
        --steps 100 --ckpt-dir /tmp/ck

The port of the ResNet branch of ``repro.launch.train``: the model's QAT
float path (``cfg.quant == "qat"``: fixed pow2 grids, STE), SGD with
momentum on a cosine schedule, through the fault-tolerant loop
(checkpoints every ``--ckpt-every`` steps, auto-resume from ``--ckpt-dir``,
the step watchdog).  Weights are random from ``--seed`` (a CPU generator,
so every machine starts from the same ones).  ``--device cpu`` trains on
the CPU.  The LM architectures are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.compile.compiler import resolve_device
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.models import resnet as R
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, make_train_step, run

RESNET_ARCHS = {"resnet8": R.RESNET8, "resnet20": R.RESNET20}


def train_resnet(args, log=print):
    """Train ``args.arch`` for ``args.steps`` steps; returns ``(params,
    opt_state, metrics)`` of the last step."""
    cfg = RESNET_ARCHS[args.arch]
    dev = resolve_device(args.device)
    params = R.params_to(R.init_params(
        cfg, torch.Generator().manual_seed(args.seed)), dev)
    opt = opt_lib.sgdm(lr=args.lr, total_steps=args.steps)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          watchdog_s=args.watchdog_s)
    params, opt_state, metrics = run(
        loop_cfg, params=params, opt_state=opt.init(params),
        train_step=step, pipeline=SyntheticCifar(args.batch, seed=args.seed),
        log=log)
    log(f"final: {({k: float(v) for k, v in metrics.items()})}")
    return params, opt_state, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the GPU)")
    args = ap.parse_args(argv)
    if args.arch not in RESNET_ARCHS:
        raise SystemExit(
            f"--arch {args.arch!r}: only {sorted(RESNET_ARCHS)} train in "
            f"the port; the LM architectures (train_lm) are ROADMAP item "
            f"A9, not ported yet")
    return train_resnet(args)


if __name__ == "__main__":
    main()
