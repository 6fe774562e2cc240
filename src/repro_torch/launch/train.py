"""Training launcher, on the GPU: ResNet8/20 on the synthetic CIFAR task
and the ten LM architectures on synthetic tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet20 \
        --steps 100 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --smoke --steps 50 --ckpt-dir /tmp/ck

The port of ``repro.launch.train``.  ResNet: the model's QAT float path
(``cfg.quant == "qat"``: fixed pow2 grids, STE), SGD with momentum on a
cosine schedule; weights random from ``--seed`` drawn by a CPU generator,
so every machine starts from the same ones.  LMs (``train_lm``): the
published config (``--smoke``: the reduced one), weights random from
``--seed`` drawn on the device, AdamW (``--int8-opt``: int8 pow2 moments)
updated in place, ``--grad-accum`` microbatches a step, on
``SyntheticTokens`` of ``--batch`` x ``--seq``.  Both go through the
fault-tolerant loop (checkpoints every ``--ckpt-every`` steps,
auto-resume from ``--ckpt-dir``, the step watchdog).  ``--device cpu``
trains on the CPU; the default is the GPU, and it raises without one.

``--mesh-data D --mesh-model M`` (either above 1) train an LM on the
reference's FSDP x TP mesh, one process a rank under ``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch gemma-2b --smoke --mesh-data 2 --mesh-model 2 --device cpu

(``nccl`` on the GPU, one card a rank; ``gloo`` with ``--device cpu``).
Every rank draws the same weights from ``--seed`` and keeps its shards
(``parallel.sharding.params_shardings``), the moments inherit their
placements, and the step runs inside ``parallel.ctx.mesh_context``; a
resume reshards the checkpoint onto the mesh, whatever mesh wrote it.
The launcher refuses a world size other than ``D * M``, naming the
command to run.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.compile.compiler import resolve_device
from repro_torch.configs import base as cbase
from repro_torch.data.synthetic import SyntheticCifar, SyntheticTokens
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import make_train_step as make_lm_step
from repro_torch.models import model as M
from repro_torch.models import resnet as R
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, make_train_step, run

RESNET_ARCHS = {"resnet8": R.RESNET8, "resnet20": R.RESNET20}
# the inputs a family's loss reads beside the tokens, which
# SyntheticTokens does not make (nor does the reference's train_lm)
MISSING_INPUT = {"audio": "frames", "vlm": "patches"}


def _loop_config(args):
    return LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, watchdog_s=args.watchdog_s)


def train_resnet(args, log=print):
    """Train ``args.arch`` for ``args.steps`` steps; returns ``(params,
    opt_state, metrics)`` of the last step."""
    cfg = RESNET_ARCHS[args.arch]
    dev = resolve_device(args.device)
    params = R.params_to(R.init_params(
        cfg, torch.Generator().manual_seed(args.seed)), dev)
    opt = opt_lib.sgdm(lr=args.lr, total_steps=args.steps)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    params, opt_state, metrics = run(
        _loop_config(args), params=params, opt_state=opt.init(params),
        train_step=step, pipeline=SyntheticCifar(args.batch, seed=args.seed),
        log=log)
    log(f"final: {({k: float(v) for k, v in metrics.items()})}")
    return params, opt_state, metrics


def train_lm(args, log=print):
    """Train the LM ``args.arch`` for ``args.steps`` steps; returns
    ``(params, opt_state, metrics)`` of the last step."""
    cfg = (cbase.get_smoke_config(args.arch) if args.smoke
           else cbase.get_config(args.arch))
    if cfg.family in MISSING_INPUT:
        raise SystemExit(
            f"--arch {args.arch}: its loss reads batch"
            f"[{MISSING_INPUT[cfg.family]!r}], which SyntheticTokens does "
            f"not make (nor does the reference's train_lm)")
    mesh, lead = None, True
    if args.mesh_data > 1 or args.mesh_model > 1:
        mesh = _start_mesh(args)
        dev = mesh_lib.rank_device(mesh)
        lead = mesh.get_rank() == 0
    else:
        dev = resolve_device(args.device)
    params = M.init_params(cfg, args.seed, dev)
    opt = opt_lib.adamw(lr=args.lr, total_steps=args.steps,
                        int8_state=args.int8_opt)
    shardings = None
    if mesh is not None:
        p_shard = shd.params_shardings(params, mesh)
        params = shd.distribute_tree(params, p_shard)
    opt_state = opt.init(params)
    if mesh is not None:
        shardings = (p_shard, shd.state_shardings(opt_state, p_shard))
    step = make_lm_step(cfg, opt, grad_accum=args.grad_accum)

    def on_device(p, o, i, batch):
        return step(p, o, i, {k: torch.as_tensor(v, device=dev)
                              for k, v in batch.items()})

    try:
        with ctx.mesh_context(mesh):
            params, opt_state, metrics = run(
                _loop_config(args), params=params, opt_state=opt_state,
                train_step=on_device, pipeline=SyntheticTokens(
                    args.batch, args.seq, cfg.vocab_size, seed=args.seed),
                shardings=shardings,
                log=log if lead else (lambda *a, **k: None))
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    if lead:
        log(f"final: {({k: float(v) for k, v in metrics.items()})}")
    return params, opt_state, metrics


def _start_mesh(args):
    """The ``(mesh_data, mesh_model)`` mesh over a process group started
    from the ``torchrun`` environment, whose world size must be its
    size."""
    need = args.mesh_data * args.mesh_model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise SystemExit(
            f"--mesh-data {args.mesh_data} --mesh-model {args.mesh_model} "
            f"needs {need} ranks, one process each, and this is a world of "
            f"{world}; run: torchrun --nproc-per-node {need} -m "
            f"repro_torch.launch.train --arch {args.arch} ... --mesh-data "
            f"{args.mesh_data} --mesh-model {args.mesh_model}")
    mesh_lib.init_process_group(args.device)
    return mesh_lib.make_local_mesh(args.mesh_data, args.mesh_model,
                                    args.device)



def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 0.05 for the ResNets, 1e-3 for the LMs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the LM's reduced config")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--int8-opt", action="store_true",
                    help="int8 pow2 AdamW moments")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the GPU)")
    args = ap.parse_args(argv)
    if args.arch in RESNET_ARCHS:
        args.lr = args.lr or 0.05
        return train_resnet(args)
    args.lr = args.lr or 1e-3
    return train_lm(args)


if __name__ == "__main__":
    main()
