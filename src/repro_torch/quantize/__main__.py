"""CLI for the quantization subsystem, on the GPU unless ``--device cpu``.

    # PTQ: float-train briefly (synthetic), calibrate, export, bitwise gate
    PYTHONPATH=src python -m repro_torch.quantize calibrate --arch resnet8 \
        --float-steps 30 --calib-batches 4 --observer percentile

    # QAT: + fake-quant fine-tuning through the repro_torch.train loop,
    # then eval through the serving engine
    PYTHONPATH=src python -m repro_torch.quantize train --arch resnet8 \
        --float-steps 30 --qat-steps 30 --eval-n 256

    # the whole accuracy story (float vs PTQ [vs QAT]) through the serving
    # engine
    PYTHONPATH=src python -m repro_torch.quantize eval --arch resnet8 \
        --float-steps 20 --eval-n 128 --backend cuda --json out.json

Evaluation uses the real CIFAR-10 test split when ``REPRO_DATA_DIR`` (or
``--data-dir``) provides it, else the deterministic synthetic set; nothing
is downloaded.  Training (float and QAT) runs on the synthetic pipeline;
point ``--ckpt-dir`` at a directory to resume a previous float run instead
of retraining.  The export gate holds ``cuda``, ``cuda-stream`` and
``torch-int`` bitwise; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.compile.compiler import resolve_device
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.models import resnet as R
from repro_torch.quantize import (
    QuantRecipe, calibration_batches, evaluate_compiled, evaluate_float,
    fine_tune, load_eval_set, ptq_quantize, validate_export)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, make_train_step, \
    run as loop_run


def _cfg(arch: str):
    cfg = {"resnet8": R.RESNET8, "resnet20": R.RESNET20}[arch]
    # float pre-training: the quantization noise comes from the
    # recipe-driven QAT pass, not from the model's fixed-grid hooks
    return dataclasses.replace(cfg, quant="none")


def _float_train(cfg, args, log=print):
    dev = args.device
    params = R.params_to(R.init_params(
        cfg, torch.Generator().manual_seed(args.seed)), dev)
    pipe = SyntheticCifar(args.batch, seed=args.seed)
    if args.float_steps <= 0 and not args.ckpt_dir:
        return params, pipe
    steps = max(args.float_steps, 1)
    opt = opt_lib.sgdm(lr=args.lr, total_steps=steps,
                       warmup=min(20, max(1, steps // 10)))
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    params, _, metrics = loop_run(
        LoopConfig(total_steps=steps, ckpt_dir=args.ckpt_dir,
                   log_every=max(1, steps // 5)),
        params=params, opt_state=opt.init(params), train_step=step,
        pipeline=pipe, log=log)
    if metrics:
        log(f"[float] final "
            f"{({k: round(float(v), 4) for k, v in metrics.items()})}")
    return params, pipe


def _ptq(cfg, params, args, log=print):
    """BN-calibrate + range-calibrate on held-out batches of the training
    task (``quantize.calibration_batches``) + export + bitwise gate.
    Returns ``(params_bn, calib, qp, check)`` — the BN-written params are
    what the float reference and QAT must use."""
    batches = calibration_batches(args.calib_batches, args.batch, args.seed)
    kw = {}
    if args.observer == "percentile":
        kw["percentile"] = args.percentile
    params, calib, qp = ptq_quantize(cfg, params, batches,
                                     observer=args.observer, **kw)
    check = validate_export(
        cfg, qp, np.asarray(batches[0]["images"][:2], np.float32),
        device=args.device)
    log(f"[export] {cfg.name}: {' / '.join(check['backends'])} bit_exact="
        f"{check['bit_exact']}")
    return params, calib, qp, check


def cmd_calibrate(args) -> dict:
    cfg = _cfg(args.arch)
    params, _ = _float_train(cfg, args)
    params, calib, qp, check = _ptq(cfg, params, args)
    print(calib.summary())
    return dict(calibration=calib.to_dict(), export=check)


def cmd_train(args) -> dict:
    """Calibrate, QAT fine-tune on the calibrated recipe, re-calibrate on the
    fine-tuned weights (the ranges move), export, evaluate."""
    cfg = _cfg(args.arch)
    params, _ = _float_train(cfg, args)
    params, calib, _, _ = _ptq(cfg, params, args)
    recipe = QuantRecipe.from_calibration(calib, cfg)
    pipe = SyntheticCifar(args.batch, seed=args.seed)
    params, metrics = fine_tune(cfg, params, recipe, pipe,
                                steps=args.qat_steps, lr=args.qat_lr)
    params, calib, qp, check = _ptq(cfg, params, args)
    out = _eval(cfg, params, qp, args, qat_metrics=metrics)
    out["calibration"] = calib.to_dict()
    out["export"] = check
    return out


def _eval(cfg, params, qp, args, qat_metrics=None) -> dict:
    images, labels, source = load_eval_set(args.eval_n,
                                           data_dir=args.data_dir,
                                           seed=args.seed)
    if source == "cifar10":
        # this CLI trains on the synthetic task only; scoring that model on
        # real data measures the domain gap, not quantization quality
        print("[eval] WARNING: eval set is real CIFAR-10 but this CLI "
              "trains on the synthetic task — expect ~chance top-1; the "
              "float-vs-int8 GAP is still meaningful, the absolute numbers "
              "are not (train on real data before reading them)")
    t0 = time.perf_counter()
    fl = evaluate_float(cfg, params, images, labels, batch=args.eval_batch,
                        device=args.device)
    res = evaluate_compiled(
        cfg, qp, images, labels, backend=args.backend, batch=args.eval_batch,
        replicas=args.replicas or None, device=args.device)
    out = dict(arch=cfg.name, eval_source=source, eval_n=len(images),
               float_top1=fl["top1"], int8_top1=res["top1"],
               top1_gap=fl["top1"] - res["top1"], backend=res["backend"],
               fps=res["fps"], retraces=res["retraces"],
               replicas=res["replicas"], device=str(args.device),
               eval_s=round(time.perf_counter() - t0, 2))
    if qat_metrics:
        out["qat_final"] = {k: float(v) for k, v in qat_metrics.items()}
    print(f"[eval] {cfg.name} on {source}[{len(images)}]: "
          f"float top1={fl['top1']:.4f}  int8({res['backend']}) "
          f"top1={res['top1']:.4f}  gap={out['top1_gap']:+.4f}  "
          f"fps={res['fps']:.1f}  retraces={res['retraces']}")
    return out


def cmd_eval(args) -> dict:
    cfg = _cfg(args.arch)
    params, _ = _float_train(cfg, args)
    params, calib, qp, check = _ptq(cfg, params, args)
    out = _eval(cfg, params, qp, args)
    if args.qat_steps > 0:
        recipe = QuantRecipe.from_calibration(calib, cfg)
        pipe = SyntheticCifar(args.batch, seed=args.seed)
        params, _ = fine_tune(cfg, params, recipe, pipe,
                              steps=args.qat_steps, lr=args.qat_lr)
        params, calib, qp, check = _ptq(cfg, params, args)
        # after QAT the headline numbers describe the *final* exported
        # model — the same one calibration/export below describe; the
        # pre-QAT measurements survive under ptq_* keys
        ptq = out
        out = _eval(cfg, params, qp, args)
        out["ptq_float_top1"] = ptq["float_top1"]
        out["ptq_int8_top1"] = ptq["int8_top1"]
        out["ptq_top1_gap"] = ptq["top1_gap"]
        out["qat_steps"] = args.qat_steps
    out["calibration"] = calib.to_dict()
    out["export"] = check
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.quantize")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--arch", default="resnet8",
                        choices=("resnet8", "resnet20"))
    common.add_argument("--float-steps", type=int, default=30,
                        help="float pre-training steps (synthetic pipeline; "
                             "0 = random init / --ckpt-dir restore only)")
    common.add_argument("--qat-steps", type=int, default=0,
                        help="fake-quant QAT fine-tuning steps")
    common.add_argument("--batch", type=int, default=64)
    common.add_argument("--lr", type=float, default=0.1)
    common.add_argument("--qat-lr", type=float, default=0.01)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--calib-batches", type=int, default=2)
    common.add_argument("--observer", default="minmax",
                        choices=("minmax", "ema", "percentile"))
    common.add_argument("--percentile", type=float, default=99.9)
    common.add_argument("--eval-n", type=int, default=256)
    common.add_argument("--eval-batch", type=int, default=64)
    common.add_argument("--backend", default="cuda",
                        help="serving backend for the int8 eval (cuda, "
                             "cuda-stream or torch-int)")
    common.add_argument("--replicas", type=int, default=0,
                        help="eval through the replica-pool engine "
                             "(0 = single-device ResNetEngine)")
    common.add_argument("--device", default="cuda",
                        help="where everything runs (cpu: the kernels' "
                             "plain versions)")
    common.add_argument("--data-dir", default=None,
                        help="CIFAR-10 root (default $REPRO_DATA_DIR; "
                             "missing -> deterministic synthetic eval set)")
    common.add_argument("--ckpt-dir", default=None)
    common.add_argument("--json", default=None, metavar="PATH")
    for name, fn in (("calibrate", cmd_calibrate), ("train", cmd_train),
                     ("eval", cmd_eval)):
        p = sub.add_parser(name, parents=[common])
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    out = args.fn(args)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
