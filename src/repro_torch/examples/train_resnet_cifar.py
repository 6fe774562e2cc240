"""End-to-end driver of the paper's accuracy story on the port's
``repro_torch.quantize``: float-train ResNet20 with the fault-tolerant
loop (checkpoints, auto-resume, preemption-safe), PTQ-calibrate
per-tensor pow2 grids with observers, fake-quant QAT fine-tuning, export
to the typed integer params (gated bit-exact across ``cuda``,
``cuda-stream`` and ``torch-int``), and a top-1 eval through the serving
engine: float -> calibrate -> QAT -> export -> eval.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_resnet_cifar \\
          [--steps 300] [--device cpu]

With CIFAR-10 extracted under ``$REPRO_DATA_DIR`` the eval uses the real
test split; otherwise the deterministic synthetic set (the training
task's class templates, held-out draws).  Nothing is downloaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.compile.compiler import resolve_device
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.models import resnet as R
from repro_torch.quantize import (
    QuantRecipe, calibration_batches, evaluate_compiled, evaluate_float,
    fine_tune, load_eval_set, ptq_quantize, validate_export)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, make_train_step, run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples."
                                      "train_resnet_cifar")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--qat-steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--eval-n", type=int, default=512)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--observer", default="percentile",
                    choices=("minmax", "ema", "percentile"))
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # float pre-training: the quantization noise comes from the
    # recipe-driven QAT pass below, not the model's fixed-grid hooks
    cfg = dataclasses.replace(R.RESNET20, quant="none")
    params = R.params_to(R.init_params(cfg, torch.Generator().manual_seed(0)),
                         dev)
    opt = opt_lib.sgdm(lr=0.1, total_steps=args.steps,
                       warmup=min(20, max(1, args.steps // 10)))
    pipe = SyntheticCifar(args.batch)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="resnet20_ck_")
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    params, _, metrics = run(
        LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                   ckpt_every=100),
        params=params, opt_state=opt.init(params), train_step=step,
        pipeline=pipe)
    out = dict(float_metrics={k: float(v) for k, v in metrics.items()})
    print("float metrics:", out["float_metrics"])

    # PTQ: BN-calibrate, observe ranges, derive per-tensor pow2 grids
    calib_batches = calibration_batches(args.calib_batches, args.batch)
    params, calib, qp = ptq_quantize(cfg, params, calib_batches,
                                     observer=args.observer)
    print(calib.summary())

    # QAT: fine-tune under fake-quant noise on the calibrated recipe
    recipe = QuantRecipe.from_calibration(calib, cfg)
    params, qat_metrics = fine_tune(cfg, params, recipe, pipe,
                                    steps=args.qat_steps, lr=0.01)
    if qat_metrics:
        out["qat_metrics"] = {k: float(v) for k, v in qat_metrics.items()}
        print("qat metrics:", out["qat_metrics"])
        # ranges moved during fine-tuning: re-calibrate and re-export
        params, calib, qp = ptq_quantize(cfg, params, calib_batches,
                                         observer=args.observer)

    # gate the export on cross-backend bit-exactness
    out["export"] = validate_export(cfg, qp,
                                    calib_batches[0]["images"][:2],
                                    device=dev)
    print("export:", out["export"])

    # top-1 through the serving engine
    images, labels, source = load_eval_set(args.eval_n)
    if source == "cifar10":
        print("WARNING: eval set is real CIFAR-10 but training ran on the "
              "synthetic task — the float-vs-int8 gap is meaningful, the "
              "absolute top-1 is not")
    fl = evaluate_float(cfg, params, images, labels, device=dev)
    res = evaluate_compiled(cfg, qp, images, labels, backend=args.backend,
                            device=dev)
    out.update(source=source, eval_n=len(images), float_top1=fl["top1"],
               int8_top1=res["top1"], fps=res["fps"],
               retraces=res["retraces"])
    print(f"eval[{source} n={len(images)}]: float top1={fl['top1']:.4f}  "
          f"int8({args.backend}) top1={res['top1']:.4f}  "
          f"fps={res['fps']:.1f}  retraces={res['retraces']}  "
          f"(checkpoints in {ckpt_dir})")
    return out


if __name__ == "__main__":
    main()
