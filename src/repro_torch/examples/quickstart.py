"""Quickstart: the paper's pipeline end to end on the port, in a minute.

1. Build the ResNet8 graph IR and run the paper's residual optimizations
   (loop merge / temporal reuse / add-fold): the Add nodes disappear and
   the skip buffers halve (eq. 23).
2. Train quantization-aware ResNet8 (pow2-int8) for a few steps.
3. Fold BN, quantize into typed containers (``compile.QResNetParams``),
   run the integer graph (``torch-int``).
4. ``compile_model``: lower the optimized graph through the hand-written
   kernels (``cuda``: the stem kernel and one fused add-fold kernel a
   block) into fixed-shape executables, bit-exact with the integer graph,
   and serve them with ``ResNetEngine``.  On the CPU the ``cuda`` backend
   runs its kernels' plain versions.
5. Predict the FPGA throughput with the ILP balancer against the paper's
   Table 3.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import compile as C
from repro_torch.compile.compiler import resolve_device
from repro_torch.core import dataflow, graph, ilp
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.models import resnet as R
from repro_torch.serve.engine import ImageRequest, ResNetEngine
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import make_train_step

PAPER_FPS = (("kv260", 30153), ("ultra96", 12971))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # 1. graph optimization
    g0 = graph.resnet8_graph()
    g1 = graph.optimize(graph.resnet8_graph())
    adds = (sum(1 for n in g0.nodes if n.op == "add"),
            sum(1 for n in g1.nodes if n.op == "add"))
    print(f"[graph] residual Adds: {adds[0]} -> {adds[1]} (folded into "
          f"conv accumulators, paper Fig. 13)")
    out["adds"] = adds
    out["skip"] = []
    for r in graph.skip_buffer_report(graph.resnet8_graph(), g1):
        print(f"[graph] {r['block']}: skip buffer {r['before']} -> "
              f"{r['after']} activations (R_sc = {r['ratio']:.2f}, paper "
              f"eq. 23)")
        out["skip"].append(r["ratio"])

    # 2. QAT training
    cfg = R.RESNET8
    params = R.params_to(R.init_params(cfg, torch.Generator().manual_seed(0)),
                         dev)
    opt = opt_lib.sgdm(lr=0.05, total_steps=args.steps)
    state = opt.init(params)
    pipe = SyntheticCifar(batch_size=64)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    for i in range(args.steps):
        params, state, m = step(params, state, i, pipe.next())
    out["train"] = dict(loss=float(m["loss"]), acc=float(m["acc"]))
    print(f"[train] step {args.steps}: loss={out['train']['loss']:.3f} "
          f"acc={out['train']['acc']:.2f} (QAT pow2-int8)")

    # 3. integer inference graph
    params = R.calibrate_bn(params, cfg, torch.as_tensor(
        pipe.next()["images"], device=dev))
    qp = C.QResNetParams.from_dict(
        R.quantize_params(R.fold_params(params), cfg))
    batch = pipe.next()
    logits_int = R.int_forward(qp, cfg, batch["images"], device=dev)
    out["int8_acc"] = float(np.mean(
        logits_int.argmax(-1).cpu().numpy() == batch["labels"]))
    print(f"[int8] integer-graph accuracy on a fresh batch: "
          f"{out['int8_acc']:.2f} (int8 weights, int16 biases, int32 "
          f"accumulators, shift requant)")

    # 4. compile + serve through the hand-written kernels
    cm = C.compile_model(cfg, qp, backend="cuda", batch_sizes=(64,),
                         device=dev)
    logits_k = cm(torch.as_tensor(batch["images"], device=dev))
    out["bit_exact"] = bool(torch.equal(logits_k, logits_int))
    kernels = "the kernels" if dev.type == "cuda" else \
        "the kernels' plain versions"
    print(f"[compile] cuda executable (stem + add-fold kernel per block, "
          f"{kernels}) bit-exact with the integer graph (torch-int): "
          f"{out['bit_exact']}; {cm.stats()}")
    eng = ResNetEngine(cfg, qp, batch=8, backend="cuda", device=dev)
    for i, img in enumerate(np.asarray(batch["images"][:12])):
        eng.submit(ImageRequest(rid=i, image=img))
    eng.run()
    out["served"] = eng.served
    print(f"[serve] ResNetEngine served {eng.served} images in fixed "
          f"batches through the compiled executable (traces per bucket: "
          f"{eng.model.trace_counts})")

    # 5. FPGA throughput prediction
    out["ilp"] = {}
    for plat, paper_fps in PAPER_FPS:
        sol = ilp.predict_fps(dataflow.resnet8_layers(), plat)
        out["ilp"][plat] = (sol.fps, paper_fps)
        print(f"[ilp] resnet8 on {plat}: predicted {sol.fps:.0f} FPS with "
              f"{sol.dsp_used} DSPs (paper: {paper_fps} FPS)")
    return out


if __name__ == "__main__":
    main()
