"""Fake-quant QAT: fine-tune a float ResNet under quantization noise.

The float model runs with every tensor round-tripped through its calibrated
power-of-two grid (``core.quant.fake_quant`` — straight-through estimator:
gradient = identity inside the clip range, 0 outside), so the optimizer sees
the loss surface the integer pipeline will actually evaluate.  Weight grids
are *dynamic*: the pow2 exponent is recomputed from ``max |w|`` every step
(detached: the grid is data, not a differentiable parameter), because the
weights move during fine-tuning and at export time their exponents are
recalibrated on the folded weights anyway.  The exponent stays a float32
tensor on the weights' device (``2.0 ** e``), so a step reads nothing back
to the host.

``fine_tune`` wires this into the fault-tolerant training loop
(``repro_torch.train.loop.run``): checkpointing, auto-resume, preemption
handling and the step watchdog all apply to QAT exactly as to float
training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import quant as Q
from repro_torch.core.quant import QSpec
from repro_torch.models import resnet as R
from repro_torch.quantize.calibrate import CalibrationResult
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, make_train_step, \
    run as loop_run


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """The static quantization plan for QAT: per-site activation grids (from
    calibration) + the weight bit width.  Frozen and hashable by content."""

    x_spec: QSpec                    # input images
    stem_out: QSpec                  # post-stem activation grid
    mids: Tuple[QSpec, ...]          # conv0-output grid, one per block
    outs: Tuple[QSpec, ...]          # block-output grid, one per block
    bits_w: int = 8

    @classmethod
    def from_calibration(cls, calib: CalibrationResult,
                         cfg) -> "QuantRecipe":
        n = 3 * cfg.blocks_per_stage
        return cls(x_spec=calib.x_spec, stem_out=calib.acts["stem.out"],
                   mids=tuple(calib.block_mid(i) for i in range(n)),
                   outs=tuple(calib.block_out(i) for i in range(n)),
                   bits_w=cfg.bw_w)

    @classmethod
    def static_default(cls, cfg) -> "QuantRecipe":
        """The legacy fixed grid (``A_SPEC`` everywhere) — QAT without a
        calibration pass, matching ``models.resnet.forward``'s grids."""
        n = 3 * cfg.blocks_per_stage
        return cls(x_spec=R.X_SPEC, stem_out=R.A_SPEC,
                   mids=(R.A_SPEC,) * n, outs=(R.A_SPEC,) * n,
                   bits_w=cfg.bw_w)


def _dynamic_exp(w, bits: int):
    """The pow2 exponent covering ``max |w|`` for a signed ``bits`` grid,
    a detached float32 tensor (the grid is data, not a differentiable
    parameter)."""
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.clamp_min(torch.max(torch.abs(w.detach())), 1e-12)
    return torch.ceil(torch.log2(amax / qmax))


def fake_quant_weight(w, bits: int = 8):
    """Dynamic pow2 fake-quant for weights: the exponent tracks ``max |w|``
    each step, the round/clip applies the STE."""
    e = _dynamic_exp(w, bits)
    scale = 2.0 ** e
    q = Q.ste_round_clip(w / scale, -(2.0 ** (bits - 1)),
                         2.0 ** (bits - 1) - 1)
    return q * scale


def _fq_product_grid(x, exp):
    """Round ``x`` onto the int32 accumulator grid ``2**exp`` with STE — the
    QAT model of the integer path's skip alignment (a shift into conv1's
    product domain): rounding only, int32 bounds never bind in practice."""
    scale = 2.0 ** exp
    q = Q.ste_round_clip(x / scale, -(2.0 ** 31), 2.0 ** 31 - 1)
    return q * scale


def qat_forward(params, cfg, recipe: QuantRecipe, images, train: bool = False):
    """The QAT float path on calibrated per-tensor grids: BN live (float),
    weights dynamically fake-quantized, every activation fake-quantized onto
    its site's grid.  Mirrors ``models.resnet.forward`` (which runs the fixed
    ``A_SPEC`` grid) — same residual structure, the skip entering conv1 as an
    accumulator-init addend."""
    fqw = lambda w: fake_quant_weight(w, recipe.bits_w)
    x = Q.fake_quant(images, recipe.x_spec)
    h = R._bn(R._conv(x, fqw(params["stem"]["w"]), params["stem"]["b"]),
              params["stem"]["bn"], train)
    h = Q.fake_quant(torch.relu(h), recipe.stem_out)
    for i, (blk, stride) in enumerate(zip(params["blocks"],
                                          R.block_strides(cfg))):
        skip = h
        y = R._bn(R._conv(h, fqw(blk["conv0"]["w"]), blk["conv0"]["b"],
                          stride), blk["conv0"]["bn"], train)
        y = Q.fake_quant(torch.relu(y), recipe.mids[i])
        if "ds" in blk:
            skip = R._bn(R._conv(h, fqw(blk["ds"]["w"]), blk["ds"]["b"],
                                 stride), blk["ds"]["bn"], train)
            # the integer path keeps the ds output in the int32 product
            # domain and only shift-aligns it into conv1's accumulator —
            # model that as a rounding onto conv1's (dynamic) product grid,
            # the same treatment compile.backends.FloatBackend applies
            e1 = _dynamic_exp(blk["conv1"]["w"], recipe.bits_w) \
                + recipe.mids[i].exp
            skip = _fq_product_grid(skip, e1)
        z = R._bn(R._conv(y, fqw(blk["conv1"]["w"]), blk["conv1"]["b"], 1),
                  blk["conv1"]["bn"], train)
        h = Q.fake_quant(torch.relu(z + skip), recipe.outs[i])
    pooled = torch.mean(h, dim=(1, 2))
    return pooled @ fqw(params["fc"]["w"]) + params["fc"]["b"]


def qat_loss(params, cfg, recipe: QuantRecipe, batch, train: bool = True):
    logits = qat_forward(params, cfg, recipe, batch["images"], train=train)
    return R.cross_entropy(logits, batch["labels"])


def fine_tune(cfg, params, recipe: QuantRecipe, pipeline, steps: int,
              lr: float = 0.01, momentum: float = 0.9,
              weight_decay: float = 1e-4, warmup: int = 0,
              ckpt_dir: Optional[str] = None, log=print):
    """QAT fine-tuning through the fault-tolerant ``repro_torch.train``
    loop, on the device of ``params``.

    Returns ``(params, metrics)`` — the fine-tuned float params (re-export
    with ``export.export_qparams`` afterwards) and the last step's metrics.
    ``pipeline`` is any ``next()``-yielding data pipeline with checkpointable
    ``state`` (e.g. ``data.synthetic.SyntheticCifar``)."""
    if steps <= 0:
        return params, {}
    opt = opt_lib.sgdm(lr=lr, momentum=momentum, weight_decay=weight_decay,
                       total_steps=steps, warmup=warmup)
    opt_state = opt.init(params)
    train_step = make_train_step(
        lambda p, b: qat_loss(p, cfg, recipe, b), opt,
        params["stem"]["w"].device)
    params, _, metrics = loop_run(
        LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                   log_every=max(1, steps // 5)),
        params=params, opt_state=opt_state, train_step=train_step,
        pipeline=pipeline, log=log)
    return params, metrics
