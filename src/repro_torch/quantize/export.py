"""Export: calibrated grids + float params -> typed integer parameters.

The last stage of the PTQ/QAT flow: quantize the BN-folded float weights onto
the calibrated per-tensor grids and emit
:class:`repro.compile.params.QResNetParams` — the exact container
``compile_model`` lowers through every backend.  The paper's bit-width spec
is enforced here: int8 weights/activations, int16 biases at
``s_b = s_x + s_w`` (so the bias adds directly onto the int32 accumulator),
and all inter-domain rescales are shifts derived from the specs
(``QBlockParams.shifts_for``).

``validate_export`` closes the loop: the exported params are lowered through
the ``cuda``, ``cuda-stream`` and ``torch-int`` backends and the logits
compared bitwise — a calibration that produces shifts the kernels cannot
realize fails here, at export time, not in serving.

The exported tensors have the dtypes the kernels' wrappers take
(``kernels/common.py``: int8 weights, int16 biases) and a float32 classifier
bias, on the device of ``params``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import quant as Q
from repro_torch.core.quant import QSpec
from repro_torch.compile.params import (
    QBlockParams, QConvParams, QLinearParams, QResNetParams)
from repro_torch.models import resnet as R
from repro_torch.quantize.calibrate import CalibrationResult, _images


def _qconv(c: dict, cfg, w_exp: int, x_spec: QSpec) -> QConvParams:
    w_spec = QSpec(cfg.bw_w, True, w_exp)
    b_spec = Q.bias_spec(x_spec, w_spec, cfg.bw_b)
    return QConvParams(wq=Q.quantize(c["w"], w_spec),
                       bq=Q.quantize(c["b"], b_spec),
                       w_spec=w_spec, x_spec=x_spec, b_spec=b_spec)


def export_qparams(cfg, params, calib: CalibrationResult,
                   folded: Optional[dict] = None) -> QResNetParams:
    """Quantize float ``params`` onto the grids in ``calib`` and return the
    typed integer container.

    ``params`` are the float (trained / QAT-fine-tuned) parameters WITH BN;
    pass ``folded`` to reuse an existing ``fold_params`` result.  BN running
    stats must already be written (``calibrate(..., calibrate_bn=True)`` did
    this on the same params, or call ``models.resnet.calibrate_bn``)."""
    if calib.model != cfg.name:
        raise ValueError(
            f"calibration is for {calib.model!r}, exporting {cfg.name!r}")
    if folded is None:
        folded = R.fold_params(params)

    stem = _qconv(folded["stem"], cfg, calib.w_exps["stem"], calib.x_spec)
    blocks = []
    for i, blk in enumerate(folded["blocks"]):
        x_in = calib.block_in(i)
        conv0 = _qconv(blk["conv0"], cfg, calib.w_exps[f"block{i}.conv0"],
                       x_in)
        conv1 = _qconv(blk["conv1"], cfg, calib.w_exps[f"block{i}.conv1"],
                       calib.block_mid(i))
        ds = None
        if "ds" in blk:
            ds = _qconv(blk["ds"], cfg, calib.w_exps[f"block{i}.ds"], x_in)
        blocks.append(QBlockParams(conv0=conv0, conv1=conv1, ds=ds))

    head_in = calib.head_in(len(folded["blocks"]))
    fc_spec = QSpec(cfg.bw_w, True, calib.w_exps["fc"])
    fc = QLinearParams(wq=Q.quantize(folded["fc"]["w"], fc_spec),
                       b=folded["fc"]["b"].to(torch.float32),
                       w_spec=fc_spec, x_spec=head_in)
    return QResNetParams(stem=stem, blocks=tuple(blocks), fc=fc)


def ptq_quantize(cfg, params, batches, observer: str = "minmax",
                 **observer_kw):
    """The whole PTQ flow in one call: BN-calibrate on ``batches``,
    range-calibrate with ``observer``, export.  Returns
    ``(params_bn, calib, qparams)`` — ``params_bn`` carry the written BN
    stats and are what the float reference / QAT must use.  The CLI,
    examples quantize through here so the flow has one home."""
    from repro_torch.quantize.calibrate import calibrate

    imgs = torch.cat(_images(batches, params["stem"]["w"].device))
    params = R.calibrate_bn(params, cfg, imgs)
    calib = calibrate(cfg, params, batches, observer=observer,
                      calibrate_bn=False, **observer_kw)
    return params, calib, export_qparams(cfg, params, calib)


def validate_export(cfg, qparams, images,
                    backends: Sequence[str] = ("cuda", "cuda-stream",
                                               "torch-int"),
                    device=None) -> dict:
    """Lower the exported params through every backend in ``backends`` on
    ``device`` (default ``cuda``; ``"cpu"`` runs the kernels' plain
    versions) and compare logits pairwise.  Integer backends must agree
    *bit-exactly*; returns ``{"bit_exact": bool, "max_abs_dev": float}``
    (the deviation is across all pairs).  Raises ``ValueError`` on a
    bit-exactness failure so a broken export can never reach serving
    silently."""
    from repro_torch.compile import lower_forward

    outs = [lower_forward(cfg, qparams, b, device)(images) for b in backends]
    dev = 0.0
    for i in range(1, len(outs)):
        dev = max(dev, float(torch.max(torch.abs(outs[i] - outs[0]))))
    if dev != 0.0:
        raise ValueError(
            f"exported params are not bit-exact across {tuple(backends)}: "
            f"max |Δlogit| = {dev:g}")
    return dict(bit_exact=True, max_abs_dev=dev, backends=tuple(backends))
