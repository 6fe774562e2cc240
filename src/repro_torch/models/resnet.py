"""ResNet8 / ResNet20 for CIFAR-10 — the paper's own networks (§IV).

The port's share of ``repro.models.resnet``: the configs, the activation
grids, random initialization, BN folding and the integer quantization of the
folded weights.  Inference runs through ``repro_torch.compile``:
``int_forward`` (the ``torch-int`` reference backend) and ``cuda_forward``
(the ``cuda`` kernel backend) are thin wrappers over it.

Parameter dicts keep the JAX package's layout and keys: conv weights
``(fh, fw, ich, och)`` (HWIO), per-channel biases, and a ``bn`` dict per conv
until ``fold_params`` drops it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from repro_torch.core import quant as Q
from repro_torch.core.quant import QSpec


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    blocks_per_stage: int
    base_width: int = 16
    num_classes: int = 10
    img: int = 32
    bw_w: int = 8          # weight bits (paper)
    bw_x: int = 8          # activation bits
    bw_b: int = 16         # bias bits
    quant: str = "qat"     # qat | none
    residual_fusion: bool = True


def block_strides(cfg: ResNetConfig) -> List[int]:
    out = []
    for stage in range(3):
        for bi in range(cfg.blocks_per_stage):
            out.append(2 if (stage > 0 and bi == 0) else 1)
    return out


RESNET8 = ResNetConfig("resnet8", blocks_per_stage=1)
RESNET20 = ResNetConfig("resnet20", blocks_per_stage=3)

# static activation exponent grid: input images are u8 at 2^-7 (~[0, 2)),
# post-ReLU feature maps u8 at 2^-4 (range [0, 16))
X_SPEC = QSpec(8, signed=False, exp=-7)
A_SPEC = QSpec(8, signed=False, exp=-4)
W_EXP = -7


def _conv_init(gen: torch.Generator, fh, fw, ic, oc):
    w = torch.randn((fh, fw, ic, oc), generator=gen, dtype=torch.float32)
    return w * math.sqrt(2.0 / (fh * fw * ic))


def _bn_init(oc):
    return dict(gamma=torch.ones(oc), beta=torch.zeros(oc),
                mean=torch.zeros(oc), var=torch.ones(oc))


def init_params(cfg: ResNetConfig, gen: torch.Generator) -> dict:
    """Random float parameters (He-normal convs, identity BN) drawn from
    ``gen``, on ``gen``'s device."""
    def conv(fh, fw, ic, oc):
        return dict(w=_conv_init(gen, fh, fw, ic, oc), b=torch.zeros(oc),
                    bn=_bn_init(oc))

    p = dict(stem=conv(3, 3, 3, cfg.base_width))
    blocks = []
    ich = cfg.base_width
    for stage in range(3):
        och = cfg.base_width * (2 ** stage)
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if (stage > 0 and bi == 0) else 1
            blk = dict(conv0=conv(3, 3, ich, och), conv1=conv(3, 3, och, och))
            if stride != 1 or ich != och:
                blk["ds"] = conv(1, 1, ich, och)
            blocks.append(blk)
            ich = och
    p["blocks"] = blocks
    w_fc = torch.randn((ich, cfg.num_classes), generator=gen,
                       dtype=torch.float32) / math.sqrt(ich)
    p["fc"] = dict(w=w_fc, b=torch.zeros(cfg.num_classes))
    return p


def fold_params(params) -> dict:
    """Fold BN into conv weights/biases (paper §III-A), drop BN nodes."""
    def fold(c):
        bn = c["bn"]
        w, b = Q.fold_batchnorm(c["w"], c["b"], bn["gamma"], bn["beta"],
                                bn["mean"], bn["var"])
        return dict(w=w, b=b)

    out = dict(stem=fold(params["stem"]), fc=dict(params["fc"]), blocks=[])
    for blk in params["blocks"]:
        fb = dict(conv0=fold(blk["conv0"]), conv1=fold(blk["conv1"]))
        if "ds" in blk:
            fb["ds"] = fold(blk["ds"])
        out["blocks"].append(fb)
    return out


def quantize_params(folded, cfg: ResNetConfig) -> dict:
    """Float folded params -> integer weights/biases per the paper's spec:
    int8 weights (pow2 scale calibrated per conv on the folded weights),
    int16 biases at ``s_b = s_x + s_w``.  Returns the JAX package's
    ``quantize_params`` dict layout."""
    def qc(c, x_spec):
        w_exp = Q.calibrate_exp(c["w"], QSpec(cfg.bw_w, True, 0))
        w_spec = QSpec(cfg.bw_w, True, w_exp)
        b_spec = Q.bias_spec(x_spec, w_spec, cfg.bw_b)
        return dict(wq=Q.quantize(c["w"], w_spec),
                    bq=Q.quantize(c["b"], b_spec),
                    w_spec=w_spec, x_spec=x_spec, b_spec=b_spec)

    out = dict(stem=qc(folded["stem"], X_SPEC), blocks=[])
    for blk in folded["blocks"]:
        qb = dict(conv0=qc(blk["conv0"], A_SPEC),
                  conv1=qc(blk["conv1"], A_SPEC))
        if "ds" in blk:
            qb["ds"] = qc(blk["ds"], A_SPEC)
        out["blocks"].append(qb)
    fc_exp = Q.calibrate_exp(folded["fc"]["w"], QSpec(cfg.bw_w, True, 0))
    fc_spec = QSpec(cfg.bw_w, True, fc_exp)
    out["fc"] = dict(wq=Q.quantize(folded["fc"]["w"], fc_spec),
                     b=folded["fc"]["b"].to(torch.float32), w_spec=fc_spec)
    return out


def int_forward(qparams, cfg: ResNetConfig, images, device=None):
    """Pure-integer inference through the ``torch-int`` reference backend
    (float ops only in the pool + classifier head)."""
    from repro_torch.compile import lower_forward
    return lower_forward(cfg, qparams, "torch-int", device)(images)


def cuda_forward(qparams, cfg: ResNetConfig, images, device=None):
    """``int_forward`` through the hand-written kernels: ``conv_stem`` then
    one ``resblock_fused`` launch per residual block."""
    from repro_torch.compile import lower_forward
    return lower_forward(cfg, qparams, "cuda", device)(images)
