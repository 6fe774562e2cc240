"""ResNet8 / ResNet20 for CIFAR-10 — the paper's own networks (§IV).

The port of ``repro.models.resnet``: the configs, the activation grids,
random initialization, the float path (``forward``, ``loss_fn``,
``calibrate_bn``, ``folded_float_forward``), BN folding and the integer
quantization of the folded weights.  Integer inference runs through
``repro_torch.compile``: ``int_forward`` (the ``torch-int`` reference
backend) and ``cuda_forward`` (the ``cuda`` kernel backend) are thin
wrappers over it.

The float path is the QAT path of the paper (Brevitas-style): with
``cfg.quant == "qat"`` weights and activations are fake-quantized onto the
fixed pow2 grids with the STE gradient, BN runs in float.  Its convolutions
are ``F.conv2d`` (cuDNN on the GPU), as the JAX package computes them with
``lax.conv_general_dilated`` outside any Pallas kernel; its BN is written
out (batch statistics in training, the running ones otherwise; only
``calibrate_bn`` writes those), not ``nn.BatchNorm2d``.

Parameter dicts keep the JAX package's layout and keys: conv weights
``(fh, fw, ich, och)`` (HWIO), per-channel biases, and a ``bn`` dict per conv
until ``fold_params`` drops it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.core.quant import QSpec
from repro_torch.kernels.common import same_pad


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
    w = torch.randn((fh, fw, ic, oc), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w * math.sqrt(2.0 / (fh * fw * ic))


def _bn_init(oc, device):
    return dict(gamma=torch.ones(oc, device=device),
                beta=torch.zeros(oc, device=device),
                mean=torch.zeros(oc, device=device),
                var=torch.ones(oc, device=device))


def init_params(cfg: ResNetConfig, gen: torch.Generator) -> dict:
    """Random float parameters (He-normal convs, identity BN) drawn from
    ``gen``, on ``gen``'s device (a CPU generator draws the same numbers
    on every machine; ``params_to`` then places them)."""
    dev = gen.device

    def conv(fh, fw, ic, oc):
        return dict(w=_conv_init(gen, fh, fw, ic, oc),
                    b=torch.zeros(oc, device=dev), bn=_bn_init(oc, dev))

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
                       dtype=torch.float32, device=dev) / math.sqrt(ich)
    p["fc"] = dict(w=w_fc, b=torch.zeros(cfg.num_classes, device=dev))
    return p


def params_to(params, device) -> dict:
    """The parameter tree with every tensor on ``device``."""
    return T.tree_map(lambda t: t.to(device), params)


def float_params_from_numpy(d: dict, device) -> dict:
    """The float parameter tree (``init_params`` layout, ``bn`` dicts
    included) from any tree of arrays ``np.asarray`` accepts, e.g. the JAX
    package's ``init_params``, as float tensors on ``device``."""
    return T.tree_map(lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(device), d)


def float_params_to_numpy(p: dict) -> dict:
    """The float parameter tree as numpy arrays (host copies)."""
    return T.tree_map(lambda t: t.detach().cpu().numpy(), p)


# ---------------------------------------------------------------------------
# Float (QAT) path
# ---------------------------------------------------------------------------


def _fq_w(w, cfg):
    if cfg.quant != "qat":
        return w
    return Q.fake_quant(w, QSpec(cfg.bw_w, True, W_EXP))


def _fq_x(x, cfg, spec=A_SPEC):
    if cfg.quant != "qat":
        return x
    return Q.fake_quant(x, spec)


def _conv(x, w, b, stride=1):
    """SAME convolution of NHWC ``x`` with HWIO ``w``, plus ``b``: the
    (lo, hi) padding of ``lax``'s SAME (``same_pad``: (0, 1) for a 3x3 at
    stride 2 on an even map), then a VALID ``F.conv2d`` on the NCHW / OIHW
    views."""
    ph = same_pad(x.shape[1], w.shape[0], stride)
    pw = same_pad(x.shape[2], w.shape[1], stride)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pw + ph),
                 w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + b


def _bn(x, bn, train, eps=1e-5):
    """Batch norm over (N, H, W): the batch's mean and population variance
    in training, the running ``mean`` / ``var`` otherwise."""
    if train:
        mu = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), correction=0)
    else:
        mu, var = bn["mean"], bn["var"]
    return (x - mu) * torch.rsqrt(var + eps) * bn["gamma"] + bn["beta"]


def forward(params, cfg: ResNetConfig, images, train=False):
    """images: (B, H, W, 3) float in [0, 1).  Returns logits (B, 10)."""
    x = _fq_x(images, cfg, X_SPEC)
    h = _bn(_conv(x, _fq_w(params["stem"]["w"], cfg), params["stem"]["b"]),
            params["stem"]["bn"], train)
    h = _fq_x(torch.relu(h), cfg)
    for blk, stride in zip(params["blocks"], block_strides(cfg)):
        skip = h
        y = _bn(_conv(h, _fq_w(blk["conv0"]["w"], cfg), blk["conv0"]["b"],
                      stride), blk["conv0"]["bn"], train)
        y = _fq_x(torch.relu(y), cfg)
        if "ds" in blk:
            skip = _bn(_conv(h, _fq_w(blk["ds"]["w"], cfg), blk["ds"]["b"],
                             stride), blk["ds"]["bn"], train)
            skip = _fq_x(skip, cfg, QSpec(8, True, A_SPEC.exp))
        # paper add-fold: the skip stream is the accumulator init of conv1
        z = _conv(y, _fq_w(blk["conv1"]["w"], cfg), blk["conv1"]["b"], 1)
        z = _bn(z, blk["conv1"]["bn"], train)
        h = _fq_x(torch.relu(z + skip), cfg)
    h = torch.mean(h, dim=(1, 2))
    return h @ _fq_w(params["fc"]["w"], cfg) + params["fc"]["b"]


def cross_entropy(logits, labels):
    """Mean negative log-likelihood of ``labels`` and the top-1 accuracy.
    The label's log-probability is taken by a one-hot product (a compare
    with ``arange``), not a gather, so its backward has no atomics and is
    deterministic on the GPU."""
    ll = F.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[:, None].long() == classes).to(ll.dtype)
    loss = -torch.mean(torch.sum(ll * onehot, dim=-1))
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, dict(loss=loss.detach(), acc=acc)


def loss_fn(params, cfg: ResNetConfig, batch, train=True):
    """``(loss, {"loss", "acc"})`` of a batch of tensors ``{"images",
    "labels"}``."""
    return cross_entropy(forward(params, cfg, batch["images"], train=train),
                         batch["labels"])


@torch.no_grad()
def calibrate_bn(params, cfg: ResNetConfig, images):
    """Write BN running stats from a calibration batch (paper §III-A: BN is
    folded into the quantized convs *then calibrated*).  Returns params
    with bn.mean / bn.var set so the train=False / folded graphs match
    training; ``params`` itself is left as it was."""
    p = T.tree_map(lambda x: x, params)   # new dicts, the same tensors

    def set_bn(bn, h):
        bn["mean"] = torch.mean(h, dim=(0, 1, 2))
        bn["var"] = torch.var(h, dim=(0, 1, 2), correction=0)

    x = _fq_x(images, cfg, X_SPEC)
    pre = _conv(x, _fq_w(p["stem"]["w"], cfg), p["stem"]["b"])
    set_bn(p["stem"]["bn"], pre)
    h = _fq_x(torch.relu(_bn(pre, p["stem"]["bn"], False)), cfg)
    for blk, stride in zip(p["blocks"], block_strides(cfg)):
        skip = h
        pre0 = _conv(h, _fq_w(blk["conv0"]["w"], cfg), blk["conv0"]["b"],
                     stride)
        set_bn(blk["conv0"]["bn"], pre0)
        y = _fq_x(torch.relu(_bn(pre0, blk["conv0"]["bn"], False)), cfg)
        if "ds" in blk:
            pred = _conv(h, _fq_w(blk["ds"]["w"], cfg), blk["ds"]["b"],
                         stride)
            set_bn(blk["ds"]["bn"], pred)
            skip = _fq_x(_bn(pred, blk["ds"]["bn"], False), cfg,
                         QSpec(8, True, A_SPEC.exp))
        pre1 = _conv(y, _fq_w(blk["conv1"]["w"], cfg), blk["conv1"]["b"], 1)
        set_bn(blk["conv1"]["bn"], pre1)
        z = _bn(pre1, blk["conv1"]["bn"], False)
        h = _fq_x(torch.relu(z + skip), cfg)
    return p


@torch.no_grad()
def folded_float_forward(folded, cfg: ResNetConfig, images, tap=None):
    """Float reference forward on BN-*folded* params — the graph the integer
    pipeline quantizes, run in float32 with no quantization at all.

    ``tap(site, tensor)`` (optional) is called at every activation site in
    graph order; ``repro_torch.quantize``'s calibration observers attach
    here.  Sites: ``"input"`` (the image batch), ``"stem.out"`` (post-ReLU
    stem output), ``"block{i}.mid"`` (block i's conv0 output post-ReLU),
    ``"block{i}.out"`` (block i's output post-add post-ReLU).

    Returns logits (B, num_classes)."""
    def see(site, h):
        if tap is not None:
            tap(site, h)
        return h

    x = see("input", images)
    h = see("stem.out", torch.relu(
        _conv(x, folded["stem"]["w"], folded["stem"]["b"])))
    for i, (blk, stride) in enumerate(zip(folded["blocks"],
                                          block_strides(cfg))):
        y = see(f"block{i}.mid", torch.relu(
            _conv(h, blk["conv0"]["w"], blk["conv0"]["b"], stride)))
        if "ds" in blk:
            skip = _conv(h, blk["ds"]["w"], blk["ds"]["b"], stride)
        else:
            skip = h
        z = _conv(y, blk["conv1"]["w"], blk["conv1"]["b"], 1) + skip
        h = see(f"block{i}.out", torch.relu(z))
    pooled = torch.mean(h, dim=(1, 2))
    return pooled @ folded["fc"]["w"] + folded["fc"]["b"]


# ---------------------------------------------------------------------------
# BN folding + integer quantization
# ---------------------------------------------------------------------------


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


def block_shifts(qb) -> dict:
    """Fixed-grid pow2 shifts of one quantized block (a ``quantize_params``
    block dict), in the kernels' semantics: ``shift0`` / ``shift1``
    requantize conv0's / conv1's product domain (s_x + s_w) back to
    ``A_SPEC`` (positive = rounding right shift); ``skip_shift`` aligns the
    skip stream into conv1's product domain (>= 0 left shift, < 0 rounding
    right shift), the arithmetic of ``int_forward``.  For per-tensor
    params use ``QBlockParams.shifts_for``."""
    e0 = qb["conv0"]["x_spec"].exp + qb["conv0"]["w_spec"].exp
    e1 = qb["conv1"]["x_spec"].exp + qb["conv1"]["w_spec"].exp
    out = dict(shift0=A_SPEC.exp - e0, shift1=A_SPEC.exp - e1)
    if "ds" in qb:
        eds = qb["ds"]["x_spec"].exp + qb["ds"]["w_spec"].exp
        out["skip_shift"] = eds - e1
    else:
        out["skip_shift"] = A_SPEC.exp - e1
    return out
