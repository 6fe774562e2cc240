"""Plain reference of the paper's integer ResNet (CIFAR-10 ResNet8 / ResNet20).

Written from the paper's description (§III-A, §IV) and He et al.'s CIFAR
ResNet, in plain PyTorch, with nothing taken from the program under test:

* BN folding: ``w' = w * g / sqrt(v + eps)``, ``b' = (b - m) * g /
  sqrt(v + eps) + beta``, in float32.
* Power-of-two quantization: weights int8 (or ``bw_w`` bits) at the
  smallest exponent that covers ``max |w|``, biases int16 at ``s_x + s_w``,
  the input image u8 at ``x_exp``, every feature map u8 at ``a_exp``.  An
  integer is ``clip(round_half_away(x * 2^-s))``.
* The integer forward: int32 accumulators (here exact integers held in
  float64, whose 53-bit mantissa holds every sum these widths produce),
  ReLU then a rounding right shift ``floor(acc / 2^s + 1/2)`` onto the
  feature grid, the residual add folded into conv1's accumulator (the
  skip stream aligned onto conv1's product grid), a 1x1 downsample on
  stage entries, and SAME padding as TensorFlow / JAX define it (a 3x3
  conv at stride 2 on an even map pads (0, 1)).
* The head: the dequantized last map averaged over its positions, times
  the dequantized classifier weights, plus the float bias, in float64.

``prepare`` quantizes once; ``logits`` runs the integer forward on any
device.  ``bits`` overrides the configuration's widths: the control runs
the same network with 4-bit weights (W4A8), the step below int8; a second
control computes the float head in float16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-5


def _round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _qrange(bits, signed):
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def quantize(x, bits, signed, exp):
    """Stored integers of ``x`` on the grid ``2^exp`` (float64 tensor)."""
    lo, hi = _qrange(bits, signed)
    q = _round_half_away(x.to(torch.float32) * (2.0 ** (-exp)))
    return torch.clamp(q, lo, hi).to(torch.float64)


def weight_exp(w, bits):
    """Smallest exponent whose signed ``bits``-bit grid covers max |w|."""
    amax = max(float(torch.abs(w.to(torch.float32)).max()), 1e-12)
    return int(math.ceil(math.log2(amax / (2 ** (bits - 1) - 1))))


def fold(c):
    bn = c["bn"]
    inv = bn["gamma"] / torch.sqrt(bn["var"] + EPS)
    return c["w"] * inv, (c["b"] - bn["mean"]) * inv + bn["beta"]


def block_strides(cfg):
    return [2 if (stage > 0 and i == 0) else 1
            for stage in range(cfg["stages"])
            for i in range(cfg["blocks_per_stage"])]


def _qconv(c, x_exp, bw_w, bw_b):
    w, b = fold(c)
    w_exp = weight_exp(w, bw_w)
    return dict(w=quantize(w, bw_w, True, w_exp), w_exp=w_exp,
                b=quantize(b, bw_b, True, x_exp + w_exp), x_exp=x_exp)


def prepare(params, cfg, bits=None):
    """The quantized network from the float parameters (HWIO conv weights,
    per-channel biases, a ``bn`` dict per conv; the classifier ``fc``).
    ``bits`` (``{"bw_w": 4}``) replaces widths of ``cfg``."""
    bw = dict(bw_w=cfg["bw_w"], bw_x=cfg["bw_x"], bw_b=cfg["bw_b"])
    bw.update(bits or {})
    a_exp = cfg["a_exp"]

    def qc(c, x_exp):
        return _qconv(c, x_exp, bw["bw_w"], bw["bw_b"])

    net = dict(bits=bw, x_exp=cfg["x_exp"], a_exp=a_exp,
               stem=qc(params["stem"], cfg["x_exp"]), blocks=[])
    for blk, stride in zip(params["blocks"], block_strides(cfg)):
        qb = dict(stride=stride, conv0=qc(blk["conv0"], a_exp),
                  conv1=qc(blk["conv1"], a_exp))
        if "ds" in blk:
            qb["ds"] = qc(blk["ds"], a_exp)
        net["blocks"].append(qb)
    fc_w = params["fc"]["w"]
    fc_exp = weight_exp(fc_w, bw["bw_w"])
    net["fc"] = dict(w=quantize(fc_w, bw["bw_w"], True, fc_exp), w_exp=fc_exp,
                     b=params["fc"]["b"].to(torch.float64))
    return net


def _same(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, c, stride):
    """SAME conv of NHWC ``x`` by ``c["w"]`` (HWIO) plus ``c["b"]``: on the
    integers, the exact int32 accumulator at the product grid ``x_exp +
    w_exp``."""
    w = c["w"]
    ph, pw = _same(x.shape[1], w.shape[0], stride), \
        _same(x.shape[2], w.shape[1], stride)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pw + ph),
                 w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + c["b"]


def _shift(acc, s):
    """``acc * 2^s`` for ``s >= 0``; else the rounding right shift
    ``floor(acc / 2^-s + 1/2)``."""
    if s >= 0:
        return acc * (2.0 ** s)
    return torch.floor(acc * (2.0 ** s) + 0.5)


def _relu_requant(acc, from_exp, to_exp, bits):
    q = _shift(torch.clamp_min(acc, 0), from_exp - to_exp)
    return torch.clamp(q, 0, 2 ** bits - 1)


def features(net, images):
    """The last u8 feature map (as float64 integers) of float images."""
    a, bits = net["a_exp"], net["bits"]["bw_x"]
    h = quantize(images, bits, False, net["x_exp"])
    st = net["stem"]
    h = _relu_requant(conv(h, st, 1), st["x_exp"] + st["w_exp"], a, bits)
    for qb in net["blocks"]:
        c0, c1 = qb["conv0"], qb["conv1"]
        y = _relu_requant(conv(h, c0, qb["stride"]), a + c0["w_exp"], a, bits)
        e1 = a + c1["w_exp"]
        if "ds" in qb:
            ds = qb["ds"]
            skip = _shift(conv(h, ds, qb["stride"]), a + ds["w_exp"] - e1)
        else:
            skip = _shift(h, a - e1)
        h = _relu_requant(conv(y, c1, 1) + skip, e1, a, bits)
    return h


def head(net, h, dtype=torch.float64):
    """Logits of the last u8 map ``h``: the dequantized map averaged over
    its positions, times the dequantized classifier weights, plus the float
    bias, in ``dtype``."""
    pooled = (h * (2.0 ** net["a_exp"])).to(dtype).mean(dim=(1, 2))
    fc = net["fc"]
    return pooled @ (fc["w"] * (2.0 ** fc["w_exp"])).to(dtype) \
        + fc["b"].to(dtype)


def logits(net, images, dtype=torch.float64):
    """Logits of float32 images ``(n, img, img, 3)``, the head in ``dtype``
    (float64; the control's ``float16`` head is the step below the
    program's float32)."""
    return head(net, features(net, images), dtype)


def to(net, device):
    """The prepared network with every tensor on ``device``."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        if isinstance(v, list):
            return [move(x) for x in v]
        return v
    return move(net)
