"""Float ResNet weights and the image pool, made on the device from a seed.

Everything comes from one ``torch.Generator`` on the device, in a few large
draws: the pool of images (uniform in [0, 1), as CIFAR-10 pixels scaled to
one), the conv filters (He-normal, HWIO), the conv and classifier biases,
and BN's gamma and beta.  BN's running mean and variance are then set from
a calibration batch, the first images of the pool, as the paper calibrates
BN after folding (§III-A), so that each feature map keeps a trained
network's range on the u8 grid rather than saturating or vanishing.  The
layout is the one ``repro_torch.models.resnet.fold_params`` takes.
"""
from __future__ import annotations

import contextlib
import math

import torch

from bench import work
from bench.reference import resnet as ref

SEED_MASK = 2 ** 63 - 1


@contextlib.contextmanager
def exact_float():
    """float32 convolutions and products without TF32, on deterministic
    cuDNN algorithms, for the duration of the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


def image_pool(cfg, n: int, gen: torch.Generator) -> torch.Tensor:
    img = cfg["img"]
    return torch.rand((n, img, img, cfg["in_channels"]), generator=gen,
                      device=gen.device, dtype=torch.float32)


def draw_params(cfg, gen: torch.Generator) -> dict:
    """Float parameters with identity BN statistics (set by
    :func:`calibrate`)."""
    dev = gen.device
    layout = work.convs(cfg)
    sizes = [k.fh * k.fw * k.ich * k.och for k in layout]
    chans = sum(k.och for k in layout)
    ncls, width = cfg["num_classes"], layout[-1].och
    filt = torch.randn(sum(sizes), generator=gen, device=dev)
    per_ch = torch.rand((3, chans), generator=gen, device=dev)
    fc = torch.randn(width * ncls + ncls, generator=gen, device=dev)
    convs, o, c = [], 0, 0
    for k, n in zip(layout, sizes):
        oc = k.och
        w = filt[o:o + n].view(k.fh, k.fw, k.ich, oc) \
            * math.sqrt(2.0 / (k.fh * k.fw * k.ich))
        convs.append(dict(
            w=w, b=(per_ch[0, c:c + oc] - 0.5) * 0.2,
            bn=dict(gamma=0.5 + per_ch[1, c:c + oc],
                    beta=(per_ch[2, c:c + oc] - 0.5) * 0.4,
                    mean=torch.zeros(oc, device=dev),
                    var=torch.ones(oc, device=dev))))
        o, c = o + n, c + oc
    params = dict(stem=convs[0], blocks=[],
                  fc=dict(w=fc[:width * ncls].view(width, ncls)
                          / math.sqrt(width),
                          b=fc[width * ncls:] * 0.1))
    for k, conv in zip(layout[1:], convs[1:]):
        if k.name == "conv0":
            params["blocks"].append({})
        params["blocks"][-1][k.name] = conv
    return params


@torch.no_grad()
def calibrate(params, cfg, images) -> dict:
    """Set every BN's mean and variance from the batch ``images`` through
    the float network (each BN normalising with the statistics it just
    set), in place; returns ``params``."""
    def bn(c, pre):
        m = pre.mean(dim=(0, 1, 2))
        v = pre.var(dim=(0, 1, 2), correction=0)
        c["bn"]["mean"], c["bn"]["var"] = m, v
        p = c["bn"]
        return (pre - m) * torch.rsqrt(v + ref.EPS) * p["gamma"] + p["beta"]

    with exact_float():
        st = params["stem"]
        h = torch.relu(bn(st, ref.conv(images, st, 1)))
        strides = [k.stride for k in work.convs(cfg) if k.name == "conv0"]
        for blk, stride in zip(params["blocks"], strides):
            c0, c1 = blk["conv0"], blk["conv1"]
            y = torch.relu(bn(c0, ref.conv(h, c0, stride)))
            skip = h
            if "ds" in blk:
                ds = blk["ds"]
                skip = bn(ds, ref.conv(h, ds, stride))
            h = torch.relu(bn(c1, ref.conv(y, c1, 1)) + skip)
    return params


def make(cfg, mix, seed: int, device):
    """``(params, pool)``: the seeded float parameters, BN calibrated on the
    pool's first ``mix["calib_images"]`` images, and the pool of
    ``mix["pool_images"]`` float32 images, all on ``device``."""
    gen = generator(seed, device)
    pool = image_pool(cfg, mix["pool_images"], gen)
    params = draw_params(cfg, gen)
    calibrate(params, cfg, pool[:mix["calib_images"]])
    return params, pool
