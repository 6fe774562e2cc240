"""Work of one forward, counted from a configuration's widths alone.

Nothing here reads the program: the counts follow from the network's
shapes (3x3 SAME convolutions, a 1x1 downsample at each stage entry after
the first, stride 2 there), so they stay put whatever the kernels tile or
fuse.  ``conv_macs_per_image`` is the multiply-adds of every convolution
(the classifier's 640 are left out: it is no conv).  ``conv_bytes`` is
what a forward has to move at the least: the u8 input image, every int8
filter and int16 bias once, and the last u8 feature map.

The peaks are NVIDIA's data sheet for one H100 SXM (dense int8 on the
tensor cores, HBM3), at the full 700 W power limit.
"""
from __future__ import annotations

from typing import NamedTuple

PEAKS = {
    "H100": dict(int8_ops_per_s=1.979e15, hbm_bytes_per_s=3.35e12),
}


def peaks(device_kind: str):
    """The peak table entry whose key the device's name contains, or None."""
    for key, value in PEAKS.items():
        if key in device_kind:
            return value
    return None


class Conv(NamedTuple):
    name: str          # stem, conv0, conv1 or ds
    res: int           # output rows (and columns)
    fh: int
    fw: int
    ich: int
    och: int
    stride: int


def convs(cfg):
    """Every conv of the network in graph order: the stem, then conv0,
    conv1 and (at a stage entry) the 1x1 downsample of each block."""
    res, base = cfg["img"], cfg["base_width"]
    out = [Conv("stem", res, 3, 3, cfg["in_channels"], base, 1)]
    ich = base
    for stage in range(cfg["stages"]):
        och = base * 2 ** stage
        for bi in range(cfg["blocks_per_stage"]):
            stride = 2 if (stage > 0 and bi == 0) else 1
            res = -(-res // stride)
            out.append(Conv("conv0", res, 3, 3, ich, och, stride))
            out.append(Conv("conv1", res, 3, 3, och, och, 1))
            if stride != 1 or ich != och:
                out.append(Conv("ds", res, 1, 1, ich, och, stride))
            ich = och
    return out


def conv_macs_per_image(cfg) -> int:
    return sum(c.res * c.res * c.fh * c.fw * c.ich * c.och
               for c in convs(cfg))


def last_map(cfg):
    """``(res, channels)`` of the last feature map."""
    c = convs(cfg)[-1]
    return c.res, c.och


def weight_bytes(cfg) -> int:
    """int8 filters and int16 biases of every conv, once."""
    return sum(c.fh * c.fw * c.ich * c.och * cfg["bw_w"] // 8
               + c.och * cfg["bw_b"] // 8 for c in convs(cfg))


def conv_bytes(cfg, batch: int) -> int:
    """Least bytes a forward of ``batch`` images moves: the u8 images,
    the weights once, the last u8 map."""
    img = cfg["img"] * cfg["img"] * cfg["in_channels"] * cfg["bw_x"] // 8
    r, c = last_map(cfg)
    return batch * (img + r * r * c * cfg["bw_x"] // 8) + weight_bytes(cfg)


def conv_ops(cfg, batch: int) -> int:
    """Integer operations of a forward's convs: a multiply-add is two."""
    return 2 * conv_macs_per_image(cfg) * batch


def bound_s(cfg, batch: int, peak) -> float:
    """Least seconds the card could take for a forward's convs: the larger
    of operations over the int8 peak and bytes over HBM bandwidth."""
    return max(conv_ops(cfg, batch) / peak["int8_ops_per_s"],
               conv_bytes(cfg, batch) / peak["hbm_bytes_per_s"])
