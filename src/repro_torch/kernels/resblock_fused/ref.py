"""Plain PyTorch version of the fused residual block: the unfused dataflow
conv0 -> relu/requant -> [1x1 ds conv ->] skip align -> conv1 + skip ->
relu/requant, every tensor materialized.  Takes the *unpadded* input with
``jax.lax`` SAME padding, so stride-2 blocks pad (0, 1).

:func:`resblock_banded` mirrors the CUDA kernel's row bands for the tests.
"""
import torch
import torch.nn.functional as F

from repro_torch.core.quant import shift_align
from repro_torch.kernels.common import conv_i32, requant_u8


def resblock_ref(x, w0, b0, w1, b1, wd=None, bd=None, *, stride=1,
                 shift0, shift1, skip_shift=0):
    """x: (N,H,W,Cin) uint8 unpadded; w0: (3,3,Cin,Cout), w1:
    (3,3,Cout,Cout), wd: (1,1,Cin,Cout) int8; b0/b1/bd: (Cout,) integer.
    Returns (N,oh,ow,Cout) uint8."""
    y0 = requant_u8(conv_i32(x, w0, stride) + b0.to(torch.int32), shift0)
    if wd is not None:
        skip = shift_align(conv_i32(x, wd, stride) + bd.to(torch.int32),
                           skip_shift)
    else:
        skip = shift_align(x, skip_shift)
    acc1 = conv_i32(y0, w1) + b1.to(torch.int32) + skip
    return requant_u8(acc1, shift1)


def conv_valid_i32(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """VALID convolution of integer NHWC ``x`` (already padded) with
    integer HWIO ``w``, exact in int32 (float64 arithmetic, as
    ``conv_i32``)."""
    acc = F.conv2d(x.to(torch.float64).permute(0, 3, 1, 2),
                   w.to(torch.float64).permute(3, 2, 0, 1), stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)


def rows_of(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of NHWC ``t``, zero where they fall outside it."""
    h = t.shape[1]
    body = t[:, max(lo, 0):min(hi, h)]
    return F.pad(body, (0, 0, 0, 0, max(-lo, 0), max(hi - h, 0)))


def resblock_banded(x, w0, b0, w1, b1, wd=None, bd=None, *, stride=1,
                    shift0, shift1, skip_shift=0, band):
    """The fused block computed band by band as ``csrc/resblock_fused.cu``
    decomposes it (tests only; the wrapper's plain version is
    :func:`resblock_ref`): each band of ``band`` output rows from its own
    slice of x — the padded rows ``(r0 - 1) * stride`` to ``(r0 + band) *
    stride + 2`` the kernel stages — y0 recomputed for the band plus one
    row either side (zero outside the map), then the skip and conv1."""
    from repro_torch.tune.space import block_band_input_rows, block_bands

    pad_lo = 1 if stride == 1 else 0
    xp = F.pad(x, (0, 0, pad_lo, 1, pad_lo, 1))   # SAME as jax.lax pads
    oh = (xp.shape[1] - 3) // stride + 1
    b0, b1 = b0.to(torch.int32), b1.to(torch.int32)
    outs = []
    for r0, nb in block_bands(oh, band):
        xs = rows_of(xp, *block_band_input_rows(r0, band, stride))
        # y0 rows r0 - 1 .. r0 + nb from the slice (y0 row y reads padded
        # rows y * stride .. + 2, i.e. slice rows (y - r0 + 1) * stride ..)
        y0 = requant_u8(conv_valid_i32(xs[:, :(nb + 1) * stride + 3], w0,
                                       stride) + b0, shift0)[:, :nb + 2]
        keep = [0 <= r0 - 1 + i < oh for i in range(nb + 2)]
        y0 = y0 * torch.tensor(keep, dtype=y0.dtype).view(1, -1, 1, 1)
        y0 = F.pad(y0, (0, 0, 1, 1))                       # the zero ring
        # the skip reads padded x at (pad_lo + o * stride): slice row
        # pad_lo + (o - r0 + 1) * stride
        xo = xs[:, pad_lo + stride:pad_lo + stride + nb * stride:stride,
                pad_lo:pad_lo + (xp.shape[2] - 3) // stride * stride + 1:
                stride]
        if wd is not None:
            skip = shift_align(conv_valid_i32(xo, wd) + bd.to(torch.int32),
                               skip_shift)
        else:
            skip = shift_align(xo, skip_shift)
        outs.append(requant_u8(conv_valid_i32(y0, w1) + b1 + skip, shift1))
    return torch.cat(outs, dim=1)
