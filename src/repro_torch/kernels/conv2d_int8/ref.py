"""Plain PyTorch versions of the general int8 conv.

  * :func:`conv2d_int8_ref` — the oracle on *pre-padded* input, a copy of
    the JAX package's: VALID conv, then bias and skip added to the int32
    accumulator, optional ReLU, then, when ``out_shift`` is given, the
    rounding shift ``(acc + half) >> s`` (only for ``s > 0``) and a clip
    to u8 (``relu``) or s8.
  * :func:`conv2d_int8_plain` — the plain version of the kernel: the JAX
    wrapper's pad ``((f-1)//2, f-1-(f-1)//2)`` on each spatial dim at every
    stride (not ``lax`` SAME, which pads (0, 1) for a 3x3 conv at stride 2
    on an even size), then :func:`conv2d_int8_ref`.

The conv is a float64 ``F.conv2d``: every product and partial sum is an
integer far below 2^53, so no order of summation rounds.  The sum is
brought to int32 through int64, so it wraps as an int32 sum would; the
bias, skip and rounding adds are int32 and wrap too.
"""
import torch
import torch.nn.functional as F


def conv2d_int8_ref(x, w, b, skip=None, *, stride=1, relu=False,
                    out_shift=None):
    """x: (N,Hp,Wp,C) int8/uint8 already padded; w: (fh,fw,C,O) int8; b:
    (O,) integer; skip: optional (N,OH,OW,O) int32.  Returns the int32 map,
    or u8 (``relu``) / s8 when ``out_shift`` is given."""
    acc = F.conv2d(x.to(torch.float64).permute(0, 3, 1, 2),
                   w.to(torch.float64).permute(3, 2, 0, 1), stride=stride)
    acc = torch.round(acc).to(torch.int64).to(torch.int32)
    acc = acc.permute(0, 2, 3, 1) + b.to(torch.int32)
    if skip is not None:
        acc = acc + skip.to(torch.int32)
    if relu:
        acc = torch.clamp_min(acc, 0)
    if out_shift is None:
        return acc.contiguous()
    if out_shift > 0:
        acc = (acc + (1 << (out_shift - 1))) >> out_shift
    if relu:
        return torch.clamp(acc, 0, 255).to(torch.uint8).contiguous()
    return torch.clamp(acc, -128, 127).to(torch.int8).contiguous()


def conv_pad(f: int):
    """``(lo, hi)`` zero pad of one spatial dim for a filter of size ``f``,
    as the JAX wrapper ``conv2d_int8_op`` applies it at every stride."""
    return (f - 1) // 2, f - 1 - (f - 1) // 2


def conv2d_int8_plain(x, w, b, skip=None, *, stride=1, relu=False,
                      out_shift=None):
    """x: (N,H,W,C) int8/uint8 unpadded; the rest as
    :func:`conv2d_int8_ref`.  Output (N, (H-1)//stride+1, (W-1)//stride+1,
    O)."""
    (pt, pb), (pl, pr) = conv_pad(w.shape[0]), conv_pad(w.shape[1])
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).permute(0, 2, 3, 1)
    return conv2d_int8_ref(xp, w, b, skip, stride=stride, relu=relu,
                           out_shift=out_shift)
