"""Shared integer arithmetic of the kernels' plain versions.

``requant_u8`` is the epilogue of every integer conv kernel (its CUDA twin
is ``repro::requant_u8`` in ``csrc/common.cuh``); ``conv_i32`` is the exact
integer convolution the plain versions and the ``torch-int`` backend build
on.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# shifts are runtime kernel arguments; outside this range a 32-bit shift is
# undefined in C++ and meaningless for an int32 accumulator
SHIFT_MIN, SHIFT_MAX = -31, 31


def check_shift(name: str, shift) -> int:
    if not isinstance(shift, int) or isinstance(shift, bool) or \
            not SHIFT_MIN <= shift <= SHIFT_MAX:
        raise ValueError(
            f"{name}={shift!r}: expected an int in [{SHIFT_MIN}, {SHIFT_MAX}]")
    return shift


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: what one wave of
    the block kernels' thread blocks is sized to."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_ids_ptr(sm_ids, blocks: int, device):
    """Pointer of the optional per-thread-block SM record of a block kernel
    launch: None, or a contiguous int32 tensor of ``blocks`` elements on
    ``device`` that the launch fills with the SM each thread block ran
    on."""
    if sm_ids is None:
        return None
    if sm_ids.dtype != torch.int32 or sm_ids.numel() != blocks or \
            sm_ids.device != device or not sm_ids.is_contiguous():
        raise ValueError(f"sm_ids must be a contiguous int32 tensor of "
                         f"{blocks} on {device}, got {tuple(sm_ids.shape)} "
                         f"{sm_ids.dtype} on {sm_ids.device}")
    return sm_ids.data_ptr()


def check_weight(name: str, t: torch.Tensor, shape) -> None:
    """A filter operand: int8 of exactly ``shape``."""
    if t.dtype != torch.int8 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} int8, got "
                         f"{tuple(t.shape)} {t.dtype}")


def check_bias(name: str, t: torch.Tensor, cout: int) -> None:
    """A bias operand: ``(cout,)`` int16 or int32 (widened by the
    wrappers to the int32 accumulator)."""
    if t.dtype not in (torch.int16, torch.int32) or tuple(t.shape) != (cout,):
        raise ValueError(f"{name} must be ({cout},) int16/int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def requant_u8(acc: torch.Tensor, shift: int):
    """int32 product-domain accumulator -> u8 activation domain: ReLU, then
    a pow2 shift (positive = rounding right shift ``(acc + half) >> s``,
    negative = left shift), then clip to [0, 255]."""
    acc = torch.clamp_min(acc, 0)
    if shift > 0:
        acc = (acc + (1 << (shift - 1))) >> shift
    elif shift < 0:
        acc = acc << (-shift)
    return torch.clamp(acc, 0, 255).to(torch.uint8)


def same_pad(size: int, k: int, stride: int):
    """``(lo, hi)`` padding of one spatial dim as ``jax.lax``'s SAME computes
    it: a 3x3 conv pads (1, 1) at stride 1 but (0, 1) at stride 2 on an
    even size; a 1x1 conv pads nothing."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_i32(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """SAME convolution of integer NHWC ``x`` with integer HWIO ``w``,
    exact in int32.  Computed in float64: every product and partial sum is
    an integer below 2^53, so no order of summation rounds."""
    fh, fw = w.shape[0], w.shape[1]
    ph = same_pad(x.shape[1], fh, stride)
    pw = same_pad(x.shape[2], fw, stride)
    xf = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), pw + ph)
    acc = F.conv2d(xf, w.to(torch.float64).permute(3, 2, 0, 1),
                   stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()
