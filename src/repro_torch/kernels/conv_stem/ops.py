"""Public wrapper of the stem conv kernel (``csrc/conv_stem.cu``).

A CPU tensor goes to the plain version (``ref.conv_stem_ref``); a CUDA
tensor launches the kernel, or the call raises.  ``conv_stem_op.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_shift
from repro_torch.kernels.conv_stem.ref import conv_stem_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_stem")
    lib.conv_stem_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _P]
    lib.conv_stem_launch.restype = _I
    return lib


def _check(x, w, b):
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[:2] != (3, 3) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"w must be (3,3,{x.shape[3]},Cout) int8, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if b.dtype not in (torch.int16, torch.int32) or \
            tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be ({w.shape[3]},) int16/int32, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"operands on different devices: x {x.device}, "
                         f"w {w.device}, b {b.device}")


def conv_stem_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 shift: int) -> torch.Tensor:
    """x: (N,H,W,Cin) uint8 (unpadded; the kernel applies the SAME (1,1)
    pad); w: (3,3,Cin,Cout) int8; b: (Cout,) int16 or int32, widened to the
    int32 accumulator.  Returns (N,H,W,Cout) uint8."""
    _check(x, w, b)
    check_shift("shift", shift)
    b = b.to(torch.int32)
    if x.device.type == "cpu":
        return conv_stem_ref(x, w, b, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stem_op: unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"conv_stem_op: {name} must be contiguous")
    N, H, W, Cin = x.shape
    Cout = w.shape[3]
    out = torch.empty((N, H, W, Cout), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_stem_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), N, H, W, Cin, Cout, shift,
                                   stream)
    _build.check(lib, err, "conv_stem launch")
    conv_stem_op.launches += 1
    return out


conv_stem_op.launches = 0
