"""Public wrapper of the fused residual block kernel
(``csrc/resblock_fused.cu``).

A CPU tensor goes to the plain version (``ref.resblock_ref``); a CUDA
tensor launches the kernel, or the call raises.  The shifts, static
arguments of the JAX kernel, are runtime arguments here and are
range-checked.  ``resblock_fused_op.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_bias, check_shift, check_weight
from repro_torch.kernels.resblock_fused.ref import resblock_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("resblock_fused")
    lib.resblock_fused_launch.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.resblock_fused_launch.restype = _I
    lib.resblock_fused_smem_bytes.argtypes = [_I] * 6
    lib.resblock_fused_smem_bytes.restype = _I
    return lib


def smem_bytes(h, w, cin, cout, stride, has_ds) -> int:
    """Dynamic shared memory one thread block of the kernel uses."""
    return _lib().resblock_fused_smem_bytes(h, w, cin, cout, stride,
                                            int(has_ds))


def resblock_fused_op(x, w0, b0, w1, b1, wd=None, bd=None, *, stride=1,
                      shift0, shift1, skip_shift=0):
    """x: (N,H,W,Cin) uint8 (unpadded; SAME padding is the kernel's: (1,1)
    at stride 1, (0,1) at stride 2).  w0: (3,3,Cin,Cout), w1:
    (3,3,Cout,Cout) int8; b0/b1: (Cout,) int16/int32.  Pass wd:
    (1,1,Cin,Cout) int8 and bd: (Cout,) to fuse the 1x1 downsample on the
    skip path.  Returns (N,oh,ow,Cout) uint8."""
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    N, H, W, Cin = x.shape
    if w0.dim() != 4:
        raise ValueError(f"w0 must be (3,3,{Cin},Cout), got "
                         f"{tuple(w0.shape)}")
    Cout = w0.shape[3]
    check_weight("w0", w0, (3, 3, Cin, Cout))
    check_weight("w1", w1, (3, 3, Cout, Cout))
    check_bias("b0", b0, Cout)
    check_bias("b1", b1, Cout)
    if (wd is None) != (bd is None):
        raise ValueError("pass wd and bd together (fused downsample) or "
                         "neither (identity skip)")
    has_ds = wd is not None
    if has_ds:
        check_weight("wd", wd, (1, 1, Cin, Cout))
        check_bias("bd", bd, Cout)
    elif stride != 1 or Cin != Cout:
        raise ValueError(f"identity skip needs stride 1 and Cin == Cout, "
                         f"got stride {stride}, {Cin} -> {Cout}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if stride == 2 and (H % 2 or W % 2):
        raise ValueError(f"stride-2 block needs even H/W to match SAME "
                         f"padding (0, 1), got {H}x{W}")
    for name, s in (("shift0", shift0), ("shift1", shift1),
                    ("skip_shift", skip_shift)):
        check_shift(name, s)
    operands = [("x", x), ("w0", w0), ("b0", b0), ("w1", w1), ("b1", b1)]
    if has_ds:
        operands += [("wd", wd), ("bd", bd)]
    devices = {t.device for _, t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devices))}")
    b0, b1 = b0.to(torch.int32), b1.to(torch.int32)
    bd = bd.to(torch.int32) if has_ds else None

    if x.device.type == "cpu":
        return resblock_ref(x, w0, b0, w1, b1, wd, bd, stride=stride,
                            shift0=shift0, shift1=shift1,
                            skip_shift=skip_shift)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_fused_op: unsupported device {x.device}")
    if Cin % 4 or Cout % 4:
        raise ValueError(f"resblock_fused kernel needs channel counts that "
                         f"are multiples of 4, got {Cin} -> {Cout}")
    widened = dict(b0=b0, b1=b1, bd=bd)
    for name, t in operands:
        t = widened.get(name, t)
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"resblock_fused_op: {name} must be contiguous "
                             f"and 4-byte aligned")
    oh, ow = (H, W) if stride == 1 else (H // 2, W // 2)
    out = torch.empty((N, oh, ow, Cout), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.resblock_fused_launch(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), wd.data_ptr() if has_ds else None,
            bd.data_ptr() if has_ds else None, out.data_ptr(), N, H, W, Cin,
            Cout, stride, shift0, shift1, skip_shift, stream)
    _build.check(lib, err, "resblock_fused launch")
    resblock_fused_op.launches += 1
    return out


resblock_fused_op.launches = 0
