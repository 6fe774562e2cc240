"""Public wrapper of the general int8 conv kernel (``csrc/conv2d_int8.cu``),
in the JAX wrapper's layout: NHWC input, HWIO filter.

A CPU tensor goes to the plain version (``ref.conv2d_int8_plain``); a CUDA
tensor launches the kernel, or the call raises.  The zero pad is the JAX
wrapper's ``((f-1)//2, f-1-(f-1)//2)`` at every stride; the kernel applies
it by bounds checks, so nothing is copied.  ``conv2d_int8_op.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_bias, check_shift
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
# output dtype codes of the C entry point
_OUT_I32, _OUT_U8, _OUT_S8 = 0, 1, 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d_int8")
    lib.conv2d_int8_launch.argtypes = [_P] * 5 + [_I] * 12 + [_P]
    lib.conv2d_int8_launch.restype = _I
    return lib


def out_hw(h: int, w: int, stride: int):
    """Output height and width: the padded size ``h + f - 1`` less the
    filter, over the stride, plus one, whatever the filter size."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _check(x, w, b, skip, stride, out_shift, config):
    if config is not None:
        raise ValueError(
            f"config={config!r}: the CUDA kernel has no tiling knobs; "
            f"kernel tuning is not available in repro_torch yet, pass "
            f"config=None")
    if x.dtype not in (torch.int8, torch.uint8) or x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C) int8/uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[2] != x.shape[3] \
            or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"w must be (fh,fw,{x.shape[3]},O) int8, got "
                         f"{tuple(w.shape)} {w.dtype}")
    check_bias("b", b, w.shape[3])
    if not isinstance(stride, int) or isinstance(stride, bool) or stride < 1:
        raise ValueError(f"stride={stride!r}: expected an int >= 1")
    if out_shift is not None:
        check_shift("out_shift", out_shift)
    N, H, W, _ = x.shape
    shape = (N, *out_hw(H, W, stride), w.shape[3])
    if skip is not None and (skip.dtype != torch.int32 or
                             tuple(skip.shape) != shape):
        raise ValueError(f"skip must be {shape} int32, got "
                         f"{tuple(skip.shape)} {skip.dtype}")
    devs = {t.device for t in (x, w, b, skip) if t is not None}
    if len(devs) != 1:
        raise ValueError(
            f"operands on different devices: {sorted(map(str, devs))}")
    return shape


def conv2d_int8_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   skip: torch.Tensor = None, *, stride: int = 1,
                   relu: bool = False, out_shift: int = None,
                   config=None) -> torch.Tensor:
    """x: (N,H,W,C) int8 or uint8, unpadded; w: (fh,fw,C,O) int8; b: (O,)
    int16/int32; skip: optional (N,OH,OW,O) int32, added to the int32
    accumulator.  Returns the int32 accumulator map when ``out_shift`` is
    None, else the map shifted by ``(acc + half) >> out_shift`` (only when
    ``out_shift > 0``: a negative shift leaves it as it is) and clipped to
    uint8 (``relu``) or int8."""
    shape = _check(x, w, b, skip, stride, out_shift, config)
    b = b.to(torch.int32)
    if x.device.type == "cpu":
        return conv2d_int8_plain(x, w, b, skip, stride=stride, relu=relu,
                                 out_shift=out_shift)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8_op: unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("b", b), ("skip", skip)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"conv2d_int8_op: {name} must be contiguous")
    if out_shift is None:
        code, dtype = _OUT_I32, torch.int32
    else:
        code, dtype = (_OUT_U8, torch.uint8) if relu else (_OUT_S8,
                                                           torch.int8)
    out = torch.empty(shape, dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    N, H, W, C = x.shape
    fh, fw, _, O = w.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv2d_int8_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            skip.data_ptr() if skip is not None else None, out.data_ptr(),
            N, H, W, C, fh, fw, O, stride, int(x.dtype == torch.uint8),
            int(relu), 0 if out_shift is None else out_shift, code, stream)
    _build.check(lib, err, "conv2d_int8 launch")
    conv2d_int8_op.launches += 1
    return out


conv2d_int8_op.launches = 0
