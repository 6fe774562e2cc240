"""Public wrapper of the general int8 conv kernel (``csrc/conv2d_int8.cu``),
in the JAX wrapper's layout: NHWC input, HWIO filter.

A CPU tensor goes to the plain version (``ref.conv2d_int8_plain``); a CUDA
tensor launches the kernel, or the call raises.  The zero pad is the JAX
wrapper's ``((f-1)//2, f-1-(f-1)//2)`` at every stride, applied inside the
kernel (a zero ring in shared memory, or bounds checks), so nothing is
copied.  ``conv2d_int8_op.launches``
counts kernel launches, ``conv2d_int8_op.launches_by_path`` the same split
by the path :func:`conv_path` picks from the shape: ``"mma"`` (an implicit
GEMM on the int8 tensor cores) or ``"general"`` (dp4a or bytes on the CUDA
cores).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.dataflow import pixel_pitch
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_bias, check_shift, sm_count
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_plain
from repro_torch.tune.space import SMEM_BUDGET, block_band_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
# output dtype codes of the C entry point
_OUT_I32, _OUT_U8, _OUT_S8 = 0, 1, 2
PATHS = ("mma", "general")
_PATH_CODE = {"general": 0, "mma": 1}
# the mma path's filters and depth (C at most 128: one to four m16n8k32
# steps a tap)
MMA_FILTERS = ((3, 3), (1, 1))
MMA_MAX_C = 128
MMA_WARPS = 8             # warps of an mma thread block (256 threads)
FILTER_SLICE = 4608       # filter bytes one mma thread block stages at most


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d_int8")
    lib.conv2d_int8_launch.argtypes = [_P] * 5 + [_I] * 15 + [_P]
    lib.conv2d_int8_launch.restype = _I
    lib.conv2d_int8_mma_smem_bytes.argtypes = [_I] * 7
    lib.conv2d_int8_mma_smem_bytes.restype = _I
    return lib


def out_hw(h: int, w: int, stride: int):
    """Output height and width: the padded size ``h + f - 1`` less the
    filter, over the stride, plus one, whatever the filter size."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def conv_tiles(oh: int, ow: int, n: int, c: int, o: int, fh: int, fw: int,
               sms: int):
    """``(band, ng)`` of the mma path: each thread block takes ``band``
    output rows of one image and ``ng`` of its output channels.

    ``ng``: the most channels (a multiple of 16 dividing O rounded up to
    16) whose filter slice stays within ``FILTER_SLICE`` bytes, at least 16:
    every thread block stages its slice from L2, so ResNet20's 3x3
    64-channel conv splits four ways, its 1x1 convs not at all.
    ``band``: the tallest bands that give each image's channel groups at
    least ``sms // (n * groups)`` thread blocks (``tune.space.
    block_band_rows``), and no more than one 16-pixel x 16-channel warp
    item a warp.  On an H100's 132 SMs at batch 32, 128 or 256 thread
    blocks for each of ResNet20's layers."""
    np16 = -(-o // 16) * 16
    ng = max([g for g in range(16, np16 + 1, 16)
              if np16 % g == 0 and fh * fw * c * g <= FILTER_SLICE] or [16])
    groups = np16 // ng
    band = block_band_rows(oh, n * groups, sms)
    cap = max(1, (MMA_WARPS // (ng // 16)) * 16 // ow)
    return min(band, cap), ng


def mma_smem_bytes(w: int, c: int, ng: int, fh: int, fw: int, stride: int,
                   band: int) -> int:
    """Dynamic shared memory of one mma thread block (``mma_layout`` in
    ``csrc/conv2d_int8.cu``): the bias and the filter slice of ``ng``
    output channels, then the input rows of a band, ``(band - 1) * stride
    + fh`` rows of the padded width ``w + fw - 1``, ``pixel_pitch(c)``
    bytes a pixel."""
    return 4 * ng + fh * fw * c * ng + \
        ((band - 1) * stride + fh) * (w + fw - 1) * pixel_pitch(c)


def conv_path(x_shape, w_shape, stride: int, sms: int,
              aligned: bool = True) -> str:
    """Which kernel path takes an (N, H, W, C) input with an (fh, fw, C, O)
    filter: ``"mma"`` where C is a multiple of 16 up to 128, O a multiple
    of 8, the filter 3x3 or 1x1, the operands aligned for the tensor-core
    path's loads (x 16 bytes, w 4, skip 8) and a thread block's tile
    (:func:`conv_tiles`) fits in shared memory; else ``"general"``."""
    n, h, w, c = x_shape
    fh, fw, _, o = w_shape
    if not (aligned and c % 16 == 0 and 0 < c <= MMA_MAX_C and o % 8 == 0
            and o > 0 and (fh, fw) in MMA_FILTERS):
        return "general"
    oh, ow = out_hw(h, w, stride)
    band, ng = conv_tiles(oh, ow, n, c, o, fh, fw, sms)
    return "mma" if mma_smem_bytes(w, c, ng, fh, fw, stride, band) <= \
        SMEM_BUDGET else "general"


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
    sms = sm_count(x.device.index)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 4 == 0 and \
        (skip is None or skip.data_ptr() % 8 == 0)
    path = conv_path(x.shape, w.shape, stride, sms, aligned)
    band, ng = conv_tiles(shape[1], shape[2], N, C, O, fh, fw, sms) \
        if path == "mma" else (0, 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv2d_int8_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            skip.data_ptr() if skip is not None else None, out.data_ptr(),
            N, H, W, C, fh, fw, O, stride, int(x.dtype == torch.uint8),
            int(relu), 0 if out_shift is None else out_shift, code, band,
            ng, _PATH_CODE[path], stream)
    _build.check(lib, err, "conv2d_int8 launch")
    conv2d_int8_op.launches += 1
    conv2d_int8_op.launches_by_path[path] += 1
    return out


conv2d_int8_op.launches = 0
conv2d_int8_op.launches_by_path = dict.fromkeys(PATHS, 0)
