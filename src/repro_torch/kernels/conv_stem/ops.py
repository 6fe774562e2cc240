"""Public wrapper of the stem conv kernel (``csrc/conv_stem.cu``).

A CPU tensor goes to the plain version (``ref.conv_stem_ref``); a CUDA
tensor launches the kernel, or the call raises.  ``conv_stem_op.launches``
counts kernel launches, ``conv_stem_op.launches_by_path`` the same split by
the path :func:`stem_path` picks from the shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_shift, sm_count
from repro_torch.kernels.conv_stem.ref import conv_stem_ref
from repro_torch.tune.space import SMEM_BUDGET, block_band_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
PATHS = ("banded", "general")
# the C entry point's path codes
_PATH_CODE = {"general": 0, "banded": 1}
BAND_THREADS = 256    # threads of a banded-path thread block
BLOCKS_PER_SM = 2     # thread blocks of the banded path an SM


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_stem")
    lib.conv_stem_launch.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_P]
    lib.conv_stem_launch.restype = _I
    lib.conv_stem_band_smem_bytes.argtypes = [_I] * 4
    lib.conv_stem_band_smem_bytes.restype = _I
    lib.conv_stem_empty_launch.argtypes = [_I, _I, _P]
    lib.conv_stem_empty_launch.restype = _I
    return lib


def stem_band_rows(h: int, n: int, sms: int) -> int:
    """Output rows one thread block of the banded path takes: the tallest
    bands that give each of the ``n`` images at least ``2 * sms // n`` of
    them, two thread blocks an SM (``tune.space.block_band_rows``).  On an
    H100's 132 SMs, a 32-row image gets bands of 4 rows at batch 32 (256
    thread blocks), of 1 at batches 1 and 8 and of 32 at batch 256."""
    return block_band_rows(h, n, BLOCKS_PER_SM * sms)


def band_smem_bytes(band: int, w: int, cin: int, cout: int) -> int:
    """Dynamic shared memory of one banded thread block (``band_layout`` in
    ``csrc/conv_stem.cu``): the bias, the filter as 9 x cout words, the
    plane of (band + 2) x (w + 2) words and the raw input rows (up to 15
    bytes of lead, rounded up to 16)."""
    raw_off = -(-(4 * cout + 36 * cout + (band + 2) * (w + 2) * 4) // 16) * 16
    return raw_off + ((band + 2) * w * cin + 30) // 16 * 16


def stem_path(shape, cout: int, sms: int) -> str:
    """Which kernel path takes an (N, H, W, Cin) image to ``cout``
    channels: ``"banded"`` for the RGB stem (Cin at most 4, ``cout`` a
    multiple of 16) where a band fits in shared memory, else
    ``"general"``."""
    n, h, w, cin = shape
    if not (1 <= cin <= 4 and cout % 16 == 0 and cout > 0):
        return "general"
    band = stem_band_rows(h, n, sms)
    return "banded" if band_smem_bytes(band, w, cin, cout) <= SMEM_BUDGET \
        else "general"


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
    sms = sm_count(x.device.index)
    path = stem_path(x.shape, Cout, sms)
    band = stem_band_rows(H, N, sms) if path == "banded" else 0
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_stem_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), N, H, W, Cin, Cout, shift,
                                   band, _PATH_CODE[path], stream)
    _build.check(lib, err, "conv_stem launch")
    conv_stem_op.launches += 1
    conv_stem_op.launches_by_path[path] += 1
    return out


conv_stem_op.launches = 0
conv_stem_op.launches_by_path = dict.fromkeys(PATHS, 0)


def empty_launch(blocks: int, threads: int, device) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` through the same
    library and call path as the stem: the floor its time is read
    against."""
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.conv_stem_empty_launch(
            blocks, threads, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "empty launch")
