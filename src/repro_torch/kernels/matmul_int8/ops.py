"""Public wrapper of the int8 matmul kernel (``csrc/matmul_int8.cu``).

A CPU tensor goes to the plain version (``ref.matmul_int8_ref``); a CUDA
tensor launches the kernel, or the call raises.  ``acc_init`` may be any
view (the LM prologue passes the bias broadcast over the rows, a stride-0
``expand``): the wrapper makes it contiguous before the launch.  Any K is
taken; a K or N that is not a multiple of 4 runs the kernel's byte-wise
staging path.  ``matmul_int8_op.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernel's output tile (kBM x kBN in csrc/matmul_int8.cu)
TILE_M, TILE_N, TILE_K = 128, 128, 64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_int8")
    lib.matmul_int8_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.matmul_int8_launch.restype = _I
    return lib


def _check(a, b, acc_init, config):
    if config is not None:
        raise ValueError(
            f"config={config!r}: the CUDA kernel's tiles are fixed "
            f"({TILE_M}x{TILE_N}x{TILE_K}); kernel tuning is not available "
            f"in repro_torch yet, pass config=None")
    if a.dtype != torch.int8 or a.dim() != 2:
        raise ValueError(f"a must be (M,K) int8, got {tuple(a.shape)} "
                         f"{a.dtype}")
    if b.dtype != torch.int8 or b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"b must be ({a.shape[1]},N) int8, got "
                         f"{tuple(b.shape)} {b.dtype}")
    shape = (a.shape[0], b.shape[1])
    if acc_init is not None and (acc_init.dtype != torch.int32 or
                                 tuple(acc_init.shape) != shape):
        raise ValueError(f"acc_init must be {shape} int32, got "
                         f"{tuple(acc_init.shape)} {acc_init.dtype}")
    devs = {t.device for t in (a, b, acc_init) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")


def matmul_int8_op(a: torch.Tensor, b: torch.Tensor,
                   acc_init: torch.Tensor = None, config=None) -> torch.Tensor:
    """a: (M,K) int8 row-major; b: (K,N) int8 row-major (``(din, dout)``,
    as ``QMatmulParams.wq`` stores it); acc_init: optional (M,N) int32.
    Returns (M,N) int32 = a @ b (+ acc_init), exact."""
    _check(a, b, acc_init, config)
    if a.device.type == "cpu":
        return matmul_int8_ref(a, b, acc_init)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_int8_op: unsupported device {a.device}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"matmul_int8_op: {name} must be contiguous")
    if acc_init is not None:
        acc_init = acc_init.contiguous()
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.matmul_int8_launch(
            a.data_ptr(), b.data_ptr(),
            acc_init.data_ptr() if acc_init is not None else None,
            out.data_ptr(), M, N, K, stream)
    _build.check(lib, err, "matmul_int8 launch")
    matmul_int8_op.launches += 1
    return out


matmul_int8_op.launches = 0
