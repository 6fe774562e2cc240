"""Public wrapper of the selective-scan kernel (``csrc/selective_scan.cu``).

A CPU tensor goes to the plain version (``ref.selective_scan_ref``); a
CUDA tensor launches the kernel, or the call raises.  The softplus of dt,
the D term and the gating stay outside, as in the JAX package.
``selective_scan_op.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_STATE = 16          # kMaxState in csrc/selective_scan.cu
LANES = 4               # lanes a channel (kLanes)
CHANNELS = 32           # channels a thread block (kChannels)


def scan_threads(B: int, di: int) -> int:
    """Threads one launch runs: a block of ``LANES * CHANNELS`` for every
    ``CHANNELS`` channels of every batch row."""
    return B * -(-di // CHANNELS) * CHANNELS * LANES


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    lib.selective_scan_launch.argtypes = [_P] * 8 + [_I] * 4 + [_P]
    lib.selective_scan_launch.restype = _I
    return lib


def _check(u, dt, A, Bc, Cc, h0, config):
    if config is not None:
        raise ValueError(
            f"config={config!r}: the CUDA kernel has no tiling knob yet "
            f"(four lanes a channel); pass config=None")
    ops = dict(u=u, dt=dt, A=A, Bc=Bc, Cc=Cc, h0=h0)
    for name, t in ops.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if u.dim() != 3:
        raise ValueError(f"u must be (B,S,di), got {tuple(u.shape)}")
    B, S, di = u.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be ({di},N), got {tuple(A.shape)}")
    N = A.shape[1]
    want = dict(dt=(B, S, di), Bc=(B, S, N), Cc=(B, S, N), h0=(B, di, N))
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(ops[name].shape)}")
    devs = {t.device for t in ops.values()}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devs))}")


def selective_scan_op(u, dt, A, Bc, Cc, h0, config=None):
    """u, dt: (B,S,di) float32 (dt after softplus); A: (di,N); Bc, Cc:
    (B,S,N); h0: (B,di,N).  Returns (y: (B,S,di), h_last: (B,di,N))."""
    _check(u, dt, A, Bc, Cc, h0, config)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, A, Bc, Cc, h0)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_op: unsupported device {u.device}")
    B, S, di = u.shape
    N = A.shape[1]
    if N > MAX_STATE:
        raise ValueError(f"selective_scan_op: state size {N} exceeds "
                         f"{MAX_STATE}")
    for name, t in dict(u=u, dt=dt, A=A, Bc=Bc, Cc=Cc, h0=h0).items():
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_op: {name} must be contiguous")
    if u.numel() == 0 or N == 0:
        # nothing to scan: y_t is an empty sum, the state stays h0
        return torch.zeros_like(u), h0.clone()
    y = torch.empty_like(u)
    h_last = torch.empty_like(h0)
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.selective_scan_launch(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, S, di, N, stream)
    _build.check(lib, err, "selective_scan launch")
    selective_scan_op.launches += 1
    return y, h_last


selective_scan_op.launches = 0
