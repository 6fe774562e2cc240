"""Public wrapper of the causal conv kernel (``csrc/causal_conv1d.cu``).

The ``mamba1`` block's conv task in one launch: the int8 causal depthwise
conv of u over the sequence (int32, positions before the first read as 0),
the requantize onto the conv's int8 grid (``Q.requantize_shift``'s
rounding shift and clamp), then a 256-entry table from that code to the
consumer's code (SiLU on the next matmul's grid; the table is built at
lower time, ``compile.backends.conv_silu_table``).  The kernel replaces no
TPU kernel: it replaces the plain chain's ~25 PyTorch elementwise kernels.
Its bound is bytes: at (4, 512, 8192) it reads and writes 16.8 MB each,
10 us at 3.35 TB/s.  A thread takes 16 channels (one 16-byte access a row)
over 4 positions and slides the 4-row window in registers; the design is
in the source's note.

A CPU tensor goes to the plain version (:func:`causal_conv1d_ref`); a CUDA
tensor launches the kernel, or the call raises.  ``causal_conv1d_op
.launches`` counts kernel launches, ``.launches_by_path`` the same split by
instance: ``"vector"`` (16-byte accesses: every pointer 16-byte aligned and
the channel count and strides multiples of 16) or ``"bytewise"``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_shift

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MAX_TAPS = 4            # kTaps in csrc/causal_conv1d.cu: the window it holds
PATHS = ("vector", "bytewise")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("causal_conv1d")
    lib.causal_conv1d_launch.argtypes = [_P] * 5 + [_I] * 3 + [_L] * 2 + \
        [_I] * 3 + [_P]
    lib.causal_conv1d_launch.restype = _I
    return lib


def causal_conv1d_ref(x, wq, bq, shift, table):
    """The plain version: ``compile.backends.causal_conv_i32``, then
    ``Q.requantize_shift`` onto int8 by ``shift``, then the table."""
    from repro_torch.compile import backends

    acc = backends.causal_conv_i32(x, wq, bq)
    c = Q.requantize_shift(acc, 0, Q.QSpec(bits=8, signed=True, exp=shift))
    return table[c.to(torch.int64) + 128]


def _check(x, wq, bq, shift, table):
    want = dict(x=torch.int8, wq=torch.int8, bq=torch.int32,
                table=torch.int8)
    ops = dict(x=x, wq=wq, bq=bq, table=table)
    for name, t in ops.items():
        if t.dtype != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {t.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B,S,C), got {tuple(x.shape)}")
    C = x.shape[2]
    if wq.dim() != 2 or wq.shape[1] != C or not 1 <= wq.shape[0] <= MAX_TAPS:
        raise ValueError(f"wq must be (K,{C}) with 1 <= K <= {MAX_TAPS}, "
                         f"got {tuple(wq.shape)}")
    if tuple(bq.shape) != (C,):
        raise ValueError(f"bq must be ({C},), got {tuple(bq.shape)}")
    if tuple(table.shape) != (256,):
        raise ValueError(f"table must be (256,), got {tuple(table.shape)}")
    check_shift("shift", shift)
    devs = {t.device for t in ops.values()}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devs))}")


def causal_conv1d_op(x, wq, bq, shift, table):
    """x: (B,S,C) int8, unit stride over channels (a column slice of a
    wider row is read in place); wq: (K,C) int8 taps, K <= 4; bq: (C,)
    int32 at the product domain; shift: ``y_spec.exp - product_exp``;
    table: (256,) int8, the code for each requantized code + 128.
    Returns (B,S,C) int8, contiguous."""
    _check(x, wq, bq, shift, table)
    if x.device.type == "cpu":
        return causal_conv1d_ref(x, wq, bq, shift, table)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d_op: unsupported device {x.device}")
    if x.stride(2) != 1:
        raise ValueError("causal_conv1d_op: x must have unit channel stride")
    for name, t in dict(wq=wq, bq=bq, table=table).items():
        if not t.is_contiguous():
            raise ValueError(f"causal_conv1d_op: {name} must be contiguous")
    B, S, C = x.shape
    out = torch.empty((B, S, C), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    sb, ss = x.stride(0), x.stride(1)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, wq, bq, out)) and \
        C % 16 == 0 and sb % 16 == 0 and ss % 16 == 0
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.causal_conv1d_launch(
            x.data_ptr(), wq.data_ptr(), bq.data_ptr(), table.data_ptr(),
            out.data_ptr(), B, S, C, sb, ss, wq.shape[0], shift, int(vec),
            stream)
    _build.check(lib, err, "causal_conv1d launch")
    causal_conv1d_op.launches += 1
    causal_conv1d_op.launches_by_path["vector" if vec else "bytewise"] += 1
    return out


causal_conv1d_op.launches = 0
causal_conv1d_op.launches_by_path = dict.fromkeys(PATHS, 0)
