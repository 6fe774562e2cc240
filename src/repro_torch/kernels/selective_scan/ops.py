"""Public wrapper of the selective-scan kernel (``csrc/selective_scan.cu``).

A CPU tensor goes to the plain version (``ref.selective_scan_ref``); a
CUDA tensor launches the kernel, or the call raises.  The softplus of dt,
the D term and the gating stay outside, as in the JAX package.
``selective_scan_op.launches`` counts kernel launches,
``selective_scan_op.launches_by_config`` the same by resolved knobs
(``"cout_block=<channels>,lanes=<lanes>"``).

Knobs (``config``, a ``tune.config.KernelConfig``): ``cout_block``, the
channels one thread block takes, and ``lanes``, the threads a channel; 0
is the rule (32 channels, 4 lanes).  The kernel is a template instantiated
at the pairs of :data:`SHAPES`; :func:`scan_knobs` is the one legality
check.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import config_knobs, count_config, knob_key
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_STATE = 16          # kMaxState in csrc/selective_scan.cu
CHUNK = 16              # steps staged at a time (kChunk)
LANES = 4               # the rule's lanes a channel
CHANNELS = 32           # the rule's channels a thread block
STATIC_SMEM = 48 * 1024  # static shared memory a thread block may take
KNOBS = ("cout_block", "lanes")


def scan_smem_bytes(channels: int, lanes: int) -> int:
    """Static shared memory of one thread block of ``channels`` channels
    on ``lanes`` lanes each (``ScanCfg::kSmem``): u and dt of two chunks,
    B and C of two chunks, the products of ``lanes`` steps (rows padded by
    4) and y of one chunk."""
    return 4 * (2 * 2 * CHUNK * channels + 2 * 2 * CHUNK * MAX_STATE +
                lanes * (channels * MAX_STATE + 4) + CHUNK * channels)


# the instantiated (channels, lanes) pairs (REPRO_SCAN_SHAPES): channels
# {16, 32, 64} x lanes {2, 4, 8}, but the pairs over the static shared
# memory limit ((64, 8): 57,472 bytes)
SHAPES = tuple((c, l) for c in (16, 32, 64) for l in (2, 4, 8)
               if scan_smem_bytes(c, l) <= STATIC_SMEM)


def scan_knobs(config=None):
    """``(channels, lanes)`` one thread block runs under ``config``:
    ``cout_block`` channels on ``lanes`` lanes each, 0 for the rule's 32
    and 4.  The one legality check of the knobs: raises ``ValueError``
    naming a knob the kernel does not have or a pair it is not
    instantiated at (:data:`SHAPES`)."""
    knobs = config_knobs("selective_scan", config, KNOBS)
    channels = knobs.get("cout_block", CHANNELS)
    lanes = knobs.get("lanes", LANES)
    if (channels, lanes) not in SHAPES:
        raise ValueError(
            f"selective_scan: cout_block={channels}, lanes={lanes}: the "
            f"kernel is instantiated at (cout_block, lanes) in {SHAPES} "
            f"(channels 16/32/64 x lanes 2/4/8 within {STATIC_SMEM} bytes "
            f"of static shared memory)")
    return channels, lanes


def scan_threads(B: int, di: int, channels: int = CHANNELS,
                 lanes: int = LANES) -> int:
    """Threads one launch runs: a block of ``lanes * channels`` for every
    ``channels`` channels of every batch row."""
    return B * -(-di // channels) * channels * lanes


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    lib.selective_scan_launch.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.selective_scan_launch.restype = _I
    lib.selective_scan_smem_bytes.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.selective_scan_smem_bytes.restype = _I
    return lib


def kernel_smem_bytes(channels: int, lanes: int) -> int:
    """The static shared memory of the ``(channels, lanes)`` instance as
    the compiler laid it out (needs a GPU); :func:`scan_smem_bytes` is
    the same without one."""
    lib = _lib()
    n = _I(0)
    _build.check(lib, lib.selective_scan_smem_bytes(channels, lanes,
                                                    ctypes.byref(n)),
                 "selective_scan shared memory")
    return n.value


def _check(u, dt, A, Bc, Cc, h0):
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
    (B,S,N); h0: (B,di,N); config: the knobs (:func:`scan_knobs`).
    Returns (y: (B,S,di), h_last: (B,di,N))."""
    _check(u, dt, A, Bc, Cc, h0)
    channels, lanes = scan_knobs(config)
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
            B, S, di, N, channels, lanes, stream)
    _build.check(lib, err, "selective_scan launch")
    selective_scan_op.launches += 1
    count_config(selective_scan_op, knob_key(cout_block=channels,
                                             lanes=lanes))
    return y, h_last


selective_scan_op.launches = 0
selective_scan_op.launches_by_config = {}
