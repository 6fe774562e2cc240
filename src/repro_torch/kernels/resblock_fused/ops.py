"""Public wrapper of the fused residual block kernel
(``csrc/resblock_fused.cu``).

A CPU tensor goes to the plain version (``ref.resblock_ref``); a CUDA
tensor launches the kernel, or the call raises.  The shifts, static
arguments of the JAX kernel, are runtime arguments here and are
range-checked.  ``resblock_fused_op.launches`` counts kernel launches.

The kernel reads its filters and biases as one packed block
(:func:`pack_block`: the mma B-fragment order of ``csrc/block_body.cuh``).
:class:`ResblockLaunch` validates and packs the operands once, so that a
lowered forward (``compile/backends.py``) only allocates the output and
launches; :func:`resblock_fused_op` does both for a direct call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.dataflow import packed_block_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.common import (check_bias, check_shift,
                                        check_weight, sm_count, sm_ids_ptr)
from repro_torch.kernels.resblock_fused.ref import resblock_ref
from repro_torch.tune.space import block_band_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_CH = 128    # kMaxK in csrc/block_body.cuh: the deepest unrolled product


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("resblock_fused")
    lib.resblock_fused_launch.argtypes = [_P] * 3 + [_I] * 11 + [_P] * 2
    lib.resblock_fused_launch.restype = _I
    lib.resblock_fused_smem_bytes.argtypes = [_I] * 7
    lib.resblock_fused_smem_bytes.restype = _I
    lib.resblock_packed_bytes.argtypes = [_I] * 3
    lib.resblock_packed_bytes.restype = _I
    return lib


def smem_bytes(h, w, cin, cout, stride, has_ds, band) -> int:
    """Dynamic shared memory one thread block of the kernel uses when it
    takes ``band`` output rows (``tune.space.block_band_rows``)."""
    return _lib().resblock_fused_smem_bytes(h, w, cin, cout, stride,
                                            int(has_ds), band)


def packed_bytes(cin, cout, has_ds) -> int:
    """The kernel's own size of a packed block (``resblock_packed_bytes``;
    ``core.dataflow.packed_block_bytes`` is the same formula)."""
    return _lib().resblock_packed_bytes(cin, cout, int(has_ds))


def _r16(v: int) -> int:
    return (v + 15) // 16 * 16


def pack_conv(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``(fh, fw, cin, cout)`` int8 -> uint8 bytes in the order the
    kernels' ``mma_taps`` reads B fragments: ``[tap][kp / ks][np / 16]``
    then 32 lanes, lane ``4g + t`` holding for n8 tiles ``nt`` = 0, 1 and k
    halves ``j`` < ks / 16 the 4 bytes of k = ``16 j + 4 t .. + 3`` of
    output channel ``16 np + 8 nt + g``.  ``kp``, ``np``: cin, cout rounded
    up to 16 with zeros; ``ks`` = 32 when kp is a multiple of 32, else 16."""
    fh, fw, cin, cout = w.shape
    taps, kp, np_ = fh * fw, _r16(cin), _r16(cout)
    ks = 16 if kp % 32 else 32
    wp = torch.zeros((taps, kp, np_), dtype=torch.int8, device=w.device)
    wp[:, :cin, :cout] = w.reshape(taps, cin, cout)
    # k = kt*ks + j*16 + t*4 + b ; co = np*16 + nt*8 + g
    wp = wp.reshape(taps, kp // ks, ks // 16, 4, 4, np_ // 16, 2, 8)
    return wp.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(-1).view(torch.uint8)


def _pack_bias(b, cout, device) -> torch.Tensor:
    out = torch.zeros(_r16(cout), dtype=torch.int32, device=device)
    if b is not None:
        out[:cout] = b
    return out.view(torch.uint8)


def pack_block(w0, b0, w1, b1, wd=None, bd=None) -> torch.Tensor:
    """One residual block's operands as the packed block the kernels read
    (``csrc/block_body.cuh``), one part a conv phase: b0 | w0 || b1 | bd |
    w1 | wd, biases int32 with cout rounded up to 16 (bd zero without a
    downsample), filters in :func:`pack_conv`'s order.  uint8, contiguous,
    on w0's device."""
    cout = w0.shape[3]
    parts = [_pack_bias(b0, cout, w0.device), pack_conv(w0)] + \
        [_pack_bias(b, cout, w0.device) for b in (b1, bd)] + [pack_conv(w1)]
    if wd is not None:
        parts.append(pack_conv(wd))
    out = torch.cat(parts)
    assert out.numel() == packed_block_bytes(w0.shape[2], cout, wd is not None)
    return out


def _check_block(cin, w0, b0, w1, b1, wd, bd, stride, shift0, shift1,
                 skip_shift):
    """Validate one block's operands for an input of ``cin`` channels;
    returns cout."""
    if w0.dim() != 4:
        raise ValueError(f"w0 must be (3,3,{cin},Cout), got "
                         f"{tuple(w0.shape)}")
    cout = w0.shape[3]
    check_weight("w0", w0, (3, 3, cin, cout))
    check_weight("w1", w1, (3, 3, cout, cout))
    check_bias("b0", b0, cout)
    check_bias("b1", b1, cout)
    if (wd is None) != (bd is None):
        raise ValueError("pass wd and bd together (fused downsample) or "
                         "neither (identity skip)")
    if wd is not None:
        check_weight("wd", wd, (1, 1, cin, cout))
        check_bias("bd", bd, cout)
    elif stride != 1 or cin != cout:
        raise ValueError(f"identity skip needs stride 1 and Cin == Cout, "
                         f"got stride {stride}, {cin} -> {cout}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    for name, s in (("shift0", shift0), ("shift1", shift1),
                    ("skip_shift", skip_shift)):
        check_shift(name, s)
    operands = [t for t in (w0, b0, w1, b1, wd, bd) if t is not None]
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devices))}")
    return cout


class ResblockLaunch:
    """One residual block prepared for repeated launches: the operands
    validated, the biases widened to int32 and (on a GPU) the block packed
    once.  A call takes ``x`` (N,H,W,Cin) uint8 and returns (N,oh,ow,Cout)
    uint8: on a CPU tensor the plain version, on a CUDA tensor one kernel
    launch at the band height :func:`~repro_torch.tune.space.block_band_rows`
    picks for N and the card's SM count (looked up once per N and map
    height).  The per-call path checks only x's dtype, channels and
    layout."""

    def __init__(self, w0, b0, w1, b1, wd=None, bd=None, *, cin=None,
                 stride=1, shift0, shift1, skip_shift=0):
        cin = w0.shape[2] if cin is None else cin
        self.cout = _check_block(cin, w0, b0, w1, b1, wd, bd, stride,
                                 shift0, shift1, skip_shift)
        self.cin, self.stride, self.has_ds = cin, stride, wd is not None
        self.shifts = (shift0, shift1, skip_shift)
        b0, b1 = b0.to(torch.int32), b1.to(torch.int32)
        bd = bd.to(torch.int32) if self.has_ds else None
        self.plain = (w0, b0, w1, b1, wd, bd)
        self.device = w0.device
        self.packed = None
        self._bands = {}
        if self.device.type == "cuda":
            if cin % 4 or self.cout % 4 or max(cin, self.cout) > MAX_CH:
                raise ValueError(f"resblock_fused kernel needs channel counts "
                                 f"that are multiples of 4 and at most "
                                 f"{MAX_CH}, got {cin} -> {self.cout}")
            self.packed = pack_block(w0, b0, w1, b1, wd, bd)
        elif self.device.type != "cpu":
            raise ValueError(f"resblock_fused_op: unsupported device "
                             f"{self.device}")

    def band_rows(self, n: int, oh: int) -> int:
        """Output rows one thread block takes in a launch on n images of
        ``oh``-row output maps."""
        key = (n, oh)
        if key not in self._bands:
            self._bands[key] = block_band_rows(oh, n,
                                               sm_count(self.device.index))
        return self._bands[key]

    def thread_blocks(self, n: int, oh: int) -> int:
        """Thread blocks of a launch on n images of ``oh``-row outputs."""
        return n * -(-oh // self.band_rows(n, oh))

    def __call__(self, x, sm_ids=None):
        """``sm_ids``: optional int32 tensor of :meth:`thread_blocks`
        elements that the launch fills with the SM each thread block ran
        on (image major)."""
        s0, s1, sk = self.shifts
        if x.device.type == "cpu" and self.device.type == "cpu":
            return resblock_ref(x, *self.plain, stride=self.stride,
                                shift0=s0, shift1=s1, skip_shift=sk)
        if x.device != self.device:
            raise ValueError(f"operands on different devices: x on "
                             f"{x.device}, weights on {self.device}")
        if x.dtype != torch.uint8 or x.dim() != 4 or \
                x.shape[3] != self.cin or not x.is_contiguous() or \
                x.data_ptr() % 4:
            raise ValueError(f"resblock_fused_op: x must be contiguous "
                             f"(N,H,W,{self.cin}) uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device.index != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return self(x, sm_ids)
        N, H, W, _ = x.shape
        oh, ow = (H, W) if self.stride == 1 else (H // 2, W // 2)
        out = torch.empty((N, oh, ow, self.cout), dtype=torch.uint8,
                          device=x.device)
        if out.numel() == 0:
            return out
        band = self._bands.get((N, oh)) or self.band_rows(N, oh)
        ids = sm_ids_ptr(sm_ids, N * -(-oh // band), x.device)
        lib = _lib()
        err = lib.resblock_fused_launch(
            x.data_ptr(), self.packed.data_ptr(), out.data_ptr(), N, H, W,
            self.cin, self.cout, self.stride, int(self.has_ds), s0, s1, sk,
            band, ids, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "resblock_fused launch")
        resblock_fused_op.launches += 1
        return out


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
    launch = ResblockLaunch(w0, b0, w1, b1, wd, bd, cin=Cin, stride=stride,
                            shift0=shift0, shift1=shift1,
                            skip_shift=skip_shift)
    if stride == 2 and (H % 2 or W % 2):
        raise ValueError(f"stride-2 block needs even H/W to match SAME "
                         f"padding (0, 1), got {H}x{W}")
    return launch(x)


resblock_fused_op.launches = 0
