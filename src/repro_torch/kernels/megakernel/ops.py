"""Public wrapper of the block-chain kernel (``csrc/block_chain.cu``).

A CPU tensor goes to the plain version (``ref.block_chain_ref``); a CUDA
tensor launches the kernel, or the call raises.  The operand layout is the
JAX wrapper's: an unpadded input, one ``(w0, b0, w1, b1[, wd, bd])`` tuple
per chain link and a matching :class:`ChainBlockSpec` schedule.  The SAME
pad of the chain's first op is the kernel's, as is every later re-pad,
which happens on chip.  The shifts, static arguments of the JAX kernel,
are runtime arguments here and are range-checked.
``block_chain_op.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List

import torch

from repro_torch.core.dataflow import STEM_CIN, BlockShape
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_bias, check_shift, check_weight
from repro_torch.kernels.megakernel.ref import block_chain_ref
from repro_torch.tune.config import DEFAULT, KernelConfig

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_LINKS = 32          # kMaxLinks in csrc/block_chain.cu


@dataclasses.dataclass(frozen=True)
class ChainBlockSpec:
    """Static per-link schedule of one chain link (hashable).  Shapes come
    from the weight operands; only the dataflow decisions live here."""
    stride: int
    has_ds: bool
    shift0: int
    shift1: int
    skip_shift: int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("block_chain")
    ints, ptrs = ctypes.POINTER(_I), ctypes.POINTER(_P)
    lib.block_chain_launch.argtypes = [_P] * 4 + [_I] * 3 + [ints, ptrs] + \
        [_I] * 3 + [_P]
    lib.block_chain_launch.restype = _I
    lib.block_chain_smem_bytes.argtypes = [ints, _I, _I, _I, _I]
    lib.block_chain_smem_bytes.restype = _I
    return lib


def _link_ints(shapes: List[BlockShape], specs=None):
    rows = []
    for j, b in enumerate(shapes):
        s = specs[j] if specs is not None else None
        rows += [b.h, b.w, b.ich, b.och, b.stride, int(b.downsample),
                 s.shift0 if s else 0, s.shift1 if s else 0,
                 s.skip_shift if s else 0]
    return (_I * len(rows))(*rows)


def smem_bytes(shapes: List[BlockShape], batch_tile: int,
               stem_och: int = 0) -> int:
    """Dynamic shared memory one thread block of the kernel uses for a
    chain of ``shapes`` (the kernel's own ``block_chain_smem_bytes``; the
    planner's ``core.dataflow.chain_task_smem_bytes`` is the same
    formula)."""
    return _lib().block_chain_smem_bytes(
        _link_ints(shapes), len(shapes), STEM_CIN if stem_och else 0,
        stem_och, batch_tile)


def _check_chain(x, blocks, specs, stem, stem_shift) -> List[BlockShape]:
    """Validate the operands; returns the chain's link shapes."""
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not specs or len(blocks) != len(specs):
        raise ValueError(f"blocks/specs mismatch: {len(blocks)} operand "
                         f"tuples for {len(specs)} specs (need one per "
                         f"link, at least one link)")
    if (stem is None) != (stem_shift is None):
        raise ValueError("pass stem and stem_shift together (fused stem) "
                         "or neither")
    _, h, w, c = x.shape
    if stem is not None:
        sw, sb = stem
        if sw.dim() != 4:
            raise ValueError(f"stem w must be (3,3,{c},Cout), got "
                             f"{tuple(sw.shape)}")
        check_weight("stem w", sw, (3, 3, c, sw.shape[3]))
        check_bias("stem b", sb, sw.shape[3])
        check_shift("stem_shift", stem_shift)
        c = sw.shape[3]
    shapes = []
    for j, (s, ws) in enumerate(zip(specs, blocks)):
        want = 6 if s.has_ds else 4
        if len(ws) != want:
            raise ValueError(
                f"link {j}: has_ds={s.has_ds} takes {want} operands "
                f"(w0, b0, w1, b1{', wd, bd' if s.has_ds else ''}), got "
                f"{len(ws)}")
        if s.stride not in (1, 2):
            raise ValueError(f"link {j}: stride must be 1 or 2, got "
                             f"{s.stride}")
        if ws[0].dim() != 4:
            raise ValueError(f"link {j}: w0 must be (3,3,{c},Cout), got "
                             f"{tuple(ws[0].shape)}")
        cout = ws[0].shape[3]
        check_weight(f"link {j} w0", ws[0], (3, 3, c, cout))
        check_bias(f"link {j} b0", ws[1], cout)
        check_weight(f"link {j} w1", ws[2], (3, 3, cout, cout))
        check_bias(f"link {j} b1", ws[3], cout)
        if s.has_ds:
            check_weight(f"link {j} wd", ws[4], (1, 1, c, cout))
            check_bias(f"link {j} bd", ws[5], cout)
        elif s.stride != 1 or c != cout:
            raise ValueError(f"link {j}: identity skip needs stride 1 and "
                             f"Cin == Cout, got stride {s.stride}, "
                             f"{c} -> {cout}")
        if s.stride == 2 and (h % 2 or w % 2):
            # the (0, 1) pad at stride 2 matches SAME only for even sizes
            raise ValueError(f"link {j}: a stride-2 link needs even H/W "
                             f"to match SAME padding (0, 1), got {h}x{w}")
        for name in ("shift0", "shift1", "skip_shift"):
            check_shift(f"link {j} {name}", getattr(s, name))
        shapes.append(BlockShape(h=h, w=w, ich=c, och=cout,
                                 downsample=s.has_ds, stride=s.stride))
        h, w, c = h // s.stride, w // s.stride, cout
    operands = [x] + ([*stem] if stem is not None else []) + \
        [t for ws in blocks for t in ws]
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devices))}")
    return shapes


def block_chain_op(x, blocks, *, specs, stem=None, stem_shift=None,
                   config: KernelConfig = None):
    """x: (N,H,W,C) uint8, unpadded — the quantized image batch when
    ``stem`` is fused, else the previous kernel's activation.  ``blocks``:
    one (w0, b0, w1, b1[, wd, bd]) tuple per chain link (HWIO int8 filters,
    (Cout,) int16/int32 biases), ``specs`` the matching
    :class:`ChainBlockSpec` schedule; ``stem``: optional (w, b) fused at
    the chain head with ``stem_shift``.  ``config`` carries ``batch_tile``,
    the images one thread block takes (snapped to a divisor of N; default
    1).  Returns the last link's (N,oh,ow,Cout) uint8 output."""
    specs, blocks = tuple(specs), tuple(tuple(ws) for ws in blocks)
    shapes = _check_chain(x, blocks, specs, stem, stem_shift)
    blocks = tuple(tuple(t if t.dtype == torch.int8 else t.to(torch.int32)
                         for t in ws) for ws in blocks)
    if stem is not None:
        stem = (stem[0], stem[1].to(torch.int32))

    if x.device.type == "cpu":
        return block_chain_ref(x, blocks, specs=specs, stem=stem,
                               stem_shift=stem_shift)
    if x.device.type != "cuda":
        raise ValueError(f"block_chain_op: unsupported device {x.device}")
    if len(specs) > MAX_LINKS:
        raise ValueError(f"block_chain kernel takes at most {MAX_LINKS} "
                         f"links, got {len(specs)}")
    stem_och = stem[0].shape[3] if stem is not None else 0
    if stem_och % 4 or any(b.ich % 4 or b.och % 4 for b in shapes):
        raise ValueError("block_chain kernel needs block channel counts "
                         "that are multiples of 4")
    if stem is not None and x.shape[3] > 4:
        raise ValueError(f"block_chain kernel takes a fused stem on at "
                         f"most 4 input channels, got {x.shape[3]}")
    operands = [("x", x)] + ([("stem", t) for t in stem] if stem else []) + \
        [(f"link {j}", t) for j, ws in enumerate(blocks) for t in ws]
    for name, t in operands:
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"block_chain_op: {name} operands must be "
                             f"contiguous and 4-byte aligned")
    last = shapes[-1]
    N = x.shape[0]
    bt = (config or DEFAULT).normalize(N, last.och).batch_tile
    out = torch.empty((N, last.oh, last.ow, last.och), dtype=torch.uint8,
                      device=x.device)
    if out.numel() == 0:
        return out
    ptrs = []
    for s, ws in zip(specs, blocks):
        ptrs += [t.data_ptr() for t in ws[:4]]
        ptrs += [ws[4].data_ptr(), ws[5].data_ptr()] if s.has_ds \
            else [None, None]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.block_chain_launch(
            x.data_ptr(), out.data_ptr(),
            stem[0].data_ptr() if stem else None,
            stem[1].data_ptr() if stem else None,
            x.shape[3] if stem else 0, stem_och,
            stem_shift if stem else 0, _link_ints(shapes, specs),
            (_P * len(ptrs))(*ptrs), len(specs), N, bt, stream)
    _build.check(lib, err, "block_chain launch")
    block_chain_op.launches += 1
    return out


block_chain_op.launches = 0
