"""Shared integer arithmetic of the kernels' plain versions.

``requant_u8`` is the epilogue of every integer conv kernel (its CUDA twin
is ``repro::requant_u8`` in ``csrc/common.cuh``); ``conv_i32`` is the exact
integer convolution the plain versions and the ``torch-int`` backend build
on.
"""
from __future__ import annotations

import functools
import statistics

import torch
import torch.nn.functional as F

# shifts are runtime kernel arguments; outside this range a 32-bit shift is
# undefined in C++ and meaningless for an int32 accumulator
SHIFT_MIN, SHIFT_MAX = -31, 31


def check_shift(name: str, shift) -> int:
    if not isinstance(shift, int) or isinstance(shift, bool) or \
            not SHIFT_MIN <= shift <= SHIFT_MAX:
        raise ValueError(
            f"{name}={shift!r}: expected an int in [{SHIFT_MIN}, {SHIFT_MAX}]")
    return shift


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: what one wave of
    the block kernels' thread blocks is sized to."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_ids_ptr(sm_ids, blocks: int, device):
    """Pointer of the optional per-thread-block SM record of a block kernel
    launch: None, or a contiguous int32 tensor of ``blocks`` elements on
    ``device`` that the launch fills with the SM each thread block ran
    on."""
    if sm_ids is None:
        return None
    if sm_ids.dtype != torch.int32 or sm_ids.numel() != blocks or \
            sm_ids.device != device or not sm_ids.is_contiguous():
        raise ValueError(f"sm_ids must be a contiguous int32 tensor of "
                         f"{blocks} on {device}, got {tuple(sm_ids.shape)} "
                         f"{sm_ids.dtype} on {sm_ids.device}")
    return sm_ids.data_ptr()


def check_weight(name: str, t: torch.Tensor, shape) -> None:
    """A filter operand: int8 of exactly ``shape``."""
    if t.dtype != torch.int8 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} int8, got "
                         f"{tuple(t.shape)} {t.dtype}")


def check_bias(name: str, t: torch.Tensor, cout: int) -> None:
    """A bias operand: ``(cout,)`` int16 or int32 (widened by the
    wrappers to the int32 accumulator)."""
    if t.dtype not in (torch.int16, torch.int32) or tuple(t.shape) != (cout,):
        raise ValueError(f"{name} must be ({cout},) int16/int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def requant_u8(acc: torch.Tensor, shift: int):
    """int32 product-domain accumulator -> u8 activation domain: ReLU, then
    a pow2 shift (positive = rounding right shift ``(acc + half) >> s``,
    negative = left shift), then clip to [0, 255]."""
    acc = torch.clamp_min(acc, 0)
    if shift > 0:
        acc = (acc + (1 << (shift - 1))) >> shift
    elif shift < 0:
        acc = acc << (-shift)
    return torch.clamp(acc, 0, 255).to(torch.uint8)


def same_pad(size: int, k: int, stride: int):
    """``(lo, hi)`` padding of one spatial dim as ``jax.lax``'s SAME computes
    it: a 3x3 conv pads (1, 1) at stride 1 but (0, 1) at stride 2 on an
    even size; a 1x1 conv pads nothing."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_i32(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """SAME convolution of integer NHWC ``x`` with integer HWIO ``w``,
    exact in int32.  Computed in float64: every product and partial sum is
    an integer below 2^53, so no order of summation rounds."""
    fh, fw = w.shape[0], w.shape[1]
    ph = same_pad(x.shape[1], fh, stride)
    pw = same_pad(x.shape[2], fw, stride)
    xf = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), pw + ph)
    acc = F.conv2d(xf, w.to(torch.float64).permute(3, 2, 0, 1),
                   stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Launch counters.  Each kernel wrapper counts its launches in ``launches``
# (and, where it has several paths, in ``launches_by_path``), in Python, at
# the call that launches.  A CUDA graph replays launches without running
# that Python, so ``compile.CompiledModel`` records what one capture
# counted and adds it at every replay (``add_launches``), and leaves the
# counters of its warm-up and capture passes as it found them
# (``capture_graph``).  The counts a replay adds are bookkeeping: what the
# card ran is read from a profiler trace of the replays.
# ---------------------------------------------------------------------------


def counted_ops() -> tuple:
    """The seven kernel wrappers that count their launches."""
    from repro_torch.kernels.conv2d_int8.ops import conv2d_int8_op
    from repro_torch.kernels.conv_stem.ops import conv_stem_op
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.matmul_int8.ops import matmul_int8_op
    from repro_torch.kernels.megakernel.ops import block_chain_op
    from repro_torch.kernels.resblock_fused.ops import resblock_fused_op
    from repro_torch.kernels.selective_scan.ops import selective_scan_op
    return (conv_stem_op, resblock_fused_op, block_chain_op, matmul_int8_op,
            flash_attention_op, selective_scan_op, conv2d_int8_op)


def read_launches() -> dict:
    """``{op: (launches, launches_by_path)}`` of every counted wrapper."""
    return {op: (op.launches, dict(getattr(op, "launches_by_path", {})))
            for op in counted_ops()}


def write_launches(counts: dict) -> None:
    """Set every counter to what :func:`read_launches` returned."""
    for op, (n, by_path) in counts.items():
        op.launches = n
        if hasattr(op, "launches_by_path"):
            op.launches_by_path = dict(by_path)


def launch_delta(before: dict, after: dict) -> dict:
    """What the counters counted between two :func:`read_launches`."""
    return {op: (after[op][0] - n,
                 {p: after[op][1][p] - k for p, k in by_path.items()})
            for op, (n, by_path) in before.items()}


def add_launches(delta: dict) -> None:
    """Add a :func:`launch_delta` to the counters: one replay of a captured
    graph."""
    for op, (n, by_path) in delta.items():
        if n:
            op.launches += n
            for p, k in by_path.items():
                op.launches_by_path[p] += k


# ---------------------------------------------------------------------------
# CUDA graphs: the one capture sequence of the port (the served buckets,
# and the device-time measurements of obs.profile and chip_smoke.py).
# ---------------------------------------------------------------------------


def capture_graph(fn, calls: int = 1, warmup: int = 3, warm=None,
                  pool=None, device=None):
    """Capture ``calls`` back-to-back calls of ``fn()`` into one
    ``torch.cuda.CUDAGraph`` on ``device`` (default: the current one), in
    the memory pool ``pool`` where given.  ``warm`` (default ``fn``) first
    runs ``warmup`` times on a side stream, so that lazy state (the
    allocator's blocks, prepared launches, TMA maps) exists before the
    capture.  Returns
    ``(graph, out, launches)``: the graph, what the last captured call
    returned (the graph's static output) and the :func:`launch_delta` the
    captured calls counted.  Every launch counter is left as found."""
    before = read_launches()
    try:
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    (warm or fn)()
            torch.cuda.current_stream().wait_stream(side)
            warmed = read_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                for _ in range(calls):
                    out = fn()
            launches = launch_delta(warmed, read_launches())
    finally:
        write_launches(before)
    return graph, out, launches


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``calls`` calls captured into
    one CUDA graph (:func:`capture_graph`), the graph timed by CUDA events
    over ``replays`` replays, the median replay over ``calls``.  Host
    launch overhead is excluded."""
    graph = capture_graph(fn, calls)[0]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return float(statistics.median(times))
