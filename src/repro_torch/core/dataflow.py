"""Dataflow buffer/stream sizing model (paper §III-E/F/G, eqs. 8-23) and the
byte model of the kernel tasks.

The port's copy of ``repro.core.dataflow``, formula for formula, so that
tests hold every function against the reference:

* the eq. 16-23 buffer formulas (window buffer, FIFO partition, receptive
  field, skip buffers) and the eq. 8-11 layer model (:class:`ConvLayer`,
  :func:`throughput_fps`), which ``core.ilp`` balances;
* the byte model of each kernel task (conv, fused residual block, block
  chain, and the LM matmul / attention / scan tasks), which
  ``obs.profile`` pairs with measured device time.  Its "VMEM" footprints
  are the reference's model of the TPU kernels' on-chip working set, kept
  as they are for comparison;
* the ResNet layer and block tables.

:func:`chain_task_smem_bytes` (and the packing helpers above it) is the
port's own: the dynamic shared memory one thread block of the CUDA
``block_chain`` kernel uses, the footprint that decides a chain cut on the
H100.

Pure arithmetic, no torch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


# ---------------------------------------------------------------------------
# eq. 16/17 — window (line) buffer sizes
# ---------------------------------------------------------------------------


def window_buffer_size(iw: int, ich: int, fh: int, fw: int,
                       ow_par: int = 1) -> int:
    """Activations retained to produce one input window (eq. 16; eq. 17 for
    ow_par=2 adds fw instead of fw-1)."""
    if ow_par == 1:
        return ((fh - 1) * iw + fw - 1) * ich
    return ((fh - 1) * iw + fw) * ich


def fifo_partition(iw: int, ich: int, fh: int, fw: int) -> List[int]:
    """§III-F Fig. 7: the line buffer is split into fh*fw FIFO slices; S1=ich
    between elements in a row, S2=(iw-fw+1)*ich between rows (so that the total
    equals eq. 16).  Returns the slice sizes."""
    s1 = ich
    s2 = (iw - fw + 1) * ich
    sizes = []
    for r in range(fh):
        for c in range(fw):
            if r == fh - 1 and c == fw - 1:
                sizes.append(0)        # newest element, not buffered
            elif c == fw - 1:
                sizes.append(s2)       # row boundary
            else:
                sizes.append(s1)
    return sizes


# ---------------------------------------------------------------------------
# eq. 18-21 — receptive-field skip buffering (the *unoptimized* cost)
# ---------------------------------------------------------------------------


def receptive_field(fh0: int, fw0: int, fh1: int, fw1: int) -> tuple:
    rh0 = fh1 + fh0 - 1            # eq. 18
    rw0 = fw1 + fw0 - 1            # eq. 19
    return rh0, rw0


def skip_buffer_receptive_field(iw0: int, ich0: int, fh0: int, fw0: int,
                                fh1: int, fw1: int) -> int:
    """eq. 21: B_sc = [iw0*(rh0-1) + rw0] * ich0."""
    rh0, rw0 = receptive_field(fh0, fw0, fh1, fw1)
    return (iw0 * (rh0 - 1) + rw0) * ich0


def skip_buffer_optimized(iw1: int, ich1: int, fh1: int, fw1: int) -> int:
    """eq. 22: after temporal-reuse/loop-merge/add-fold the skip buffer equals
    conv1's window buffer."""
    return window_buffer_size(iw1, ich1, fh1, fw1)


def skip_buffer_ratio(iw0, ich0, fh0, fw0, iw1, ich1, fh1, fw1) -> float:
    """eq. 23: R_sc (= 0.5 for all ResNet8/20 blocks)."""
    return (skip_buffer_optimized(iw1, ich1, fh1, fw1)
            / skip_buffer_receptive_field(iw0, ich0, fh0, fw0, fh1, fw1))


# ---------------------------------------------------------------------------
# eq. 8-11 — per-layer work / parallelism / throughput
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConvLayer:
    """Static description of one convolution task (symbols of Table 1)."""
    name: str
    ich: int
    ih: int
    iw: int
    och: int
    oh: int
    ow: int
    fh: int = 3
    fw: int = 3
    stride: int = 1
    skip_in: bool = False   # receives a folded residual stream

    @property
    def c(self) -> int:
        """eq. 8 — computations per frame."""
        return self.oh * self.ow * self.och * self.ich * self.fh * self.fw

    @property
    def k(self) -> int:
        return self.fh * self.fw

    @property
    def macs(self) -> int:
        return self.c

    @property
    def weights(self) -> int:
        return self.och * self.ich * self.fh * self.fw

    def cp(self, och_par: int, ow_par: int = 2) -> int:
        """eq. 9 — computation parallelism of the task."""
        return self.k * och_par * ow_par

    def latency_cycles(self, och_par: int, ow_par: int = 2) -> float:
        """cycles per frame = c / cp (perfectly pipelined intra-task loop)."""
        return self.c / self.cp(och_par, ow_par)


def throughput_fps(layer: ConvLayer, och_par: int, freq_hz: float,
                   ow_par: int = 2) -> float:
    """eq. 11 scaled by the clock: Th_i = freq * cp_i / c_i."""
    return freq_hz * layer.cp(och_par, ow_par) / layer.c


# ---------------------------------------------------------------------------
# HBM traffic model of a residual block
# ---------------------------------------------------------------------------


def residual_block_hbm_bytes(h: int, w: int, ich: int, och: int,
                             bytes_per_elt: int = 1, fused: bool = True,
                             downsample: bool = False, stride: int = 1) -> int:
    """HBM bytes moved by one residual block (activations only).

    Unfused (naive) dataflow: x is read by conv0 AND by the skip path, the
    intermediate y0 round-trips, conv1 output round-trips to the Add which
    re-reads the skip tensor.  Fused (paper-adapted) kernel: x is read once,
    y0 and the skip live in VMEM, only the block output is written.
    """
    oh, ow = h // stride, w // stride
    x = h * w * ich * bytes_per_elt
    y0 = oh * ow * och * bytes_per_elt
    y1 = oh * ow * och * bytes_per_elt
    skip = (oh * ow * och if downsample else h * w * ich) * bytes_per_elt
    if fused:
        return x + y1                         # read x once, write block output
    # conv0 reads x, writes y0; conv1 reads y0, writes y1; skip path reads x
    # (and writes the downsampled skip); add reads y1+skip, writes out.
    traffic = x + y0 + y0 + y1 + x + y1 + skip + y1
    if downsample:
        traffic += skip
    return traffic


# ---------------------------------------------------------------------------
# Tiled-kernel HBM traffic + VMEM footprint (the reference tuner's analytic
# cost model — the DSP/BRAM budget of §III-E becomes an HBM-traffic and
# on-chip memory budget)
# ---------------------------------------------------------------------------


def conv_task_hbm_bytes(layer: ConvLayer, batch: int, batch_tile: int,
                        act_bytes: int = 1, w_bytes: int = 1) -> int:
    """HBM bytes one tiled conv kernel moves for a ``batch``: activations
    move exactly once (read input map, write output map), but the filter +
    bias are re-fetched by every batch-grid step — the term the tuner's
    ``batch_tile`` knob amortizes.  ``cout_block`` does not change the total
    (the channel blocks of one batch step partition the filter); it only
    moves the VMEM footprint."""
    acts = batch * (layer.ih * layer.iw * layer.ich
                    + layer.oh * layer.ow * layer.och) * act_bytes
    steps = batch // max(1, batch_tile)
    weights = (layer.weights * w_bytes + layer.och * 4) * steps
    return acts + weights


def conv_task_vmem_bytes(layer: ConvLayer, batch_tile: int, cout_block: int,
                         act_bytes: int = 1, w_bytes: int = 1) -> int:
    """Per-grid-step VMEM footprint of the tiled conv kernel: the input tile
    (floored by the eq. 16 window buffer — a step can never retain less than
    one input window), the filter/bias slice, the int32 accumulator, and the
    output tile."""
    cb = cout_block or layer.och
    ihp, iwp = layer.ih + layer.fh - 1, layer.iw + layer.fw - 1
    in_tile = max(batch_tile * ihp * iwp * layer.ich,
                  window_buffer_size(layer.iw, layer.ich, layer.fh, layer.fw)
                  ) * act_bytes
    w_tile = layer.fh * layer.fw * layer.ich * cb * w_bytes + cb * 4
    acc = layer.oh * layer.ow * cb * 4
    out_tile = batch_tile * layer.oh * layer.ow * cb * act_bytes
    return in_tile + w_tile + acc + out_tile


def resblock_task_hbm_bytes(h: int, w: int, ich: int, och: int, batch: int,
                            batch_tile: int, downsample: bool = False,
                            stride: int = 1, act_bytes: int = 1,
                            w_bytes: int = 1) -> int:
    """HBM bytes the fused residual-block kernel moves for a ``batch``: the
    eq.-23-style fused activation traffic (read x once, write the block
    output) plus both conv filters (+ the 1x1 downsample filter when present)
    re-fetched per batch-grid step."""
    acts = batch * residual_block_hbm_bytes(
        h, w, ich, och, bytes_per_elt=act_bytes, fused=True,
        downsample=downsample, stride=stride)
    wts = (9 * ich * och + 9 * och * och
           + (ich * och if downsample else 0)) * w_bytes + 2 * och * 4
    steps = batch // max(1, batch_tile)
    return acts + wts * steps


def resblock_task_vmem_bytes(h: int, w: int, ich: int, och: int,
                             batch_tile: int, downsample: bool = False,
                             stride: int = 1, act_bytes: int = 1,
                             w_bytes: int = 1) -> int:
    """Per-grid-step VMEM footprint of the fused residual block: the padded
    input tile, both filters (+ ds), and the kernel-lifetime intermediates
    (y0, the aligned skip, and the int32 accumulator) that the fusion keeps
    out of HBM."""
    oh, ow = h // stride, w // stride
    in_tile = batch_tile * (h + 2) * (w + 2) * ich * act_bytes
    wts = (9 * ich * och + 9 * och * och
           + (ich * och if downsample else 0)) * w_bytes + 2 * och * 4
    y0 = (oh + 2) * (ow + 2) * och * act_bytes      # padded intermediate
    acc = oh * ow * och * 4                          # conv accumulator
    skip = oh * ow * och * 4                         # aligned skip stream
    out_tile = batch_tile * oh * ow * och * act_bytes
    return in_tile + wts + y0 + acc + skip + out_tile


# ---------------------------------------------------------------------------
# Block-chain streaming (megakernel) HBM traffic + VMEM footprint.  The
# paper's layer-to-layer streaming (§III-D) fuses across block boundaries:
# a chain of consecutive residual blocks executes in one kernel, the running
# activation never leaving on-chip memory between blocks.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockShape:
    """Static shape of one residual block as a chain link: input map
    ``h x w x ich``, output ``(h//stride) x (w//stride) x och``."""
    h: int
    w: int
    ich: int
    och: int
    downsample: bool = False
    stride: int = 1

    @property
    def oh(self) -> int:
        return self.h // self.stride

    @property
    def ow(self) -> int:
        return self.w // self.stride

    def weight_bytes(self, w_bytes: int = 1) -> int:
        """Both 3x3 filters (+ the 1x1 downsample when present) + biases."""
        wts = 9 * self.ich * self.och + 9 * self.och * self.och
        if self.downsample:
            wts += self.ich * self.och
        return wts * w_bytes + 2 * self.och * 4

    def in_bytes(self, act_bytes: int = 1) -> int:
        return self.h * self.w * self.ich * act_bytes

    def out_bytes(self, act_bytes: int = 1) -> int:
        return self.oh * self.ow * self.och * act_bytes


def chain_saved_hbm_bytes(blocks: List[BlockShape], batch: int,
                          act_bytes: int = 1) -> int:
    """HBM activation bytes the chain fusion removes vs per-block kernels:
    every *interior* boundary activation is written by block j and re-read by
    block j+1 in per-block execution — the chain keeps it in VMEM, saving
    both movements."""
    return 2 * batch * sum(b.out_bytes(act_bytes) for b in blocks[:-1])


def chain_task_hbm_bytes(blocks: List[BlockShape], batch: int,
                         batch_tile: int, stem_och: int = 0,
                         act_bytes: int = 1, w_bytes: int = 1) -> int:
    """HBM bytes one block-chain megakernel moves for a ``batch``: the chain
    input is read once, the chain output written once, and the chain's
    pinned weight set is fetched once per batch-grid step.  ``stem_och > 0``
    fuses the 3x3 stem conv at the chain head (its input becomes the chain
    input; one more interior boundary stays in VMEM).

    Identity: this equals the sum of the per-block
    ``resblock_task_hbm_bytes`` minus :func:`chain_saved_hbm_bytes` —
    fusion only ever removes interior activation round trips, never weight
    traffic."""
    first = blocks[0]
    if stem_och:
        # the chain input is the image; the stem boundary activation also
        # stays in VMEM (one more interior boundary saved)
        acts = batch * (first.h * first.w * 3 * act_bytes
                        + blocks[-1].out_bytes(act_bytes))
    else:
        acts = batch * (first.in_bytes(act_bytes)
                        + blocks[-1].out_bytes(act_bytes))
    steps = batch // max(1, batch_tile)
    wts = sum(b.weight_bytes(w_bytes) for b in blocks)
    if stem_och:
        wts += 9 * 3 * stem_och * w_bytes + stem_och * 4
    return acts + wts * steps


def chain_task_vmem_bytes(blocks: List[BlockShape], batch_tile: int,
                          stem_och: int = 0, act_bytes: int = 1,
                          w_bytes: int = 1) -> int:
    """Per-grid-step VMEM footprint of the chain megakernel — what decides a
    chain cut.  The whole chain's weights are pinned for the kernel's
    lifetime (constant-index BlockSpecs), the batch input/output tiles are
    resident, and the streaming working set is the *maximum* over links of
    the batch tile's per-block intermediates (padded input, padded y0, int32
    accumulator + aligned skip): the kernel body processes its whole tile
    per link (batched tap dots), and links execute sequentially."""
    first = blocks[0]
    ich0 = 3 if stem_och else first.ich
    in_tile = batch_tile * (first.h + 2) * (first.w + 2) * ich0 * act_bytes
    wts = sum(b.weight_bytes(w_bytes) for b in blocks)
    if stem_och:
        wts += 9 * 3 * stem_och * w_bytes + stem_och * 4
    work = 0
    if stem_och:
        work = (first.h * first.w * stem_och            # stem output
                + first.h * first.w * stem_och * 4)     # stem accumulator
    for b in blocks:
        per_img = ((b.h + 2) * (b.w + 2) * b.ich * act_bytes   # padded input
                   + (b.oh + 2) * (b.ow + 2) * b.och * act_bytes  # padded y0
                   + b.oh * b.ow * b.och * 4                   # accumulator
                   + b.oh * b.ow * b.och * 4)                  # aligned skip
        work = max(work, per_img)
    out_tile = batch_tile * blocks[-1].out_bytes(act_bytes)
    return in_tile + wts + batch_tile * work + out_tile


# The stem's input channels (the RGB image), padded in shared memory to one
# 32-bit word per pixel so that the stem runs on dp4a.
STEM_CIN = 3
STEM_CIN_PADDED = 4


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def pixel_pitch(c: int) -> int:
    """Bytes a stored pixel of a ``c``-channel map takes in the shared
    memory of the block kernels (``repro::pixel_pitch`` in
    ``kernels/csrc/block_body.cuh``): the channels rounded up to 16-byte
    chunks, then to an odd count of chunks, so that the 8 pixels of one
    ``ldmatrix`` phase fall on 8 different bank groups."""
    p = _align16(c)
    return p if (p // 16) % 2 else p + 16


def packed_part_bytes(ich: int, och: int, downsample: bool,
                      part: int) -> int:
    """Bytes of part A (``part`` 0: b0 and w0, conv0's operands) or part B
    (1: b1, bd, w1 and wd) of one residual block packed for the
    tensor-core kernels (``repro::packed_part_bytes``;
    ``kernels.resblock_fused.ops.pack_block`` writes it): int32 biases and
    mma-fragment-ordered filters, channels rounded up to 16 with zeros."""
    kp, np_ = _align16(ich), _align16(och)
    if part == 0:
        return 4 * np_ + 9 * kp * np_
    return 8 * np_ + 9 * np_ * np_ + (kp * np_ if downsample else 0)


def packed_block_bytes(ich: int, och: int, downsample: bool) -> int:
    """Bytes of one packed residual block, both parts."""
    return sum(packed_part_bytes(ich, och, downsample, p) for p in (0, 1))


def chain_task_smem_bytes(blocks: List[BlockShape], batch_tile: int,
                          stem_och: int = 0, split: int = 1) -> int:
    """Dynamic shared memory one thread block of the CUDA ``block_chain``
    kernel uses when ``split`` thread blocks share an image (a cluster,
    each owning a row band of every map): the same formula as
    ``chain_layout`` in ``kernels/csrc/block_chain.cu`` (exported as
    ``block_chain_smem_bytes``).

    * the stem's bias and dp4a filter, staged once (``stem_och > 0``);
    * two weight slots, each the largest ``packed_part_bytes`` of any link
      (the parts stream through them one conv phase ahead);
    * per image of the tile, three band planes (link input, y0, link
      output), each as large as the largest ``(h / split + 2) x (w + 2)``
      band of the chain's maps (halo rows and zero ring included) at
      ``pixel_pitch`` bytes a pixel, 4 for the image.

    The planes are rounded up to 16 bytes."""
    stem = _align16(stem_och * 4 + 9 * STEM_CIN_PADDED * stem_och) \
        if stem_och else 0
    slot = max(packed_part_bytes(b.ich, b.och, b.downsample, p)
               for b in blocks for p in (0, 1))
    planes = [(blocks[0].h // split + 2) * (blocks[0].w + 2)
              * STEM_CIN_PADDED] if stem_och else []
    for b in blocks:
        planes += [(b.h // split + 2) * (b.w + 2) * pixel_pitch(b.ich),
                   (b.oh // split + 2) * (b.ow + 2) * pixel_pitch(b.och)]
    return stem + 2 * slot + 3 * batch_tile * _align16(max(planes))


def resblock_task_smem_bytes(h: int, w: int, ich: int, och: int,
                             stride: int, downsample: bool,
                             band: int) -> int:
    """Dynamic shared memory one thread block of the CUDA
    ``resblock_fused`` kernel uses when it takes ``band`` output rows: the
    same formula as ``layout`` in ``kernels/csrc/resblock_fused.cu``
    (exported as ``resblock_fused_smem_bytes``).  The packed block, the
    band's ``(band + 1) * stride + 3`` staged input rows of the padded map
    (y0's edge rows are recomputed per band), and y0's ``band + 2`` rows
    with a zero ring, at ``pixel_pitch`` bytes a pixel."""
    pad_lo = 1 if stride == 1 else 0
    wp = w + pad_lo + 1
    ow = (wp - 3) // stride + 1
    xrows = (band + 1) * stride + 3
    return packed_block_bytes(ich, och, downsample) + \
        xrows * wp * pixel_pitch(ich) + (band + 2) * (ow + 2) * pixel_pitch(och)


def stem_band_smem_bytes(band: int, w: int, cin: int, cout: int) -> int:
    """Dynamic shared memory of one thread block of ``conv_stem``'s banded
    path (``band_layout`` in ``kernels/csrc/conv_stem.cu``): the bias, the
    filter as 9 x cout words, the plane of (band + 2) x (w + 2) words and
    the raw input rows (up to 15 bytes of lead, rounded up to 16)."""
    raw_off = _align16(4 * cout + 36 * cout + (band + 2) * (w + 2) * 4)
    return raw_off + ((band + 2) * w * cin + 30) // 16 * 16


def resnet_block_shapes(blocks_per_stage: int, base: int = 16, img: int = 32
                        ) -> List[BlockShape]:
    """The :class:`BlockShape` chain of a whole ResNet in graph order —
    the block-level view of :func:`resnet_layers`."""
    out = []
    ich, res = base, img
    for stage in range(3):
        och = base * (2 ** stage)
        for b in range(blocks_per_stage):
            stride = 2 if (stage > 0 and b == 0) else 1
            out.append(BlockShape(h=res, w=res, ich=ich, och=och,
                                  downsample=(stride != 1 or ich != och),
                                  stride=stride))
            ich, res = och, res // stride
    return out


# ---------------------------------------------------------------------------
# LM task kinds (matmul / attention / scan) — the byte model behind the
# reference tuner's legality pruning and the LM profile rooflines for the
# generic compiler's transformer / SSM task programs.  Same conventions as
# the conv formulas: act_bytes=1 (int8 streams), int32 accumulators at 4B,
# float interlude operands at 4B.
# ---------------------------------------------------------------------------


def matmul_task_hbm_bytes(M: int, K: int, N: int, bm: int, bn: int, bk: int,
                          acc_init: bool = False, act_bytes: int = 1,
                          w_bytes: int = 1) -> int:
    """HBM bytes one tiled int8 matmul moves: with grid (M/bm, N/bn, K/bk),
    every A tile is re-fetched once per N block and every B tile once per M
    block (the classic tiled-GEMM reuse), the bias once per (M, N) step pair
    — and the folded residual stream (``acc_init``) enters as a full int32
    (M, N) read."""
    bm, bn, bk = (max(1, b) for b in (bm, bn, bk))
    a = M * K * act_bytes * max(1, N // bn)
    b = K * N * w_bytes * max(1, M // bm)
    bias = N * 4 * max(1, M // bm)
    out = M * N * 4
    skip = M * N * 4 if acc_init else 0
    return a + b + bias + out + skip


def matmul_task_vmem_bytes(bm: int, bn: int, bk: int,
                           act_bytes: int = 1, w_bytes: int = 1) -> int:
    """Per-grid-step VMEM footprint of the int8 matmul kernel: one A tile,
    one B tile, the int32 accumulator scratch, and the int32 acc-init /
    output tiles."""
    bm, bn, bk = (max(1, b) for b in (bm, bn, bk))
    return (bm * bk * act_bytes + bk * bn * w_bytes
            + 3 * bm * bn * 4)           # scratch + acc_init + out


def attention_task_hbm_bytes(BH: int, Sq: int, Sk: int, hd: int,
                             bq: int, bk: int, elt_bytes: int = 4) -> int:
    """HBM bytes one flash-attention call moves (per fused (batch*heads)
    instance set): q and o move once, but K and V are re-streamed by every
    q-tile grid step — the term the ``bq`` knob amortizes."""
    bq = max(1, bq)
    q_steps = max(1, Sq // bq)
    qo = 2 * BH * Sq * hd * elt_bytes
    kv = 2 * BH * Sk * hd * elt_bytes * q_steps
    return qo + kv


def attention_task_vmem_bytes(Sk: int, hd: int, bq: int, bk: int,
                              elt_bytes: int = 4) -> int:
    """Per-grid-step VMEM footprint of the flash kernel: one q/o tile pair,
    the streaming K/V tile pair, the (bq, bk) score tile, and the online
    softmax state (m, l, acc)."""
    bq, bk = max(1, bq), max(1, bk)
    return (2 * bq * hd * elt_bytes      # q tile + acc/o tile
            + 2 * bk * hd * elt_bytes    # K/V tiles
            + bq * bk * elt_bytes        # score tile
            + 2 * bq * elt_bytes)        # m, l


def scan_task_hbm_bytes(B: int, S: int, d_inner: int, N: int, bd: int,
                        elt_bytes: int = 4) -> int:
    """HBM bytes one selective-scan call moves: u/dt/y move once, but the
    per-step B_t/C_t projections are re-read by every d_inner block instance
    (grid (B, d_inner/bd)) — the term the ``bd`` knob amortizes — plus the
    A slice and the h state in/out."""
    bd = max(1, bd)
    d_steps = max(1, d_inner // bd)
    seq = 3 * B * S * d_inner * elt_bytes            # u, dt, y
    bc = 2 * B * S * N * elt_bytes * d_steps         # B_t, C_t re-reads
    a = d_inner * N * elt_bytes * B                  # A slice per batch inst
    h = 2 * B * d_inner * N * elt_bytes              # h0 in, h_last out
    return seq + bc + a + h


def scan_task_vmem_bytes(S: int, N: int, bd: int, elt_bytes: int = 4) -> int:
    """Per-grid-step VMEM footprint of the scan kernel: the (bd, N) state +
    A slices pinned for the whole sequence walk, the full-sequence u/dt/y
    stripes of the d block, and the (S, N) B/C streams."""
    bd = max(1, bd)
    return (2 * bd * N * elt_bytes       # A slice + h state
            + 3 * S * bd * elt_bytes     # u, dt, y stripes
            + 2 * S * N * elt_bytes)     # B_t, C_t


# ---------------------------------------------------------------------------
# ResNet layer tables (mirrors graph.build_resnet_graph; used by core.ilp)
# ---------------------------------------------------------------------------


def resnet_layers(blocks_per_stage: int, base: int = 16, img: int = 32
                  ) -> List[ConvLayer]:
    layers = [ConvLayer("stem", 3, img, img, base, img, img)]
    ich, res, i = base, img, 0
    for stage in range(3):
        och = base * (2 ** stage)
        for b in range(blocks_per_stage):
            stride = 2 if (stage > 0 and b == 0) else 1
            ow = res // stride
            layers.append(ConvLayer(f"c{i}_0", ich, res, res, och, ow, ow,
                                    stride=stride))
            layers.append(ConvLayer(f"c{i}_1", och, ow, ow, och, ow, ow,
                                    skip_in=True))
            if stride != 1 or ich != och:
                layers.append(ConvLayer(f"ds{i}", ich, res, res, och, ow, ow,
                                        fh=1, fw=1, stride=stride))
            ich, res = och, ow
            i += 1
    return layers


def resnet8_layers() -> List[ConvLayer]:
    return resnet_layers(1)


def resnet20_layers() -> List[ConvLayer]:
    return resnet_layers(3)


def total_gops(layers: List[ConvLayer]) -> float:
    """2*MACs in Gops per frame (conv layers only, like the paper's Gops/s)."""
    return 2.0 * sum(l.macs for l in layers) / 1e9
