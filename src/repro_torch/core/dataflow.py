"""Byte model of the fused residual block and of block-chain streaming.

The port's copy of the chain part of ``repro.core.dataflow``: the HBM
traffic of one fused block and of a chain of blocks, and the reference's
VMEM footprint of a chain, copied as they are so that tests hold them
against the reference.  :func:`chain_task_smem_bytes` is the port's own:
the dynamic shared memory one thread block of the CUDA ``block_chain``
kernel uses, the footprint that decides a chain cut on the H100.

Pure arithmetic, no torch.
"""
from __future__ import annotations

import dataclasses
from typing import List


def residual_block_hbm_bytes(h: int, w: int, ich: int, och: int,
                             bytes_per_elt: int = 1, fused: bool = True,
                             downsample: bool = False, stride: int = 1) -> int:
    """HBM bytes moved by one residual block (activations only).

    Unfused (naive) dataflow: x is read by conv0 AND by the skip path, the
    intermediate y0 round-trips, conv1 output round-trips to the Add which
    re-reads the skip tensor.  Fused kernel: x is read once, y0 and the
    skip stay on chip, only the block output is written.
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


def resblock_task_hbm_bytes(h: int, w: int, ich: int, och: int, batch: int,
                            batch_tile: int, downsample: bool = False,
                            stride: int = 1, act_bytes: int = 1,
                            w_bytes: int = 1) -> int:
    """HBM bytes the fused residual-block kernel moves for a ``batch``: the
    fused activation traffic (read x once, write the block output) plus
    both conv filters (+ the 1x1 downsample filter when present) fetched
    once per ``batch_tile`` images."""
    acts = batch * residual_block_hbm_bytes(
        h, w, ich, och, bytes_per_elt=act_bytes, fused=True,
        downsample=downsample, stride=stride)
    wts = (9 * ich * och + 9 * och * och
           + (ich * och if downsample else 0)) * w_bytes + 2 * och * 4
    steps = batch // max(1, batch_tile)
    return acts + wts * steps


# ---------------------------------------------------------------------------
# Block-chain streaming: the paper's layer-to-layer streaming (§III-D) fused
# across block boundaries — a chain of consecutive residual blocks runs in
# one kernel, the running activation never leaving the chip between blocks.
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
    every *interior* boundary activation is written by block j and re-read
    by block j+1 in per-block execution — the chain keeps it on chip,
    saving both movements."""
    return 2 * batch * sum(b.out_bytes(act_bytes) for b in blocks[:-1])


def chain_task_hbm_bytes(blocks: List[BlockShape], batch: int,
                         batch_tile: int, stem_och: int = 0,
                         act_bytes: int = 1, w_bytes: int = 1) -> int:
    """HBM bytes one block-chain kernel moves for a ``batch``: the chain
    input is read once, the chain output written once, and the chain's
    weight set is fetched once per ``batch_tile`` images.  ``stem_och > 0``
    fuses the 3x3 stem conv at the chain head (its input becomes the chain
    input; one more interior boundary stays on chip).

    Identity: this equals the sum of the per-block
    ``resblock_task_hbm_bytes`` minus :func:`chain_saved_hbm_bytes` —
    fusion only ever removes interior activation round trips, never weight
    traffic."""
    first = blocks[0]
    if stem_och:
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
    """The reference's per-grid-step VMEM footprint of the TPU chain
    kernel: the whole chain's weights pinned, the batch input/output tiles
    resident, and the *maximum* over links of the tile's per-block
    intermediates (padded input, padded y0, int32 accumulator + aligned
    skip).  Kept for comparison with the reference; the port's planner
    uses :func:`chain_task_smem_bytes`."""
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


def resnet_block_shapes(blocks_per_stage: int, base: int = 16, img: int = 32
                        ) -> List[BlockShape]:
    """The :class:`BlockShape` chain of a whole ResNet in graph order."""
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
