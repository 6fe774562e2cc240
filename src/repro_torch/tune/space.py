"""Chain legality space: which batch tiles a block chain may run at, and the
greedy partition of a model's blocks into chains.

The port's copy of the chain part of ``repro.tune.space``, with the H100's
budget in place of the TPU's: a chain is legal at a batch tile when one
thread block of the CUDA ``block_chain`` kernel fits in the shared memory
a thread block may opt into (``core.dataflow.chain_task_smem_bytes``
against :data:`SMEM_BUDGET`) at the split :func:`chain_split` picks.
Everything else is the reference's rule: divisor-legal tiles, legality
judged at ``batch=1``, and the greedy longest legal run.  The
decomposition rules of the two block kernels live here too:
:func:`block_band_rows` (``resblock_fused``'s row bands) and
:func:`chain_split` (``block_chain``'s thread blocks an image).
``stem_space``, ``block_space`` and the LM spaces wait for the tuning
port.

Structure only: nothing here touches torch or weights.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core import dataflow
from repro_torch.tune.config import KernelConfig

# Dynamic shared memory one thread block may opt into on an H100 (227 KB;
# ``repro::kMaxSmemBytes`` in ``kernels/csrc/common.cuh``).
SMEM_BUDGET = 232_448
# Thread block cluster sizes the block_chain kernel takes (portable sizes).
SPLITS = (1, 2, 4, 8)


def divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def block_band_rows(oh: int, n: int, sms: int) -> int:
    """Output rows one thread block of ``resblock_fused`` takes, for an
    ``oh``-row output map at batch ``n`` on a card of ``sms`` SMs: the
    tallest bands that give each image at least ``sms // n`` of them (one
    wave of one thread block an SM), or one band a row.  On an H100's 132
    SMs, at bucket 32 the 32-, 16- and 8-row maps get bands of 8, 4 and 2
    rows (128 thread blocks each), at bucket 8 of 2, 1 and 1, at bucket 1
    of 1."""
    parts = max(1, min(oh, sms // max(n, 1)))
    band = -(-oh // parts)
    while band > 1 and -(-oh // band) < parts:
        band -= 1
    return band


def block_bands(oh: int, band: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each band of ``band`` output rows that
    ``resblock_fused``'s grid takes of an ``oh``-row map, the last one
    ragged."""
    return [(r0, min(band, oh - r0)) for r0 in range(0, oh, band)]


def block_band_input_rows(r0: int, band: int, stride: int) -> Tuple[int,
                                                                    int]:
    """[lo, hi): the rows of the SAME-padded input that the thread block of
    the band at ``r0`` stages (``xrows`` in ``csrc/resblock_fused.cu``):
    every row that conv0 reads for y0 rows ``r0 - 1 .. r0 + band`` (the band
    and one recomputed row either side) and that the skip reads.  Rows
    outside the padded input are staged as zeros."""
    return (r0 - 1) * stride, (r0 + band) * stride + 3


def chain_bands(h: int, split: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each of the ``split`` equal row bands of an
    ``h``-row map that ``block_chain``'s cluster ranks own."""
    nb = h // split
    return [(r * nb, nb) for r in range(split)]


def chain_splits(blocks) -> List[int]:
    """The splits the ``block_chain`` kernel can take for a chain: cluster
    sizes of 1, 2, 4 or 8 thread blocks an image that divide the height
    of every map of the chain, so that every band has the same rows and a
    stride-2 link's output band r reads exactly input band r."""
    heights = [b.h for b in blocks] + [b.oh for b in blocks]
    return [s for s in SPLITS if all(h % s == 0 for h in heights)]


def chain_split(blocks, tiles: int, batch_tile: int = 1, stem_och: int = 0,
                smem_budget: int = SMEM_BUDGET, capacity=None) -> int:
    """Thread blocks an image (the cluster size) of one ``block_chain``
    launch of ``tiles`` image tiles of ``batch_tile``, among the legal
    splits whose thread block fits ``smem_budget``.  ``capacity(split,
    smem)`` is how many clusters the card runs at once
    (``kernels.megakernel.ops.max_clusters``, the kernel's own occupancy
    query): the launch takes the largest split whose ``tiles`` clusters
    run in one wave, or the smallest when none does.  Without it (the
    planner, which judges legality at batch 1) the largest split.  When no
    split fits the budget, the largest, whose planes are smallest.  The
    one place the split is chosen; ``KernelConfig.batch_tile`` keeps its
    meaning."""
    smem = {s: dataflow.chain_task_smem_bytes(blocks, batch_tile,
                                              stem_och=stem_och, split=s)
            for s in chain_splits(blocks)}
    fits = [s for s, b in smem.items() if b <= smem_budget]
    if not fits or capacity is None:
        return max(fits or smem)
    wave = [s for s in fits if tiles <= capacity(s, smem[s])]
    return max(wave) if wave else min(fits)


def chain_space(blocks, batch: int, stem_och: int = 0,
                smem_budget: int = SMEM_BUDGET) -> List[KernelConfig]:
    """Legal batch tilings for one block-chain kernel (``blocks`` is a list
    of :class:`~repro_torch.core.dataflow.BlockShape` chain links, in order;
    ``stem_och > 0`` fuses the stem at the head).  A tile is legal when one
    thread block fits the shared-memory budget at the split
    :func:`chain_split` picks for it.  A chain whose thread block exceeds
    the budget at *every* batch tile cannot run — the empty list tells the
    planner to cut it shorter.  Channel blocking is fusion-illegal, as for
    the single fused block."""
    out = []
    for bt in divisors(batch):
        split = chain_split(blocks, batch // bt, bt, stem_och, smem_budget)
        smem = dataflow.chain_task_smem_bytes(blocks, bt, stem_och=stem_och,
                                              split=split)
        if smem <= smem_budget:
            out.append(KernelConfig(batch_tile=bt))
    return out


def chain_cut_points(blocks, batch: int, stem_och: int = 0,
                     smem_budget: int = SMEM_BUDGET) -> List[List[int]]:
    """Greedy longest-legal partition of a model's block sequence into
    chains: extend the open chain while :func:`chain_space` still has a
    legal tiling, else cut.  ``blocks`` is the whole-model
    ``dataflow.resnet_block_shapes`` list; returns lists of block indices.
    Any partition into runs of consecutive blocks is *arithmetically* legal
    (the chain-cut property); this picks the one with the fewest interior
    boundaries through HBM under the shared-memory cap."""
    cuts, open_chain = [], []
    for i, _ in enumerate(blocks):
        cand = open_chain + [i]
        och = stem_och if (not cuts and cand[0] == 0) else 0
        if chain_space([blocks[j] for j in cand], batch, stem_och=och,
                       smem_budget=smem_budget):
            open_chain = cand
            continue
        if open_chain:
            cuts.append(open_chain)
        # a single block over budget still has to run somewhere: emit it as
        # a singleton chain (the backend runs it through resblock_fused)
        open_chain = [i]
    if open_chain:
        cuts.append(open_chain)
    return cuts
