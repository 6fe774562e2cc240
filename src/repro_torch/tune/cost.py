"""Analytic cost model — stage 1 of the two-stage search.

The port's copy of ``repro.tune.cost``: it ranks candidate configs without
touching the card, by the reference's two-term roofline at the H100's
ratios plus a fixed cost per thread-block wave and per launch.  Per task,

    time ~ max(MACs / (PEAK_MACS * active), bytes / HBM_BW)
           + waves * WAVE_COST_S + launches * LAUNCH_COST_S

* ``PEAK_MACS``: the int8 dense tensor-core rate, 1,979 TOP/s (two
  operations a MAC), and ``HBM_BW`` 3,350 GB/s (NVIDIA H100 SXM data
  sheet).  ``active`` is the share of the card's thread-block slots the
  launch fills (``min(1, thread_blocks / (sms * blocks_per_sm))``): a grid
  of 32 thread blocks can use 32 SMs' tensor cores, not 132.
* The bytes are the ``core.dataflow`` byte model's: each activation map
  read or written once (the fused kernels keep y0 and the skip on chip),
  and the weights fetched again by every thread block, as the reference
  fetched them again every grid step (the term taller bands and larger
  batch tiles amortise).  The halo rows a band restages and the y0 rows
  it recomputes stay out of the bytes, as the reference's windows did;
  the recomputed rows' MACs are counted.
* The reference's per-grid-step term becomes a per-wave term: ``waves =
  ceil(thread_blocks / (sms * blocks_per_sm))``, each paying a fixed cost
  (staging and pipeline fill of a thread block).

Only the ranking matters; the device stage (``tune.search``) times the
top candidates for real.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import dataflow
from repro_torch.tune import space as tspace
from repro_torch.tune.config import KernelConfig

# H100 SXM: int8 dense MACs/s, HBM bytes/s, SMs; fixed costs of one
# thread-block wave and of one launch.
PEAK_MACS = 1979e12 / 2
HBM_BW = 3.35e12
SMS = 132
WAVE_COST_S = 4e-6
LAUNCH_COST_S = 2e-6
# thread blocks an SM the rules size the grids for (the stem's is
# kernels.conv_stem.ops.BLOCKS_PER_SM, which imports this package)
STEM_BLOCKS_PER_SM = 2
BLOCK_BLOCKS_PER_SM = 1


@dataclasses.dataclass(frozen=True)
class Cost:
    """Modeled execution of one task at one config."""
    macs: int
    hbm_bytes: int
    thread_blocks: int
    slots: int                  # thread blocks the card runs at once
    launches: int = 1

    @property
    def waves(self) -> int:
        return self.launches * -(-self.thread_blocks // self.slots)

    @property
    def active(self) -> float:
        """Share of the card's thread-block slots one launch fills."""
        return min(1.0, self.thread_blocks / self.slots)

    @property
    def arithmetic_intensity(self) -> float:
        """MACs per byte — the roofline x-axis."""
        return self.macs / max(1, self.hbm_bytes)

    @property
    def modeled_s(self) -> float:
        return max(self.macs / (PEAK_MACS * self.active),
                   self.hbm_bytes / HBM_BW) \
            + self.waves * WAVE_COST_S + self.launches * LAUNCH_COST_S

    def to_dict(self) -> dict:
        return dict(macs=self.macs, hbm_bytes=self.hbm_bytes,
                    thread_blocks=self.thread_blocks, waves=self.waves,
                    launches=self.launches,
                    arithmetic_intensity=round(self.arithmetic_intensity, 3),
                    modeled_us=round(self.modeled_s * 1e6, 3))


def _y0_rows(oh: int, band: int) -> int:
    """Rows of y0 ``resblock_fused`` computes over the bands of an
    ``oh``-row output: each band's own and one either side inside the
    map."""
    return sum(min(r0 + nb + 1, oh) - max(r0 - 1, 0)
               for r0, nb in tspace.block_bands(oh, band))


def stem_cost(layer: dataflow.ConvLayer, batch: int, config: KernelConfig,
              sms: int = SMS) -> Cost:
    """``conv_stem``'s banded path at ``config``'s band (0: the rule):
    every thread block stages the filter and bias again."""
    slots = sms * STEM_BLOCKS_PER_SM
    band = config.normalize(batch, layer.och, oh=layer.oh).band_rows or \
        tspace.block_band_rows(layer.oh, batch, slots)
    tb = batch * -(-layer.oh // band)
    acts = batch * (layer.ih * layer.iw * layer.ich
                    + layer.oh * layer.ow * layer.och)
    return Cost(macs=batch * layer.macs,
                hbm_bytes=acts + tb * (layer.weights + 4 * layer.och),
                thread_blocks=tb, slots=slots)


def block_cost(layer0: dataflow.ConvLayer, batch: int, config: KernelConfig,
               downsample: bool = False, fused: bool = True,
               sms: int = SMS) -> Cost:
    """One residual block (conv0 + conv1 + optional ds) as ``resblock_fused``
    executes it at ``config``'s band (0: the rule): each band recomputes
    y0's edge rows and stages the packed block again.  ``fused=False``
    models the same block on the unfused dataflow (every intermediate
    round-trips HBM, one launch per conv and one for the add, each with
    the same bands and each thread block staging its conv's filter and
    bias) — the A/B the cost-model sanity test pins: fusion must rank
    cheaper."""
    h, w, ich, och, s = (layer0.ih, layer0.iw, layer0.ich, layer0.och,
                         layer0.stride)
    oh, ow = h // s, w // s
    slots = sms * BLOCK_BLOCKS_PER_SM
    band = config.normalize(batch, och, oh=oh).band_rows or \
        tspace.block_band_rows(oh, batch, slots)
    tb = batch * -(-oh // band)
    per_row1 = ow * och * (9 * och + (ich if downsample else 0))
    if not fused:
        macs = batch * oh * (ow * och * 9 * ich + per_row1)
        hbm = batch * dataflow.residual_block_hbm_bytes(
            h, w, ich, och, fused=False, downsample=downsample, stride=s)
        wts = 9 * ich * och + 9 * och * och + 8 * och + \
            (ich * och + 4 * och if downsample else 0)
        launches = 4 if downsample else 3
        return Cost(macs=macs, hbm_bytes=hbm + tb * wts,
                    thread_blocks=tb, slots=slots, launches=launches)
    macs = batch * (_y0_rows(oh, band) * ow * och * 9 * ich + oh * per_row1)
    acts = batch * dataflow.residual_block_hbm_bytes(
        h, w, ich, och, fused=True, downsample=downsample, stride=s)
    return Cost(macs=macs,
                hbm_bytes=acts + tb * dataflow.packed_block_bytes(
                    ich, och, downsample),
                thread_blocks=tb, slots=slots)


def chain_cost(blocks, batch: int, config: KernelConfig, stem_och: int = 0,
               sms: int = SMS) -> Cost:
    """One ``block_chain`` launch at ``config``'s ``(batch_tile, split)``
    (0: the rule, judged without the card's occupancy query): the chain's
    input read and output written once, every link's packed block
    restaged by each thread block, halos exchanged on chip."""
    bt = config.normalize(batch, blocks[-1].och).batch_tile
    split = config.normalize(batch, blocks[-1].och,
                             splits=tspace.chain_splits(blocks)).split or \
        tspace.chain_split(blocks, batch // bt, bt, stem_och)
    tb = batch // bt * split
    first, last = blocks[0], blocks[-1]
    macs = sum(b.oh * b.ow * b.och * (9 * b.ich + 9 * b.och +
                                      (b.ich if b.downsample else 0))
               for b in blocks)
    wts = sum(dataflow.packed_block_bytes(b.ich, b.och, b.downsample)
              for b in blocks)
    if stem_och:
        macs += first.h * first.w * stem_och * 9 * dataflow.STEM_CIN
        wts += 9 * dataflow.STEM_CIN * stem_och + 4 * stem_och
        acts = first.h * first.w * dataflow.STEM_CIN
    else:
        acts = first.in_bytes()
    acts += last.out_bytes()
    return Cost(macs=batch * macs, hbm_bytes=batch * acts + tb * wts,
                thread_blocks=tb, slots=sms)


def task_cost(cfg, batch: int, backend: str, key: str,
              config: KernelConfig) -> Cost:
    """The modeled cost of one task of ``tspace.model_space(cfg, batch,
    backend)`` at ``config``."""
    layers = {l.name: l for l in dataflow.resnet_layers(
        cfg.blocks_per_stage, cfg.base_width, cfg.img)}
    if backend == "cuda-stream":
        shapes = dataflow.resnet_block_shapes(cfg.blocks_per_stage,
                                              cfg.base_width, cfg.img)
        for k, run, stem_och in tspace.model_chains(cfg):
            if k == key and (len(run) > 1 or stem_och):
                return chain_cost([shapes[i] for i in run], batch, config,
                                  stem_och)
    if key == "stem":
        return stem_cost(layers["stem"], batch, config)
    i = int(key[len("block"):])
    return block_cost(layers[f"c{i}_0"], batch, config,
                      downsample=f"ds{i}" in layers)


def model_cost(cfg, batch: int, tuning: Dict[str, KernelConfig],
               backend: str = "cuda") -> Dict[str, Cost]:
    """Per-task modeled cost of one whole-model tuning assignment (tasks
    the assignment leaves out at the default)."""
    return {key: task_cost(cfg, batch, backend, key,
                           tuning.get(key, KernelConfig()))
            for key in tspace.model_space(cfg, batch, backend)}


def total_modeled_s(costs: Dict[str, Cost]) -> float:
    return sum(c.modeled_s for c in costs.values())
