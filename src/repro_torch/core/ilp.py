"""Throughput balancer — the paper's ILP (§III-E, Algorithm 1).

The dataflow accelerator's throughput equals the throughput of its slowest
concurrent task, so the optimum allocates computation parallelism
``cp_i = k_i * och_par_i * ow_par`` proportionally to per-layer work ``c_i``
(eq. 14: cp_i = cp_imax * r_i with r_i = c_i / c_imax) under the platform DSP
budget ``N_PAR`` (eq. 13).

The decision space is one integer per network (``och_par`` of the busiest
layer); every other layer's unroll follows by the balance condition.  We solve
it *exactly* by descending search — equivalent to the paper's ILP because the
objective (eq. 12) is monotone in the single variable and the constraint is
monotone too.

The port's copy of ``repro.core.ilp``.  Its frames per second are the
paper's analytic model of the FPGA accelerator on the Ultra96 and KV260
(``PLATFORMS``: DSP budget, clock and weight-port width of each board), not
a measurement of any chip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

from repro_torch.core.dataflow import ConvLayer


@dataclasses.dataclass
class Allocation:
    layer: ConvLayer
    och_par: int
    ow_par: int

    @property
    def cp(self) -> int:
        return self.layer.cp(self.och_par, self.ow_par)

    @property
    def dsp(self) -> int:
        # with ow_par=2 packing, the two MACs of a PE share one DSP (§III-C);
        # chain-splitting adds one fabric adder, not a DSP.
        return self.layer.k * self.och_par

    @property
    def cycles_per_frame(self) -> float:
        return self.layer.c / self.cp


@dataclasses.dataclass
class Solution:
    allocations: List[Allocation]
    n_par: int
    freq_hz: float

    @property
    def dsp_used(self) -> int:
        return sum(a.dsp for a in self.allocations)

    @property
    def bottleneck_cycles(self) -> float:
        return max(a.cycles_per_frame for a in self.allocations)

    @property
    def fps(self) -> float:
        return self.freq_hz / self.bottleneck_cycles

    @property
    def gops(self) -> float:
        total_ops = 2.0 * sum(a.layer.macs for a in self.allocations)
        return self.fps * total_ops / 1e9

    @property
    def latency_s(self) -> float:
        """First-frame latency: window-buffer fill of each stage plus one
        bottleneck interval (the pipeline is stall-free after add-fold)."""
        fill = sum(
            ((a.layer.fh - 1) * a.layer.iw + a.layer.fw) / max(1, a.layer.iw)
            * a.layer.ih / 8.0  # rough fill fraction of a frame row-wise
            for a in self.allocations
        )
        return (self.bottleneck_cycles + fill) / self.freq_hz


def _round_up_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def balance(layers: Sequence[ConvLayer], och_par_max_layer: int,
            ow_par: int = 2, pow2: bool = False) -> List[int]:
    """Given the busiest layer's unroll, derive every layer's och_par by the
    balance condition (eq. 14), honoring och divisibility."""
    cmax = max(l.c for l in layers)
    imax = [l.c for l in layers].index(cmax)
    lmax = layers[imax]
    # target interval (cycles/frame) implied by the busiest layer's unroll
    target = lmax.c / (lmax.k * och_par_max_layer * ow_par)
    out = []
    for l in layers:
        need = l.c / (l.k * ow_par * target)
        p = max(1, math.ceil(need - 1e-9))
        if pow2:
            p = _round_up_pow2(p)
        p = min(p, l.och)
        out.append(p)
    return out


def solve(layers: Sequence[ConvLayer], n_par: int, freq_hz: float,
          ow_par: int = 2, pow2: bool = False,
          weight_bw: float = float("inf")) -> Solution:
    """Algorithm 1: maximize Th(och_par_imax) s.t. sum(DSP) <= N_PAR and the
    on-chip weight-memory bandwidth constraint (§III-D): every DSP consumes one
    weight word per cycle (the two packed MACs share it), so the words/cycle
    the parameter tasks must sustain equals the DSP count and is bounded by
    the aggregate URAM/BRAM port width."""
    cmax = max(l.c for l in layers)
    imax = [l.c for l in layers].index(cmax)
    budget = min(n_par, weight_bw)
    best = None
    for p_imax in range(layers[imax].och, 0, -1):
        if pow2 and (p_imax & (p_imax - 1)):
            continue
        pars = balance(layers, p_imax, ow_par, pow2)
        allocs = [Allocation(l, p, ow_par) for l, p in zip(layers, pars)]
        if sum(a.dsp for a in allocs) <= budget:
            best = Solution(allocs, n_par, freq_hz)
            break
    if best is None:  # degenerate budget: all layers at minimum unroll
        allocs = [Allocation(l, 1, ow_par) for l in layers]
        best = Solution(allocs, n_par, freq_hz)
    return best


def balanced_och_par(layers: Sequence[ConvLayer], pow2: bool = True,
                     ow_par: int = 2) -> List[int]:
    """Per-layer ``och_par`` when the busiest layer is fully unrolled — the
    eq. 12-14 balance point with no resource cap.  The reference's tuner
    (``repro.tune``) uses this as the channel-block floor when enumerating
    kernel configs: a task tiled below its balanced unroll is the pipeline
    bottleneck by construction, so those candidates are pruned before
    costing (the software mirror of Algorithm 1's proportional
    allocation)."""
    cmax = max(l.c for l in layers)
    imax = [l.c for l in layers].index(cmax)
    return balance(layers, layers[imax].och, ow_par=ow_par, pow2=pow2)


# Platform DSP budgets (paper Table 2), achieved clocks (Table 3), and
# weight-port bandwidth (words/cycle).  Ultra96 stores weights in BRAM
# (216 x 36-bit ports = 4 int8 words each -> not binding vs 360 DSPs);
# KV260 stores them in URAM (64 x 72-bit ports = 9 words) plus a small BRAM
# spill (~16 BRAMs observed in Table 4) -> ~640 words/cycle.
PLATFORMS = {
    "ultra96": dict(n_par=360, freq_hz=214e6, weight_bw=float("inf")),
    "kv260": dict(n_par=1248, freq_hz=274e6, weight_bw=640),
}


def predict_fps(layers: Sequence[ConvLayer], platform: str) -> Solution:
    p = PLATFORMS[platform]
    return solve(layers, p["n_par"], p["freq_hz"], weight_bw=p["weight_bw"])
