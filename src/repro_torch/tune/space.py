"""Chain legality space: which batch tiles a block chain may run at, and the
greedy partition of a model's blocks into chains.

The port's copy of the chain part of ``repro.tune.space``, with the H100's
budget in place of the TPU's: a chain is legal at a batch tile when one
thread block of the CUDA ``block_chain`` kernel fits in the shared memory
a thread block may opt into (``core.dataflow.chain_task_smem_bytes``
against :data:`SMEM_BUDGET`).  Everything else is the reference's rule:
divisor-legal tiles, legality judged at ``batch=1``, and the greedy longest
legal run.  ``stem_space``, ``block_space`` and the LM spaces wait for the
tuning port.

Structure only: nothing here touches torch or weights.
"""
from __future__ import annotations

from typing import List

from repro_torch.core import dataflow
from repro_torch.tune.config import KernelConfig

# Dynamic shared memory one thread block may opt into on an H100 (227 KB;
# ``repro::kMaxSmemBytes`` in ``kernels/csrc/common.cuh``).
SMEM_BUDGET = 232_448


def divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def chain_space(blocks, batch: int, stem_och: int = 0,
                smem_budget: int = SMEM_BUDGET) -> List[KernelConfig]:
    """Legal batch tilings for one block-chain kernel (``blocks`` is a list
    of :class:`~repro_torch.core.dataflow.BlockShape` chain links, in order;
    ``stem_och > 0`` fuses the stem at the head).  A chain whose thread
    block exceeds the shared-memory budget at *every* batch tile cannot
    run — the empty list tells the planner to cut it shorter.  Channel
    blocking is fusion-illegal, as for the single fused block."""
    out = []
    for bt in divisors(batch):
        smem = dataflow.chain_task_smem_bytes(blocks, bt, stem_och=stem_och)
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
