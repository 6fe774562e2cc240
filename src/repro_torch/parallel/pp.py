"""Pipeline parallelism — the paper's ILP balancing applied at pod scale
(the port of ``repro.parallel.pp``).

The dataflow accelerator's law "throughput = slowest concurrent task" is the
same law that governs a synchronous training pipeline: step time is set by
the slowest stage.  ``partition_stages`` reuses the balance objective of
core.ilp (Algorithm 1) to assign contiguous layer ranges to stages,
minimizing the maximum per-stage work c_i — solved exactly by DP.

``pipeline_step`` is a GPipe-style schedule over a mesh dim, one stage a
rank: microbatches flow stage -> stage by send/recv; bubbles =
(n_stages - 1) / (n_micro + n_stages - 1).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist


def partition_stages(costs: Sequence[float], n_stages: int) -> List[int]:
    """Contiguous partition of per-layer costs minimizing max stage cost.
    Returns stage boundaries (start index per stage).  Exact DP."""
    n = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def stage_cost(i, j):
        return prefix[j] - prefix[i]

    # dp[s][j] = min over i of max(dp[s-1][i], cost(i, j))
    dp = np.full((n_stages + 1, n + 1), np.inf)
    choice = np.zeros((n_stages + 1, n + 1), np.int64)
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(1, n + 1):
            for i in range(s - 1, j):
                v = max(dp[s - 1][i], stage_cost(i, j))
                if v < dp[s][j]:
                    dp[s][j] = v
                    choice[s][j] = i
    bounds = []
    j = n
    for s in range(n_stages, 0, -1):
        i = int(choice[s][j])
        bounds.append(i)
        j = i
    return list(reversed(bounds))


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_step(stage_fn: Callable, mesh, axis: str, n_micro: int):
    """GPipe forward over mesh dim ``axis``, this rank one stage.

    ``stage_fn(stage_idx, x) -> x`` is applied per stage; activations move
    to the next stage's rank by send/recv (the first stage receives
    zeros).  Returns ``f(xs)`` where ``xs`` (n_micro, mb, ...) is the same
    on every stage; its result is the last stage's stream, summed over the
    dim (zeros elsewhere) so that every rank holds it."""
    names = tuple(mesh.mesh_dim_names)
    d = names.index(axis)
    group, idx, n_stages = (mesh.get_group(d), mesh.get_local_rank(d),
                            mesh.size(d))

    def shard_fn(xs):
        inflight = torch.zeros_like(xs[0])    # what arrived at this stage
        outs = []
        for t in range(n_micro + n_stages - 1):
            x_in = xs[min(t, n_micro - 1)] if t < n_micro \
                else torch.zeros_like(xs[0])
            # stage 0 injects microbatch t; others use what arrived
            x = x_in if idx == 0 else inflight
            y = stage_fn(idx, x)
            ops, nxt = [], torch.zeros_like(y)
            if idx < n_stages - 1:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      dist.get_global_rank(group, idx + 1),
                                      group))
            if idx > 0:
                ops.append(dist.P2POp(dist.irecv, nxt,
                                      dist.get_global_rank(group, idx - 1),
                                      group))
            for r in (dist.batch_isend_irecv(ops) if ops else []):
                r.wait()
            inflight = nxt
            outs.append(y if idx == n_stages - 1 else torch.zeros_like(y))
        out = torch.stack(outs)
        # only the last stage holds real outputs (zeros elsewhere) — one
        # all-reduce replicates them
        dist.all_reduce(out, group=group)
        # outputs for microbatch m emerge at tick m + n_stages - 1
        return out[n_stages - 1:]

    return shard_fn
