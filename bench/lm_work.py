"""Work of one forward of a ``mamba1`` configuration, from its widths alone.

Nothing here reads the program: the counts follow from the published
block's shapes, so they stay put whatever implements the work.  Per token
and layer the four projections take ``d * 2 di + di * (R + 2N) + R * di
+ di * d`` multiply-adds and the depthwise conv ``di * K``.  A matmul's
least bytes are its int8 weight, its int16 bias where it has one, its
int8 input and output rows and, for ``W_out``, the int8 residual it folds
in; the scan's are its float32 operands (u, Delta, B, C, A, the initial
state) read once and its outputs (y, the last state) written once.  The
peaks are ``work.PEAKS``.
"""
from __future__ import annotations

from typing import NamedTuple

from bench.reference.mamba1 import dims


class Matmul(NamedTuple):
    name: str
    din: int
    dout: int
    bias: bool
    skip: bool


def matmuls(cfg):
    """A layer's four projections."""
    m = dims(cfg)
    return (Matmul("w_in", m.d, 2 * m.di, False, False),
            Matmul("w_x", m.di, m.r + 2 * m.n, False, False),
            Matmul("w_dt", m.r, m.di, True, False),
            Matmul("w_out", m.di, m.d, False, True))


def matmul_macs_per_token(cfg) -> int:
    return dims(cfg).layers * sum(p.din * p.dout for p in matmuls(cfg))


def conv_macs_per_token(cfg) -> int:
    m = dims(cfg)
    return m.layers * m.di * m.k


def matmul_bound_s(cfg, tokens: int, peak) -> float:
    """Least seconds of a forward's matmuls over ``tokens`` tokens: each
    projection the larger of its operations over the int8 peak and its
    least bytes over HBM bandwidth, summed over the projections and the
    layers."""
    one = 0.0
    for p in matmuls(cfg):
        ops = 2 * tokens * p.din * p.dout
        nbytes = p.din * p.dout + 2 * p.dout * p.bias + \
            tokens * (p.din + p.dout + p.dout * p.skip)
        one += max(ops / peak["int8_ops_per_s"],
                   nbytes / peak["hbm_bytes_per_s"])
    return dims(cfg).layers * one


def scan_bytes(cfg, batch: int, seq: int) -> int:
    """Least bytes of a forward's scans: per layer u, Delta and y (batch x
    seq x di), B and C (batch x seq x N), A (di x N) and the first and last
    states (batch x di x N), float32."""
    m = dims(cfg)
    return m.layers * 4 * (3 * batch * seq * m.di + 2 * batch * seq * m.n
                           + m.di * m.n + 2 * batch * m.di * m.n)
