"""Optimizers over nested parameter trees (no ``torch.optim``).

* ``sgdm``  — SGD + momentum + cosine annealing (the paper's training
  recipe).
* ``adamw`` — AdamW with optional **int8 pow2-block-quantized moments**
  (``core.quant.block_quantize``): moments are dequantized, updated and
  requantized each step.

API, the JAX package's: ``opt = make(name, **hp)``; ``state =
opt.init(params)``; ``params, state = opt.update(grads, state, params,
step)``.  Updates are functional (new tensors, the old ones untouched) and
run without autograd.  ``adamw`` also has ``opt.update_``, the same step
written into the given params' and state's storage (what the reference
gets from ``donate_argnums``): the LM trainer's form, since a functional
step holds two copies of params and moments at once.

``adamw``'s ``init`` and ``update_`` take DTensor parameters (FSDP x TP,
``parallel.sharding``): each moment inherits its parameter's placements
(ZeRO-3), and the update, elementwise, runs on the local shards.  Int8
moments are quantized on the local shard, which gives the reference's
blocks when the local extent of the last (blocked) dim is a multiple of
the block; ``init`` refuses any other placement, naming the leaf.

Every leaf is updated, as the reference maps over every leaf: a gradient
of ``None`` (a leaf the loss does not read, e.g. ``bn.mean`` / ``bn.var``
in training mode) counts as zero, so weight decay still shrinks it.  The
learning-rate schedule is computed on the host in float32, as the
reference computes it on the device, so both packages take the same step:
its cosine is the C library's float32 ``cosf``, which is what XLA's CPU
backend computes (numpy's and torch's float32 cosines differ from it in
the last place for about one argument in twenty).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import quant as Q
from repro_torch.core import tree as T

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    # the update written into the storage of the params and state it is
    # given (None: the optimizer has only the functional form)
    update_: Optional[Callable] = None


@functools.cache
def _libm_cosf():
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.restype, cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return cosf


def cos_f32(x) -> np.float32:
    """The float32 cosine of a float32 ``x``, as C's ``cosf``."""
    return F32(_libm_cosf()(float(F32(x))))


def cosine_lr(base_lr: float, total_steps: int, warmup: int = 0):
    """``lr(step)`` -> float32: linear warm-up over ``warmup`` steps, then
    a cosine from ``base_lr`` to 0 at ``total_steps``."""
    def lr(step):
        step = F32(step)
        warm = min(F32(1.0), F32((step + F32(1)) / F32(max(warmup, 1))))
        t = F32((step - F32(warmup)) / F32(max(total_steps - warmup, 1)))
        t = min(max(t, F32(0.0)), F32(1.0))
        cos = cos_f32(F32(np.pi) * t)
        return F32(F32(F32(F32(base_lr) * warm) * F32(0.5)) * F32(1 + cos))
    return lr


def _grad_or_zero(g, p):
    return torch.zeros_like(p) if g is None else g


def sgdm(lr=0.1, momentum=0.9, weight_decay=1e-4, total_steps=1000,
         warmup=0):
    sched = cosine_lr(lr, total_steps, warmup)

    def init(params):
        return dict(mu=T.tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = float(sched(step))

        def upd(p, g, m):
            g = _grad_or_zero(g, p) + weight_decay * p
            m = momentum * m + g
            return p - lr_t * m, m

        out = T.tree_map(upd, params, grads, state["mu"])
        return T.tree_map(lambda _, o: o[0], params, out), \
            dict(mu=T.tree_map(lambda _, o: o[1], params, out))

    return Optimizer(init, update)


# elements of a leaf that the in-place update works on at once: its float32
# temporaries stay near 1 GiB whatever the leaf's size
CHUNK_ELEMENTS = 1 << 26


def _rows(t):
    """``t`` as a 2-D view (rows, last axis); a vector is one row.  The
    moments' quantization blocks run along the last axis, so rows update
    independently."""
    return t.view(-1, t.shape[-1]) if t.dim() > 1 else t.view(1, -1)


def _local(x):
    """A DTensor's local shard (sharing its storage), else ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def _local_state(x):
    if isinstance(x, Q.BlockQuantized):
        return Q.BlockQuantized(q=_local(x.q), exp=_local(x.exp))
    return _local(x)


def _local_grad(g, p):
    """The gradient's shard on its parameter's placements."""
    if isinstance(g, DTensor):
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        return g.to_local()
    return g


def _like(p, t):
    """A tensor made on ``p``'s local shard, as a DTensor on ``p``'s
    placements when ``p`` is one."""
    if not isinstance(p, DTensor):
        return t
    return DTensor.from_local(t, p.device_mesh, p.placements,
                              run_check=False)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          total_steps=10_000, warmup=200, int8_state=False,
          state_block=128):
    sched = cosine_lr(lr, total_steps, warmup)

    def _q(x):
        if not int8_state or x.numel() < state_block:
            return x
        return Q.block_quantize(x.to(torch.float32), block=state_block)

    def _dq(x):
        if isinstance(x, Q.BlockQuantized):
            return Q.block_dequantize(x, block=state_block)
        return x

    def init(params):
        if int8_state:
            _check_int8_shards(params, state_block)

        def zeros(p):
            loc = _local(p)
            if not int8_state or p.numel() < state_block:
                return _like(p, torch.zeros(loc.shape, dtype=torch.float32,
                                            device=loc.device))
            # every row of zeros quantizes alike: one row, repeated (the
            # whole leaf in float32 would not fit beside a 7B model)
            row = Q.block_quantize(torch.zeros(
                (1, loc.shape[-1]), dtype=torch.float32, device=loc.device),
                block=state_block)
            n = _rows(loc).shape[0]
            return Q.BlockQuantized(
                q=_like(p, row.q.repeat(n, 1).reshape(loc.shape)),
                exp=_like(p, row.exp.repeat(n, 1).reshape(
                    tuple(loc.shape[:-1]) + (row.exp.shape[-1],))))
        return dict(m=T.tree_map(zeros, params),
                    v=T.tree_map(zeros, params))

    def scalars(step):
        t = F32(step) + F32(1)
        return (float(sched(step)), float(F32(1) - F32(b1) ** t),
                float(F32(1) - F32(b2) ** t))

    def leaf(p, g, m, v, lr_t, c1, c2):
        """One leaf's step: (new parameter, float32 m, float32 v)."""
        gf = g.to(torch.float32)
        mf = b1 * m + (1 - b1) * gf
        vf = b2 * v + (1 - b2) * gf * gf
        u = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        u = u + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr_t * u).to(p.dtype), mf, vf

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t, c1, c2 = scalars(step)

        def upd(p, g, m, v):
            newp, mf, vf = leaf(p, _grad_or_zero(g, p), _dq(m), _dq(v),
                                lr_t, c1, c2)
            return newp, _q(mf), _q(vf)

        # the walk follows the params' structure, so a BlockQuantized
        # moment arrives whole at its parameter's leaf
        out = T.tree_map(upd, params, grads, state["m"], state["v"])
        return T.tree_map(lambda _, o: o[0], params, out), dict(
            m=T.tree_map(lambda _, o: o[1], params, out),
            v=T.tree_map(lambda _, o: o[2], params, out))

    @torch.no_grad()
    def update_(grads, state, params, step):
        """``update`` written into the storage of ``params`` and ``state``
        (the reference's donated buffers): each leaf, and each moment's
        float32 tensor or ``q`` / ``exp``, is overwritten a chunk of rows
        at a time, so the peak is one chunk's temporaries above the
        parameters, moments and gradients.  Elementwise in rows, so equal
        to ``update`` bitwise.  Returns ``(params, state)``."""
        lr_t, c1, c2 = scalars(step)

        def moment(x):
            """(read rows r, write rows r) of a moment."""
            if isinstance(x, Q.BlockQuantized):
                q, e = _rows(x.q), _rows(x.exp)

                def write(r, val):
                    bq = Q.block_quantize(val, block=state_block)
                    q[r].copy_(bq.q)
                    e[r].copy_(bq.exp)
                return (lambda r: Q.block_dequantize(
                    Q.BlockQuantized(q[r], e[r]), block=state_block)), write
            x2 = _rows(x)
            return (lambda r: x2[r]), (lambda r, val: x2[r].copy_(val))

        def upd(p, g, m, v):
            p, g = _local(p), None if g is None else _local_grad(g, p)
            m, v = _local_state(m), _local_state(v)
            p2 = _rows(p)
            g2 = None if g is None else _rows(g.contiguous())
            (read_m, write_m), (read_v, write_v) = moment(m), moment(v)
            n, width = p2.shape
            chunk = max(1, CHUNK_ELEMENTS // width)
            for r0 in range(0, n, chunk):
                r = slice(r0, r0 + chunk)
                newp, mf, vf = leaf(p2[r], _grad_or_zero(
                    None if g2 is None else g2[r], p2[r]), read_m(r),
                    read_v(r), lr_t, c1, c2)
                p2[r].copy_(newp)
                write_m(r, mf)
                write_v(r, vf)

        T.tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update, update_)


def _check_int8_shards(params, block):
    """Int8 moments of a DTensor leaf whose last dim is sharded need a
    local extent that is a multiple of ``block``."""
    for path, p in T.flatten_with_path(params):
        if not isinstance(p, DTensor) or p.numel() < block:
            continue
        last = p.dim() - 1
        loc = p.to_local().shape[-1]
        if any(pl.is_shard(last) for pl in p.placements) and loc % block:
            raise ValueError(
                f"{path}: int8 moments need the local extent of the last "
                f"dim ({loc} of {p.shape[-1]}, placements "
                f"{tuple(p.placements)}) to be a multiple of the block "
                f"{block}")


def make(name: str, **hp) -> Optimizer:
    if name == "sgdm":
        return sgdm(**hp)
    if name == "adamw":
        return adamw(**hp)
    raise ValueError(name)
