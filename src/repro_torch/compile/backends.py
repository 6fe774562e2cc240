"""Backend registry: how a lowering plan becomes executable code.

A backend turns the optimized graph + typed parameters into a
``features(images) -> u8 feature map`` closure (the integer datapath);
``lower`` follows it with the shared float pool + classifier head, giving
``images -> logits``.  Keeping the two apart lets tests hold the u8 map
bitwise.  Backends self-register via decorator.

Built-in backends, all lowering the SAME plan (``lowering.plan_model``):

  * ``cuda``        — the fused kernel pipeline: one ``conv_stem`` launch
                      and one ``resblock_fused`` launch per residual block
                      (the counterpart of the JAX package's ``pallas``).
  * ``cuda-stream`` — the streaming pipeline: the blocks partitioned into
                      chains (``lowering.plan_chains``), each chain ONE
                      ``block_chain`` launch with the stem fused at the
                      head; at the H100's shared-memory budget ResNet8 and
                      ResNet20 are one launch each (the counterpart of
                      ``pallas-stream``).
  * ``torch-int``   — the reference integer graph on exact float64
                      convolutions: identical int32 accumulators and shift
                      arithmetic, unfused dataflow (the counterpart of
                      ``lax-int``).  Bit-exact with both kernel backends by
                      construction.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, runtime_checkable

import torch

from repro_torch.core import quant as Q
from repro_torch.compile import lowering
from repro_torch.compile.params import (
    QConvParams, QResNetParams, activation_out_specs)
from repro_torch.kernels.common import conv_i32
from repro_torch.models.resnet import A_SPEC


@runtime_checkable
class Backend(Protocol):
    """Lower an optimized graph + typed params into ``images -> logits``."""

    name: str

    def features(self, g, cfg, params: QResNetParams) -> Callable:
        ...

    def lower(self, g, cfg, params: QResNetParams) -> Callable:
        ...


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str):
    """Class decorator: instantiate and register a backend under ``name``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_backend(name: str) -> Backend:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; registered: {list_backends()}")
    return _REGISTRY[name]


def list_backends():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Shared arithmetic (one home, so bit-exactness cannot drift)
# ---------------------------------------------------------------------------


def _int_conv(xq, c: QConvParams, stride=1, acc_init=None):
    """int8 x int8 -> int32 accumulator (+ int bias, + folded skip stream)."""
    acc = conv_i32(xq, c.wq, stride) + c.bq.to(torch.int32)
    if acc_init is not None:
        acc = acc + acc_init
    return acc


def _relu_requant(acc, c: QConvParams, out_spec=A_SPEC):
    return Q.requantize_shift(torch.clamp_min(acc, 0), c.product_exp,
                              out_spec)


def _block_operands(params, plan, block_outs):
    """Per block of the plan: the kernel operands (biases widened to int32)
    and the derived shifts, computed once at lower time."""
    out = {}
    for task in plan.blocks:
        blk = params.blocks[task.index]
        ws = (blk.conv0.wq, blk.conv0.bq.to(torch.int32), blk.conv1.wq,
              blk.conv1.bq.to(torch.int32))
        if task.has_ds:
            ws += (blk.ds.wq, blk.ds.bq.to(torch.int32))
        out[task.index] = (ws, blk.shifts_for(block_outs[task.index].exp))
    return out


def _float_head(h_u8, fc, in_spec=A_SPEC):
    """Dequantize the final feature map and run pool + classifier in float32
    (the paper's host-side tail).  The classifier is a broadcast product and
    a sum, so it calls no BLAS library."""
    pooled = torch.mean(Q.dequantize(h_u8, in_spec), dim=(1, 2))
    w = Q.dequantize(fc.wq, fc.w_spec)
    return (pooled[:, :, None] * w[None, :, :]).sum(dim=1) + fc.b


class _ConvBackend:
    """``lower`` = the backend's ``features`` followed by the float head."""

    def features(self, g, cfg, params) -> Callable:
        raise NotImplementedError

    def lower(self, g, cfg, params) -> Callable:
        feats = self.features(g, cfg, params)
        stem_out, block_outs = activation_out_specs(params, A_SPEC)
        head_spec = block_outs[-1] if block_outs else stem_out
        fc = params.fc

        def forward(images):
            return _float_head(feats(images), fc, head_spec)

        return forward


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


@register_backend("torch-int")
class TorchIntBackend(_ConvBackend):
    """Reference integer graph: exact int32 convs, shift requant, residual
    add folded into conv1's accumulator init."""

    def features(self, g, cfg, params) -> Callable:
        plan = lowering.plan_model(g, params)
        stem_out, block_outs = activation_out_specs(params, A_SPEC)

        def features(images):
            xq = Q.quantize(images, params.stem.x_spec)
            h = _relu_requant(_int_conv(xq, params.stem), params.stem,
                              stem_out)
            for task in plan.blocks:
                blk = params.blocks[task.index]
                out_spec = block_outs[task.index]
                y = _relu_requant(_int_conv(h, blk.conv0, task.stride),
                                  blk.conv0, blk.conv1.x_spec)
                sh = blk.shifts_for(out_spec.exp)["skip_shift"]
                if task.has_ds:
                    skip_q = Q.shift_align(
                        _int_conv(h, blk.ds, task.stride), sh)
                else:
                    skip_q = Q.shift_align(h, sh)
                h = _relu_requant(
                    _int_conv(y, blk.conv1, 1, acc_init=skip_q), blk.conv1,
                    out_spec)
            return h

        return features


@register_backend("cuda-stream")
class CudaStreamBackend(_ConvBackend):
    """Block-chain streaming pipeline: the plan's block sequence is
    partitioned into chains (``lowering.plan_chains``) and each chain runs
    as ONE ``block_chain`` launch — the running activation stays in shared
    memory across every fused block boundary, the stem conv folded into
    the first chain when the budget allows.  At the H100's shared-memory
    budget both ResNet8 and ResNet20 are one chain, stem included.

    As in ``pallas-stream``, a chain cut down to a single block without the
    stem runs ``resblock_fused``, and a stem left unfused runs
    ``conv_stem``: the planner's choice, visible in the launch counters.

    ``cuts`` pins an explicit partition (any partition into consecutive
    runs is bit-exact with every other — the chain-cut property),
    ``fuse_stem=False`` keeps the stem out of the chains, and
    ``smem_budget`` replaces ``tune.space.SMEM_BUDGET`` for the planner.

    Batch tile: the JAX backend defaults to the *largest* legal tile,
    since pinned weights amortise over the TPU's sequential grid steps.
    On the H100 a larger tile only means fewer thread blocks (32 images at
    ``batch_tile=32`` would be one block on one SM), so this backend runs
    ``batch_tile=1`` (``block_chain_op``'s default), one image per thread
    block, unless a chain carries its own ``config``.  The results are
    bitwise the same at every tile.
    Biases are widened and shifts derived once, here, not per call."""

    def __init__(self, cuts=None, fuse_stem: bool = True, smem_budget=None):
        self.cuts = cuts
        self.fuse_stem = fuse_stem
        self.smem_budget = smem_budget

    def features(self, g, cfg, params) -> Callable:
        from repro_torch.kernels.conv_stem.ops import conv_stem_op
        from repro_torch.kernels.megakernel.ops import (
            ChainBlockSpec, block_chain_op)
        from repro_torch.kernels.resblock_fused.ops import resblock_fused_op

        plan = lowering.plan_model(g, params)
        chains = lowering.plan_chains(plan, cfg, cuts=self.cuts,
                                      fuse_stem=self.fuse_stem,
                                      smem_budget=self.smem_budget)
        stem_out, block_outs = activation_out_specs(params, A_SPEC)
        st = params.stem
        stem_op = (st.wq, st.bq.to(torch.int32))
        stem_shift = stem_out.exp - st.product_exp
        operands = _block_operands(params, plan, block_outs)

        # the launch sequence, fixed at lower time
        def stem_step(h):
            return conv_stem_op(h, *stem_op, shift=stem_shift)

        def block_step(ws, kw):
            return lambda h: resblock_fused_op(h, *ws, **kw)

        def chain_step(**kw):
            return lambda h: block_chain_op(h, **kw)

        steps = [] if chains and chains[0].stem is not None else [stem_step]
        for chain in chains:
            if len(chain.blocks) == 1 and chain.stem is None:
                # singleton chain: the chain kernel would add nothing
                task, = chain.blocks
                ws, sh = operands[task.index]
                steps.append(block_step(ws if task.has_ds
                                        else ws + (None, None),
                                        dict(stride=task.stride, **sh)))
                continue
            fused = chain.stem is not None
            steps.append(chain_step(
                blocks=tuple(operands[t.index][0] for t in chain.blocks),
                specs=tuple(ChainBlockSpec(stride=t.stride, has_ds=t.has_ds,
                                           **operands[t.index][1])
                            for t in chain.blocks),
                stem=stem_op if fused else None,
                stem_shift=stem_shift if fused else None,
                config=chain.config))

        def features(images):
            h = Q.quantize(images, st.x_spec)
            for step in steps:
                h = step(h)
            return h

        return features


@register_backend("cuda")
class CudaBackend(CudaStreamBackend):
    """Fused kernel pipeline: one ``conv_stem`` launch, then one
    ``resblock_fused`` launch per residual block (conv0 + ReLU/requant +
    optional 1x1 downsample + add-fold + conv1 + ReLU/requant, with y0 and
    the skip kept in shared memory).  It is the streaming pipeline with no
    chain: at a shared-memory budget of 0 bytes the planner makes every
    block a singleton chain, which runs ``resblock_fused``, and the stem
    stays unfused."""

    def __init__(self):
        super().__init__(fuse_stem=False, smem_budget=0)
