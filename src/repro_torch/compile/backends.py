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

LM configs (``compile.lm_params.QLMConfig``) lower through the same three
backends: :func:`lower_lm` walks ``lowering.plan_lm``'s task program and
binds each task kind to the backend's registered impl
(:func:`register_task_impl`).  ``torch-int`` runs the kernels' plain
versions; ``cuda`` runs ``matmul_int8`` on every projection,
``flash_attention`` on the transformer's attention and ``selective_scan``
on the Mamba scan; ``cuda-stream`` has no LM chain kernel and runs the
``cuda`` impls (as ``pallas-stream`` runs the ``pallas`` ones).  For an LM,
``features`` returns the int8 hidden state entering the unembed and
``lower`` adds the float last-position unembed.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, runtime_checkable

import torch

from repro_torch.core import quant as Q
from repro_torch.compile import lm_params as LP
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


# ---------------------------------------------------------------------------
# LM task lowering: per-(backend, kind) implementation registry
# ---------------------------------------------------------------------------
#
# lowering.plan_lm produces an ordered task program; HOW each task kind
# executes is a per-backend choice registered here.  The int8 matmul
# arithmetic is shared (prologue / epilogue), so the kernel and the plain
# backend differ only in the int32 product, which is exact in both.

_TASK_IMPLS: Dict[tuple, Callable] = {}


def register_task_impl(backend_name: str, kind: str):
    """Register ``impl(task, ctx)`` as how ``backend_name`` executes tasks
    of ``kind``.  ``ctx`` is the :class:`_LMContext` of the running forward;
    the impl reads ``ctx.env[task.inputs[i]]`` and writes
    ``ctx.env[task.output]`` (plus its quant spec into ``ctx.specs``)."""
    def deco(fn):
        _TASK_IMPLS[(backend_name, kind)] = fn
        return fn
    return deco


def get_task_impl(backend_name: str, kind: str) -> Callable:
    impl = _TASK_IMPLS.get((backend_name, kind))
    if impl is None:
        have = sorted(k for b, k in _TASK_IMPLS if b == backend_name)
        raise lowering.LoweringError(
            f"backend {backend_name!r} has no impl for task kind {kind!r} "
            f"(has: {have})")
    return impl


class _LMContext:
    """Mutable state one LM forward pass threads through the task impls."""

    def __init__(self, params, cfg, consumer_xspec, packed=None):
        self.params = params
        self.cfg = cfg
        self.consumer_xspec = consumer_xspec   # tensor -> consuming x_spec
        self.packed = packed or {}   # matmul node -> weight packed at lower time
        self.env: Dict[str, torch.Tensor] = {}  # tensor name -> value
        self.specs: Dict[str, Q.QSpec] = {}     # tensor name -> int8 grid

    def put(self, name, value, spec=None):
        self.env[name] = value
        if spec is not None:
            self.specs[name] = spec

    def out_spec(self, tensor: str) -> Q.QSpec:
        """Grid a float task output quantizes onto: its consumer's input
        grid (every float interlude hands an int8 stream to a matmul)."""
        try:
            return self.consumer_xspec[tensor]
        except KeyError:
            raise lowering.LoweringError(
                f"tensor {tensor!r} has no consuming matmul to define its "
                f"quantization grid") from None


def _lm_matmul_prologue(t, ctx):
    """Shared int32 accumulator init: the bias at the product domain
    broadcast over the rows (a stride-0 ``expand``, which the kernel reads
    in place), plus the folded residual stream shift-aligned
    into it (a pure left shift on pow2 grids, so the fold is exact)."""
    mp = ctx.params.matmul(t.layer, t.role)
    x = ctx.env[t.inputs[0]]
    B, S, _ = x.shape
    acc0 = mp.bq[None, :].to(torch.int32).expand(B * S, t.dout)
    if t.skip is not None:
        skip = ctx.env[t.skip].to(torch.int32).reshape(B * S, t.dout)
        acc0 = acc0 + Q.shift_align(
            skip, ctx.params.skip_exp(t.layer, t.role) - mp.product_exp)
    return mp, x.reshape(B * S, t.din), acc0, (B, S)


def _lm_matmul_epilogue(acc, t, mp, shape, ctx):
    if t.fused_relu:
        acc = torch.clamp_min(acc, 0)
    yq = Q.requantize_shift(acc, mp.product_exp, mp.y_spec)
    ctx.put(t.output, yq.reshape(shape + (t.dout,)), mp.y_spec)


def pack_lm_weights(plan, params) -> Dict[str, object]:
    """Every matmul weight of ``plan`` packed once for ``matmul_int8``'s
    wgmma path (``(N, K)``, K-major), by matmul node: what the ``cuda``
    impl reads, built at lower time and never inside a forward."""
    from repro_torch.kernels.matmul_int8.ops import pack_weight

    return {t.node: pack_weight(params.matmul(t.layer, t.role).wq)
            for t in plan.tasks if isinstance(t, lowering.MatmulTask)}


@register_task_impl("cuda", "matmul")
def _cuda_matmul(t, ctx):
    from repro_torch.kernels.matmul_int8.ops import matmul_int8_op

    w = ctx.packed.get(t.node)
    if w is None:
        raise lowering.LoweringError(
            f"matmul {t.node!r}: the cuda impl reads weights packed at lower "
            f"time; build the context with lm_context(plan, params, cfg, "
            f"packed=pack_lm_weights(plan, params))")
    mp, x2d, acc0, shape = _lm_matmul_prologue(t, ctx)
    _lm_matmul_epilogue(matmul_int8_op(x2d, w, acc0), t, mp, shape, ctx)


@register_task_impl("torch-int", "matmul")
def _torch_matmul(t, ctx):
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

    mp, x2d, acc0, shape = _lm_matmul_prologue(t, ctx)
    _lm_matmul_epilogue(matmul_int8_ref(x2d, mp.wq, acc0), t, mp, shape, ctx)


def _lm_attn_qkv(t, ctx):
    """Dequantize the q/k/v streams off their producing matmuls' grids into
    the (B, S, heads, hd) layout both attention cores consume."""
    B, S, _ = ctx.env[t.inputs[0]].shape
    q, k, v = (Q.dequantize(ctx.env[name], ctx.specs[name])
               for name in t.inputs)
    return (q.reshape(B, S, t.heads, t.head_dim),
            k.reshape(B, S, t.kv_heads, t.head_dim),
            v.reshape(B, S, t.kv_heads, t.head_dim))


def _lm_attn_finish(o, t, ctx):
    B, S = o.shape[:2]
    spec = ctx.out_spec(t.output)
    ctx.put(t.output,
            Q.quantize(o.reshape(B, S, t.heads * t.head_dim), spec), spec)


@register_task_impl("cuda", "attention")
def _cuda_attention(t, ctx):
    from repro_torch.kernels.flash_attention.ops import flash_attention_op

    q, k, v = _lm_attn_qkv(t, ctx)
    _lm_attn_finish(flash_attention_op(q, k, v, causal=t.causal), t, ctx)


@register_task_impl("torch-int", "attention")
def _torch_attention(t, ctx):
    from repro_torch.kernels.flash_attention.ops import attn_tiles
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _lm_attn_qkv(t, ctx)
    bq, bk = attn_tiles(q.shape[1], k.shape[1], q.shape[2] // k.shape[2])
    _lm_attn_finish(flash_attention_plain(q, k, v, causal=t.causal, bq=bq,
                                          bk=bk), t, ctx)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (torch's
    ``F.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _lm_scan_operands(t, ctx):
    u, dt, Bc, Cc = (Q.dequantize(ctx.env[name], ctx.specs[name])
                     for name in t.inputs[:4])
    A = ctx.params.layers[t.layer].A
    h0 = torch.zeros((u.shape[0], t.d_inner, t.ssm_state),
                     dtype=torch.float32, device=u.device)
    return u, softplus(dt), A, Bc, Cc, h0


def _lm_scan_finish(y, t, ctx):
    if t.gated:
        y = y * silu(Q.dequantize(ctx.env[t.inputs[4]],
                                  ctx.specs[t.inputs[4]]))
    spec = ctx.out_spec(t.output)
    ctx.put(t.output, Q.quantize(y, spec), spec)


@register_task_impl("cuda", "scan")
def _cuda_scan(t, ctx):
    from repro_torch.kernels.selective_scan.ops import selective_scan_op

    y, _ = selective_scan_op(*_lm_scan_operands(t, ctx))
    _lm_scan_finish(y, t, ctx)


@register_task_impl("torch-int", "scan")
def _torch_scan(t, ctx):
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    y, _ = selective_scan_ref(*_lm_scan_operands(t, ctx))
    _lm_scan_finish(y, t, ctx)


def lm_context(plan, params, cfg, packed=None) -> _LMContext:
    """A fresh forward context of ``plan``: each float task output's grid
    resolved from its consuming matmul's input grid; ``packed`` the
    weights :func:`pack_lm_weights` built (the ``cuda`` matmul reads
    them)."""
    consumer_xspec = {
        t.inputs[0]: params.matmul(t.layer, t.role).x_spec
        for t in plan.tasks if isinstance(t, lowering.MatmulTask)}
    return _LMContext(params, cfg, consumer_xspec, packed)


def embed_tokens(ctx, plan, tokens) -> None:
    """The float embed lookup, quantized onto the embedding grid, as the
    program's first tensor."""
    params = ctx.params
    emb = params.embed[tokens.long()]                     # (B, S, d) float
    ctx.put(plan.embed, Q.quantize(emb, params.emb_spec), params.emb_spec)


def lm_features(impl_backend: str, g, cfg, params: LP.QLMParams) -> Callable:
    """Plan the optimized LM graph (``lowering.plan_lm``), bind every task
    to ``impl_backend``'s registered impl, and close over a ``tokens ->
    int8 hidden state`` forward: the float embed in, then the task program
    over a tensor environment.  Impl binding happens HERE, at lower time,
    so a backend missing a kind fails before anything runs; so does the
    ``cuda`` impls' packing of every matmul weight."""
    plan = lowering.plan_lm(g, params)
    impls = {t.node: get_task_impl(impl_backend, t.kind) for t in plan.tasks}
    packed = pack_lm_weights(plan, params) if impl_backend == "cuda" \
        else None

    def features(tokens):
        ctx = lm_context(plan, params, cfg, packed)
        embed_tokens(ctx, plan, tokens)
        for t in plan.tasks:
            impls[t.node](t, ctx)
        return ctx.env[plan.logits_in]

    return features


def lower_lm(impl_backend: str, g, cfg, params: LP.QLMParams) -> Callable:
    """:func:`lm_features` followed by the float unembed of the last
    position (a plain float32 product, outside any kernel, as in the JAX
    package): ``tokens -> (B, vocab)`` logits."""
    feats = lm_features(impl_backend, g, cfg, params)
    hidden_spec = LP.hidden_out_spec(params)

    def forward(tokens):
        h = Q.dequantize(feats(tokens), hidden_spec)
        return h[:, -1, :] @ params.unembed

    return forward


class _BaseBackend:
    """LM configs go to the task program on the ``lm_impls`` impls; conv
    configs to the backend's ``conv_features``, and ``lower`` follows those
    with the float pool + classifier head."""

    lm_impls: str

    def conv_features(self, g, cfg, params) -> Callable:
        raise NotImplementedError

    def features(self, g, cfg, params) -> Callable:
        if lowering._is_lm_cfg(cfg):
            return lm_features(self.lm_impls, g, cfg, params)
        return self.conv_features(g, cfg, params)

    def lower(self, g, cfg, params) -> Callable:
        if lowering._is_lm_cfg(cfg):
            return lower_lm(self.lm_impls, g, cfg, params)
        feats = self.conv_features(g, cfg, params)
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
class TorchIntBackend(_BaseBackend):
    """Reference integer graph: exact int32 convs, shift requant, residual
    add folded into conv1's accumulator init; for LMs, the kernels' plain
    versions."""

    lm_impls = "torch-int"

    def conv_features(self, g, cfg, params) -> Callable:
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
class CudaStreamBackend(_BaseBackend):
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
    Biases are widened, shifts derived, blocks packed and link tables
    built once, here (``ChainLaunch``, ``ResblockLaunch``), not per call.
    An LM config runs the ``cuda`` task impls: there is no LM chain
    kernel."""

    lm_impls = "cuda"

    def __init__(self, cuts=None, fuse_stem: bool = True, smem_budget=None):
        self.cuts = cuts
        self.fuse_stem = fuse_stem
        self.smem_budget = smem_budget

    def conv_features(self, g, cfg, params) -> Callable:
        from repro_torch.core import dataflow
        from repro_torch.kernels.conv_stem.ops import conv_stem_op
        from repro_torch.kernels.megakernel.ops import (ChainBlockSpec,
                                                        ChainLaunch)
        from repro_torch.kernels.resblock_fused.ops import ResblockLaunch

        plan = lowering.plan_model(g, params)
        chains = lowering.plan_chains(plan, cfg, cuts=self.cuts,
                                      fuse_stem=self.fuse_stem,
                                      smem_budget=self.smem_budget)
        shapes = dataflow.resnet_block_shapes(cfg.blocks_per_stage,
                                              cfg.base_width, cfg.img)
        stem_out, block_outs = activation_out_specs(params, A_SPEC)
        st = params.stem
        stem_op = (st.wq, st.bq.to(torch.int32))
        stem_shift = stem_out.exp - st.product_exp
        operands = _block_operands(params, plan, block_outs)

        # the launch sequence, fixed at lower time: every block kernel is a
        # prepared launch (operands validated and packed, link table built),
        # so a call only allocates its output and launches
        def stem_step(h):
            return conv_stem_op(h, *stem_op, shift=stem_shift)

        steps = [] if chains and chains[0].stem is not None else [stem_step]
        for chain in chains:
            if len(chain.blocks) == 1 and chain.stem is None:
                # singleton chain: the chain kernel would add nothing
                task, = chain.blocks
                ws, sh = operands[task.index]
                steps.append(ResblockLaunch(
                    *(ws if task.has_ds else ws + (None, None)),
                    stride=task.stride, **sh))
                continue
            fused = chain.stem is not None
            head = shapes[chain.blocks[0].index]
            steps.append(ChainLaunch(
                tuple(operands[t.index][0] for t in chain.blocks),
                specs=tuple(ChainBlockSpec(stride=t.stride, has_ds=t.has_ds,
                                           **operands[t.index][1])
                            for t in chain.blocks),
                in_shape=(cfg.img, cfg.img, dataflow.STEM_CIN) if fused
                else (head.h, head.w, head.ich),
                stem=stem_op if fused else None,
                stem_shift=stem_shift if fused else None,
                config=chain.config))

        def features(images):
            h = Q.quantize(images, st.x_spec)
            for step in steps:
                h = step(h)
            return h

        features.steps = tuple(steps)   # the launch objects, for the tests
        return features


@register_backend("cuda")
class CudaBackend(CudaStreamBackend):
    """Fused kernel pipeline: one ``conv_stem`` launch, then one
    ``resblock_fused`` launch per residual block (conv0 + ReLU/requant +
    optional 1x1 downsample + add-fold + conv1 + ReLU/requant, with y0 and
    the skip kept in shared memory).  It is the streaming pipeline with no
    chain: at a shared-memory budget of 0 bytes the planner makes every
    block a singleton chain, which runs ``resblock_fused``, and the stem
    stays unfused.  An LM runs ``matmul_int8`` on every projection,
    ``flash_attention`` on attention and ``selective_scan`` on the scan."""

    def __init__(self):
        super().__init__(fuse_stem=False, smem_budget=0)
