"""Graph-driven lowering: optimized IR -> ordered task program.

A node-kind -> handler registry (:func:`register_task`) drives a walk over
the **topologically sorted** optimized graph.  The walk is strict: it
requires the post-optimization invariants (no bn / relu / add nodes; skip
streams wired) and raises :class:`LoweringError` naming the offending node,
its kind and the failed check, so a backend never compiles the unoptimized
dataflow.

Task kinds: ``StemTask`` / ``BlockTask`` / ``HeadTask`` for the conv
pipeline; ``MatmulTask`` (one int8 matmul, optionally with fused ReLU and
the residual add folded into its accumulator init) and ``AttentionTask`` /
``ScanTask`` (the float interludes of the LM graphs) for the LMs; the
``mamba1`` family's node kinds (``register_task(op, family=)``) add
``NormTask``, ``Conv1dTask`` and ``Mamba1ScanTask``.

Entry points: :func:`plan_model` (conv graphs -> ``LoweringPlan``),
:func:`plan_lm` (LM graphs -> ``LMPlan``) and :func:`plan_chains` (a
plan's blocks -> streaming ``ChainTask`` runs, the front half of the
``cuda-stream`` backend).  The ``config`` field of the tasks is the slot
for a tuned kernel configuration: :func:`annotate_tuning` stamps one onto a
node (``attrs["kcfg"]``) and the walk carries it into the task; without a
tuning it is ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import graph as G
from repro_torch.compile.params import QResNetParams
from repro_torch.tune.config import KernelConfig


class LoweringError(ValueError):
    """The graph does not satisfy the optimized-IR invariants."""


def _node_err(node: G.Node, check: str) -> LoweringError:
    """Every strictness failure carries node id + kind + the check."""
    return LoweringError(f"node {node.name!r} (kind={node.op}): {check}")


# ---------------------------------------------------------------------------
# Task records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StemTask:
    node: str                 # graph node name
    och: int
    config: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class BlockTask:
    index: int                # block index (== params.blocks[index])
    conv0: str                # graph node names, for provenance/debugging
    conv1: str
    stride: int
    has_ds: bool              # 1x1 downsample merged into conv0 (loop_merge)
    och: int
    config: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class HeadTask:
    pool: str                 # pool kind ("avg")
    num_classes: int


@dataclasses.dataclass(frozen=True)
class MatmulTask:
    """One int8 matmul node: inputs[0] @ W(layer, role) in int32, optional
    fused ReLU, requantized onto the role's output grid.  ``skip`` names the
    tensor whose int8 stream initializes the accumulator (the add-fold);
    None means a plain matmul."""
    kind = "matmul"
    node: str
    layer: int
    role: str
    din: int
    dout: int
    inputs: Tuple[str, ...]
    output: str
    skip: Optional[str] = None
    fused_relu: bool = False
    config: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class AttentionTask:
    """Causal (flash) attention over the layer's q/k/v streams."""
    kind = "attention"
    node: str
    layer: int
    heads: int
    kv_heads: int
    head_dim: int
    causal: bool
    inputs: Tuple[str, ...]   # (q, k, v) tensor names
    output: str
    config: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class ScanTask:
    """Mamba1 selective scan; ``gated`` multiplies by silu(z) (inputs[4])."""
    kind = "scan"
    node: str
    layer: int
    d_inner: int
    ssm_state: int
    gated: bool
    inputs: Tuple[str, ...]   # (u, dt, B, C[, z]) tensor names
    output: str
    config: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class NormTask:
    """RMS norm over the last dim (a float interlude): the RMSNorm before a
    Mamba1 mixer (``splits`` None, times the layer's gain), or the
    weightless rms of each part of ``x_proj``'s output (``splits``: the
    parts' widths, one output each)."""
    kind = "norm"
    node: str
    layer: int
    eps: float
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    splits: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class Conv1dTask:
    """The causal depthwise int8 conv over the sequence of the first
    ``channels`` columns of its input, requantized, then SiLU (a float
    interlude) onto the consuming matmul's grid."""
    kind = "conv1d"
    node: str
    layer: int
    channels: int
    kernel: int
    inputs: Tuple[str, ...]
    output: str


@dataclasses.dataclass(frozen=True)
class Mamba1ScanTask:
    """The published Mamba1 scan as one float interlude: softplus of dt,
    ``A = -exp(A_log)``, the selective scan, the D skip and the SiLU gate of
    the last ``d_inner`` columns of inputs[4] ([u | z])."""
    kind = "scan"
    node: str
    layer: int
    d_inner: int
    ssm_state: int
    inputs: Tuple[str, ...]   # (u, dt, B, C, [u | z]) tensor names
    output: str
    config: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class ChainTask:
    """A run of consecutive residual blocks fused into ONE ``block_chain``
    launch, optionally with the stem conv at its head.  The chain's config
    is its first member's (the chain kernel's only knob is
    ``batch_tile``)."""
    blocks: tuple             # Tuple[BlockTask, ...], consecutive indices
    stem: Optional[StemTask] = None

    @property
    def config(self) -> Optional[object]:
        if self.stem is not None and self.stem.config is not None:
            return self.stem.config
        return self.blocks[0].config if self.blocks else None

    def describe(self) -> str:
        parts = (["stem"] if self.stem is not None else []) + \
            [f"b{t.index}" for t in self.blocks]
        return "+".join(parts)


@dataclasses.dataclass(frozen=True)
class LoweringPlan:
    stem: StemTask
    blocks: List[BlockTask]
    head: HeadTask


@dataclasses.dataclass(frozen=True)
class LMPlan:
    """An LM graph lowered to an ordered task program: the tasks run in
    topological order over a tensor-name environment, bracketed by the float
    embed / unembed head."""
    tasks: Tuple[object, ...]          # Matmul/Attention/ScanTask, ordered
    embed: str                         # embed node's output tensor
    logits_in: str                     # tensor entering the unembed head
    vocab: int
    seq_len: int
    family: Optional[str] = None       # the embed node's, where it names one
    head_norm_eps: Optional[float] = None   # RMSNorm before the unembed


# ---------------------------------------------------------------------------
# Node-kind -> handler registry
# ---------------------------------------------------------------------------

# handler(node, state) -> None; mutates the walk state.
TASK_HANDLERS: Dict[str, Callable] = {}
# the node kinds of one LM family beyond TASK_HANDLERS, walked only in that
# family's graphs (named by the embed node's ``family`` attr)
FAMILY_HANDLERS: Dict[str, Dict[str, Callable]] = {}


def register_task(op: str, family: Optional[str] = None):
    """Register the lowering handler for one node kind (latest wins); with
    ``family``, for that family's graphs only."""
    def deco(fn):
        table = TASK_HANDLERS if family is None else \
            FAMILY_HANDLERS.setdefault(family, {})
        table[op] = fn
        return fn
    return deco


def graph_family(g: G.Graph) -> Optional[str]:
    """The LM family an embed node of ``g`` names, or None."""
    return next((n.attrs.get("family") for n in g.nodes
                 if n.op == "embed"), None)


@dataclasses.dataclass
class _WalkState:
    """Accumulator the handlers write into while the walk runs."""
    g: G.Graph
    stem: Optional[StemTask] = None
    blocks: List[BlockTask] = dataclasses.field(default_factory=list)
    head_pool: Optional[str] = None
    head_fc: Optional[int] = None
    pending_conv0: Optional[G.Node] = None
    tasks: List[object] = dataclasses.field(default_factory=list)
    embed: Optional[G.Node] = None
    unembed: Optional[G.Node] = None
    head_norm: Optional[G.Node] = None


def _walk(g: G.Graph) -> _WalkState:
    """Topological sort, then registry dispatch per node (the graph's
    family's handlers on top of the shared ones).  Unregistered kinds fail
    loudly with the node id."""
    state = _WalkState(g=g)
    handlers = dict(TASK_HANDLERS, **FAMILY_HANDLERS.get(graph_family(g),
                                                         {}))
    for n in G.topological_sort(g):
        handler = handlers.get(n.op)
        if handler is None:
            raise _node_err(
                n, f"no lowering handler registered for this kind "
                   f"(registered: {sorted(handlers)})")
        handler(n, state)
    return state


@register_task("input")
@register_task("output")
def _lower_noop(n: G.Node, state: _WalkState) -> None:
    del n, state


@register_task("conv")
def _lower_conv(n: G.Node, state: _WalkState) -> None:
    """The conv pipeline's pairing walk (stem, conv0/conv1 pairs)."""
    role = n.attrs.get("role")
    if role == "stem":
        if not {"bn", "relu"} <= set(n.fused):
            raise _node_err(n, "stem conv must have bn+relu folded in "
                               "(fold_bn/merge_relu did not run)")
        state.stem = StemTask(node=n.name, och=n.attrs["och"],
                              config=n.attrs.get("kcfg"))
    elif role == "conv0":
        if state.pending_conv0 is not None:
            raise _node_err(
                n, f"conv0 follows unpaired conv0 "
                   f"{state.pending_conv0.name!r}")
        if not n.skip_out:
            raise _node_err(n, "conv0 emits no skip stream — "
                               "loop_merge/temporal_reuse did not run")
        state.pending_conv0 = n
    elif role == "conv1":
        c0 = state.pending_conv0
        if c0 is None or c0.attrs["block"] != n.attrs["block"]:
            raise _node_err(n, "conv1 without its conv0 (pairing check)")
        if n.skip_in is None or "add_fold" not in n.fused:
            raise _node_err(n, "residual add not folded into conv1 "
                               "(add_fold did not run)")
        if n.skip_in not in c0.outputs[1:]:
            raise _node_err(
                n, f"skip input {n.skip_in!r} is not conv0's forwarded "
                   f"stream {c0.outputs[1:]}")
        state.blocks.append(BlockTask(
            index=n.attrs["block"], conv0=c0.name, conv1=n.name,
            stride=c0.attrs["stride"],
            has_ds=any(f.startswith("downsample:") for f in c0.fused),
            och=n.attrs["och"], config=c0.attrs.get("kcfg")))
        state.pending_conv0 = None
    elif role == "ds":
        raise _node_err(n, "standalone downsample conv survived — "
                           "loop_merge did not run")
    else:
        raise _node_err(n, "conv without a role attr")


@register_task("pool")
def _lower_pool(n: G.Node, state: _WalkState) -> None:
    state.head_pool = n.attrs.get("kind", "avg")


@register_task("linear")
def _lower_linear(n: G.Node, state: _WalkState) -> None:
    state.head_fc = n.attrs.get("dout")


@register_task("matmul")
def _lower_matmul(n: G.Node, state: _WalkState) -> None:
    if n.attrs.get("role") is None or n.attrs.get("layer") is None:
        raise _node_err(n, "matmul without role/layer attrs — cannot bind "
                           "to a parameter slot")
    state.tasks.append(MatmulTask(
        node=n.name, layer=n.attrs["layer"], role=n.attrs["role"],
        din=n.attrs["din"], dout=n.attrs["dout"],
        inputs=tuple(n.inputs), output=n.outputs[0],
        skip=n.skip_in, fused_relu="relu" in n.fused,
        config=n.attrs.get("kcfg")))


@register_task("attention")
def _lower_attention(n: G.Node, state: _WalkState) -> None:
    if len(n.inputs) != 3:
        raise _node_err(n, f"attention needs (q, k, v) inputs, got "
                           f"{len(n.inputs)}")
    state.tasks.append(AttentionTask(
        node=n.name, layer=n.attrs["layer"], heads=n.attrs["heads"],
        kv_heads=n.attrs["kv_heads"], head_dim=n.attrs["head_dim"],
        causal=n.attrs.get("causal", True),
        inputs=tuple(n.inputs), output=n.outputs[0],
        config=n.attrs.get("kcfg")))


@register_task("scan")
def _lower_scan(n: G.Node, state: _WalkState) -> None:
    gated = n.attrs.get("gated", False)
    want = 5 if gated else 4
    if len(n.inputs) != want:
        raise _node_err(n, f"scan needs (u, dt, B, C{', z' if gated else ''})"
                           f" inputs, got {len(n.inputs)}")
    state.tasks.append(ScanTask(
        node=n.name, layer=n.attrs["layer"], d_inner=n.attrs["d_inner"],
        ssm_state=n.attrs["ssm_state"], gated=gated,
        inputs=tuple(n.inputs), output=n.outputs[0],
        config=n.attrs.get("kcfg")))


@register_task("norm", family="mamba1")
def _lower_norm(n: G.Node, state: _WalkState) -> None:
    if n.attrs.get("head"):
        state.head_norm = n       # the float head's, not a task
        return
    state.tasks.append(NormTask(
        node=n.name, layer=n.attrs["layer"], eps=n.attrs["eps"],
        inputs=tuple(n.inputs), outputs=tuple(n.outputs)))


@register_task("rms_split", family="mamba1")
def _lower_rms_split(n: G.Node, state: _WalkState) -> None:
    splits = tuple(n.attrs["splits"])
    if len(splits) != len(n.outputs):
        raise _node_err(n, f"rms_split has {len(splits)} parts but "
                           f"{len(n.outputs)} outputs")
    state.tasks.append(NormTask(
        node=n.name, layer=n.attrs["layer"], eps=n.attrs["eps"],
        inputs=tuple(n.inputs), outputs=tuple(n.outputs), splits=splits))


@register_task("conv1d", family="mamba1")
def _lower_conv1d(n: G.Node, state: _WalkState) -> None:
    state.tasks.append(Conv1dTask(
        node=n.name, layer=n.attrs["layer"], channels=n.attrs["channels"],
        kernel=n.attrs["kernel"], inputs=tuple(n.inputs),
        output=n.outputs[0]))


@register_task("mamba1_scan", family="mamba1")
def _lower_mamba1_scan(n: G.Node, state: _WalkState) -> None:
    if len(n.inputs) != 5:
        raise _node_err(n, f"mamba1_scan needs (u, dt, B, C, [u | z]) "
                           f"inputs, got {len(n.inputs)}")
    state.tasks.append(Mamba1ScanTask(
        node=n.name, layer=n.attrs["layer"], d_inner=n.attrs["d_inner"],
        ssm_state=n.attrs["ssm_state"], inputs=tuple(n.inputs),
        output=n.outputs[0], config=n.attrs.get("kcfg")))


@register_task("embed")
def _lower_embed(n: G.Node, state: _WalkState) -> None:
    state.embed = n


@register_task("unembed")
def _lower_unembed(n: G.Node, state: _WalkState) -> None:
    state.unembed = n


# ---------------------------------------------------------------------------
# Graph builders (dispatch on config kind) and the plan entry points
# ---------------------------------------------------------------------------


def _is_lm_cfg(cfg) -> bool:
    return hasattr(cfg, "seq_len") and getattr(cfg, "family", None) in (
        "dense", "ssm", "mamba1")


def model_graph(cfg) -> G.Graph:
    """The (unoptimized) IR for a config — what the paper parses from the
    QONNX export.  ResNet configs build the conv graph; LM configs
    (``compile.lm_params.QLMConfig``) build the transformer / Mamba stack:
    ``ssm`` the reduced block, ``mamba1`` the published one."""
    if _is_lm_cfg(cfg):
        if cfg.family == "dense":
            return G.build_transformer_graph(cfg, cfg.seq_len)
        if cfg.family == "mamba1":
            return G.build_mamba1_graph(cfg, cfg.seq_len)
        return G.build_ssm_graph(cfg, cfg.seq_len)
    return G.build_resnet_graph(cfg.blocks_per_stage, cfg.base_width,
                                cfg.img, cfg.num_classes)


def optimized_graph(cfg) -> G.Graph:
    if _is_lm_cfg(cfg):
        return G.optimize_lm(model_graph(cfg))
    return G.optimize(model_graph(cfg))


def tuning_key(n: G.Node) -> Optional[str]:
    """The tuning-dict key of one lowered graph node (None if the node has
    no tunable task): conv tasks keep the ``stem``/``block{i}`` keys; LM
    tasks are ``layer{i}/{role}`` (e.g. ``layer0/wq``, ``layer1/attn``)."""
    if n.op == "conv":
        role = n.attrs.get("role")
        if role == "stem":
            return "stem"
        if role == "conv0":
            return f"block{n.attrs['block']}"
        return None
    if n.op in ("matmul", "attention", "scan"):
        return f"layer{n.attrs['layer']}/{n.attrs.get('role', n.op)}"
    return None


def annotate_tuning(g: G.Graph, tuning) -> G.Graph:
    """Stamp tuned :class:`KernelConfig`\\ s onto the optimized graph's task
    nodes (``attrs["kcfg"]``) so the plan carries them into the tasks and
    any backend sees the same assignment.  ``tuning`` maps task keys
    (:func:`tuning_key`) to configs or their dict form."""
    if not tuning:
        return g
    for n in g.nodes:
        key = tuning_key(n)
        if key is None:
            continue
        c = tuning.get(key)
        if c is not None:
            if not isinstance(c, KernelConfig):
                c = KernelConfig.from_dict(c)
            n.attrs["kcfg"] = c
    return g


def _check_optimized(g: G.Graph) -> None:
    for n in g.nodes:
        if n.op in ("bn", "relu", "add"):
            raise _node_err(
                n, f"graph still contains a {n.op} node — run "
                   f"core.graph.optimize() (or optimize_lm) before lowering")


def plan_model(g: G.Graph,
               params: Optional[QResNetParams] = None) -> LoweringPlan:
    """Walk an optimized conv graph into the ordered task list.

    When ``params`` is given, the plan is cross-checked against the parameter
    containers (block count, downsample presence), so a graph/params
    mismatch fails at compile time, not with silently wrong logits."""
    _check_optimized(g)
    state = _walk(g)

    if state.stem is None or state.head_pool is None or state.head_fc is None:
        raise LoweringError(
            "graph is missing stem / pool / classifier nodes "
            "(not a lowered conv graph?)")
    if state.pending_conv0 is not None:
        raise _node_err(state.pending_conv0, "unpaired conv0 at end of walk")

    plan = LoweringPlan(stem=state.stem, blocks=state.blocks,
                        head=HeadTask(pool=state.head_pool,
                                      num_classes=state.head_fc))

    if params is not None:
        if len(params.blocks) != len(plan.blocks):
            raise LoweringError(
                f"graph has {len(plan.blocks)} residual blocks but params "
                f"carry {len(params.blocks)}")
        for t in plan.blocks:
            if params.blocks[t.index].has_ds != t.has_ds:
                raise LoweringError(
                    f"block {t.index} (node {t.conv0!r}): graph "
                    f"downsample={t.has_ds} but params "
                    f"downsample={params.blocks[t.index].has_ds}")
    return plan


def plan_lm(g: G.Graph, params=None) -> LMPlan:
    """Walk an optimized LM graph into the ordered task program.

    Strictness: adds must be folded (``add_fold_matmul``), ReLUs merged,
    embed/unembed present.  When ``params`` (a
    :class:`~repro_torch.compile.lm_params.QLMParams`) is given, every
    matmul task's (layer, role) binding is resolved against it at plan
    time."""
    _check_optimized(g)
    state = _walk(g)

    if state.embed is None or state.unembed is None:
        raise LoweringError(
            "graph is missing embed / unembed nodes (not an LM graph?)")
    if not state.tasks:
        raise LoweringError("LM graph lowered to zero tasks")
    if state.stem is not None or state.blocks:
        raise LoweringError(
            "graph mixes conv and LM task kinds — no backend lowers both "
            "in one plan")

    if params is not None:
        if len({t.layer for t in state.tasks}) != len(params.layers):
            raise LoweringError(
                f"graph has {len({t.layer for t in state.tasks})} layers "
                f"but params carry {len(params.layers)}")
        for t in state.tasks:
            if isinstance(t, MatmulTask):
                mp = params.matmul(t.layer, t.role)   # raises KeyError
                if tuple(mp.wq.shape) != (t.din, t.dout):
                    raise LoweringError(
                        f"node {t.node!r} (kind=matmul): weight shape "
                        f"{tuple(mp.wq.shape)} != graph ({t.din}, {t.dout})")

    logits_in, eps = state.unembed.inputs[0], None
    if state.head_norm is not None:
        if state.head_norm.outputs[0] != logits_in:
            raise _node_err(state.head_norm,
                            "head norm does not feed the unembed")
        logits_in, eps = state.head_norm.inputs[0], state.head_norm.attrs[
            "eps"]
    return LMPlan(tasks=tuple(state.tasks),
                  embed=state.embed.outputs[0],
                  logits_in=logits_in,
                  vocab=state.unembed.attrs["dout"],
                  seq_len=state.embed.attrs["seq_len"],
                  family=state.embed.attrs.get("family"),
                  head_norm_eps=eps)


def plan_chains(plan: LoweringPlan, cfg,
                cuts: Optional[Sequence[Sequence[int]]] = None,
                fuse_stem: bool = True,
                smem_budget: Optional[int] = None) -> List[ChainTask]:
    """Partition the plan's block sequence into streaming chains — the front
    half of the ``cuda-stream`` backend.

    ``cuts`` (optional) is an explicit partition as lists of block indices;
    it must be consecutive runs covering every block exactly once (any such
    partition is arithmetically legal — the chain-cut property — so an
    explicit cut is only shape-checked, not budget-checked).  Without it
    the greedy planner (``tune.space.chain_cut_points``) picks the longest
    runs whose ``block_chain`` thread block fits ``smem_budget`` (default
    ``tune.space.SMEM_BUDGET``).  ``fuse_stem`` pulls the stem conv into
    the first chain when that chain stays legal with it; otherwise the stem
    runs as its own ``conv_stem`` kernel."""
    from repro_torch.core import dataflow
    from repro_torch.tune import space as tspace

    budget = tspace.SMEM_BUDGET if smem_budget is None else smem_budget
    shapes = dataflow.resnet_block_shapes(cfg.blocks_per_stage,
                                          cfg.base_width, cfg.img)
    if len(shapes) != len(plan.blocks):
        raise LoweringError(
            f"config yields {len(shapes)} block shapes but the plan has "
            f"{len(plan.blocks)} blocks")

    stem_och = cfg.base_width if fuse_stem else 0
    if cuts is None:
        # legality at batch_tile=1 is the binding constraint (any batch
        # bucket admits bt=1), so the partition is bucket-independent
        cuts = tspace.chain_cut_points(shapes, batch=1, stem_och=stem_och,
                                       smem_budget=budget)
    else:
        seen = [i for run in cuts for i in run]
        if seen != list(range(len(plan.blocks))):
            raise LoweringError(
                f"chain cuts {cuts} are not a partition of blocks "
                f"0..{len(plan.blocks) - 1} into consecutive runs")

    chains = []
    for run in cuts:
        stem = None
        if fuse_stem and run and run[0] == 0:
            # the stem joins the first chain only if the joined chain still
            # has a legal tiling; otherwise it stays a separate kernel
            if tspace.chain_space([shapes[i] for i in run], batch=1,
                                  stem_och=cfg.base_width,
                                  smem_budget=budget):
                stem = plan.stem
        chains.append(ChainTask(
            blocks=tuple(plan.blocks[i] for i in run), stem=stem))
    return chains
