"""QONNX-like NN graph IR + the paper's graph optimizations (§III-B, §III-G).

Pure Python: the same IR and passes as ``repro.core.graph``, kept as the
port's own copy.

  passes (in the order the paper applies them):
    1. ``fold_bn``        — merge BatchNorm into the preceding conv (§III-A)
    2. ``merge_relu``     — fuse ReLU into the producing conv's requantization
    3. ``loop_merge``     — residual block WITH downsample: merge the pointwise
                            downsample conv into conv0's task (Fig. 12b)
    4. ``temporal_reuse`` — residual block WITHOUT downsample: forward the
                            skip stream out of conv0's window buffer (Fig. 12a)
    5. ``add_fold``       — delete the Add node; the skip stream initializes
                            conv1's accumulator (Fig. 13)

After passes 3-5 every residual block is two fused tasks, which is what the
``resblock_fused`` kernel executes in one launch.

LM graphs (``build_transformer_graph``, ``build_ssm_graph``,
``build_mamba1_graph``) take
``optimize_lm`` instead: ReLU merged into its matmul, every residual Add
folded into a matmul's accumulator (``add_fold_matmul``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import dataflow


@dataclasses.dataclass
class Node:
    name: str
    op: str                       # conv | relu | bn | add | pool | linear | input | output
    inputs: List[str]             # tensor names
    outputs: List[str]
    attrs: dict = dataclasses.field(default_factory=dict)
    # set by passes:
    fused: List[str] = dataclasses.field(default_factory=list)   # ops folded into this task
    skip_out: bool = False        # emits a forwarded skip stream (temporal reuse / loop merge)
    skip_in: Optional[str] = None  # tensor that initializes this conv's accumulator (add_fold)


@dataclasses.dataclass
class Graph:
    nodes: List[Node]

    def producers(self) -> Dict[str, Node]:
        return {t: n for n in self.nodes for t in n.outputs}

    def remove(self, names):
        names = set(names)
        self.nodes = [n for n in self.nodes if n.name not in names]

    def validate(self):
        prod = self.producers()
        for n in self.nodes:
            for t in n.inputs:
                if t not in prod and not t.startswith("%in"):
                    raise ValueError(f"{n.name}: dangling input {t}")
        return True


def topological_sort(g: Graph) -> List[Node]:
    """Kahn's algorithm; among ready nodes the one earliest in ``g.nodes``
    goes first, so the same node list always yields the same sequence.
    Raises on cycles."""
    prod = g.producers()
    indeg = {n.name: 0 for n in g.nodes}
    edges: Dict[str, List[str]] = {n.name: [] for n in g.nodes}
    for n in g.nodes:
        for t in n.inputs:
            p = prod.get(t)
            if p is not None and p.name != n.name:
                edges[p.name].append(n.name)
                indeg[n.name] += 1
    order_idx = {n.name: i for i, n in enumerate(g.nodes)}
    by_name = {n.name: n for n in g.nodes}
    ready = sorted((name for name, d in indeg.items() if d == 0),
                   key=order_idx.__getitem__)
    out: List[Node] = []
    while ready:
        name = ready.pop(0)
        out.append(by_name[name])
        changed = False
        for succ in edges[name]:
            indeg[succ] -= 1
            if indeg[succ] == 0:
                ready.append(succ)
                changed = True
        if changed:
            ready.sort(key=order_idx.__getitem__)
    if len(out) != len(g.nodes):
        stuck = sorted(n for n, d in indeg.items() if d > 0)
        raise ValueError(f"graph has a cycle through {stuck}")
    return out


# ---------------------------------------------------------------------------
# Pass 1-2: BN folding and ReLU merging
# ---------------------------------------------------------------------------


def fold_bn(g: Graph) -> Graph:
    """conv -> bn  ==>  conv (with fused flag).  The weight arithmetic lives
    in ``quant.fold_batchnorm``; here only the graph is rewritten."""
    prod = g.producers()
    dead = []
    for n in list(g.nodes):
        if n.op != "bn":
            continue
        src = prod.get(n.inputs[0])
        if src is not None and src.op == "conv":
            src.fused.append("bn")
            src.outputs = list(n.outputs)
            dead.append(n.name)
    g.remove(dead)
    return g


def merge_relu(g: Graph) -> Graph:
    prod = g.producers()
    dead = []
    for n in list(g.nodes):
        if n.op != "relu":
            continue
        src = prod.get(n.inputs[0])
        if src is not None and src.op in ("conv", "add", "linear", "matmul"):
            src.fused.append("relu")
            src.outputs = list(n.outputs)
            dead.append(n.name)
    g.remove(dead)
    return g


# ---------------------------------------------------------------------------
# Residual block detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResidualBlock:
    producer: Node            # node whose output tensor feeds both branches
    conv0: Node
    conv1: Node
    add: Node
    downsample: Optional[Node]  # pointwise conv on the short branch, if any


def find_residual_blocks(g: Graph) -> List[ResidualBlock]:
    """A residual block = a tensor consumed by (a) a long branch conv chain of
    length 2 and (b) either the Add directly or a pointwise conv then the Add."""
    prod = g.producers()
    blocks = []
    for n in g.nodes:
        if n.op != "add":
            continue
        a, b = n.inputs[:2]
        pa, pb = prod.get(a), prod.get(b)
        if pa is None or pb is None:
            continue
        for long_end, short_end in ((pa, pb), (pb, pa)):
            if long_end.op != "conv":
                continue
            conv0 = prod.get(long_end.inputs[0])
            if conv0 is None or conv0.op != "conv":
                continue
            src_tensor = conv0.inputs[0]
            # post-rewrite form (after loop_merge/temporal_reuse): the skip
            # stream is emitted by conv0 itself as a secondary output
            t_short = a if short_end is pa else b
            if short_end is conv0 and conv0.skip_out and \
                    t_short in conv0.outputs[1:]:
                blocks.append(ResidualBlock(conv0, conv0, long_end, n, None))
                break
            # short branch: either src_tensor directly, or pointwise conv of it
            if short_end.outputs and short_end.op == "conv" and \
                    short_end.inputs[0] == src_tensor and \
                    short_end.attrs.get("fh", 1) == 1 and \
                    short_end.attrs.get("fw", 1) == 1:
                blocks.append(ResidualBlock(prod.get(src_tensor) or conv0,
                                            conv0, long_end, n, short_end))
                break
            if short_end is prod.get(src_tensor) or (
                    short_end.outputs and src_tensor in short_end.outputs):
                blocks.append(ResidualBlock(short_end, conv0, long_end, n,
                                            None))
                break
    return blocks


# ---------------------------------------------------------------------------
# Pass 3-5: the paper's residual optimizations
# ---------------------------------------------------------------------------


def loop_merge(g: Graph) -> Graph:
    """Fig. 12b: residual block WITH downsample — merge the pointwise conv into
    conv0's task, which then also emits the downsampled skip stream."""
    for blk in find_residual_blocks(g):
        if blk.downsample is None:
            continue
        ds = blk.downsample
        blk.conv0.fused.append(f"downsample:{ds.name}")
        blk.conv0.skip_out = True
        blk.conv0.outputs = blk.conv0.outputs + [ds.outputs[0]]
        g.remove([ds.name])
    return g


def temporal_reuse(g: Graph) -> Graph:
    """Fig. 12a: residual block WITHOUT downsample — the skip stream is
    forwarded from conv0's window buffer after last use (second output
    stream); the tensor is never buffered twice."""
    for blk in find_residual_blocks(g):
        if blk.downsample is not None or blk.conv0.skip_out:
            continue  # blocks already handled by loop_merge
        src_tensor = blk.conv0.inputs[0]
        fwd = src_tensor + ".fwd"
        blk.conv0.fused.append("temporal_reuse")
        blk.conv0.skip_out = True
        blk.conv0.outputs = blk.conv0.outputs + [fwd]
        blk.add.inputs = [fwd if t == src_tensor else t
                          for t in blk.add.inputs]
    return g


def add_fold(g: Graph) -> Graph:
    """Fig. 13: remove the Add; its skip input initializes conv1's
    accumulator."""
    for blk in find_residual_blocks(g):
        add = blk.add
        skip = [t for t in add.inputs if t not in blk.conv1.outputs]
        if not skip:
            continue
        blk.conv1.skip_in = skip[0]
        blk.conv1.fused.append("add_fold")
        blk.conv1.fused.extend(f for f in add.fused)  # e.g. trailing relu
        blk.conv1.outputs = list(add.outputs)
        g.remove([add.name])
    return g


def optimize(g: Graph) -> Graph:
    """The full §III-G pipeline in paper order."""
    g = fold_bn(g)
    g = merge_relu(g)
    g = loop_merge(g)
    g = temporal_reuse(g)
    g = add_fold(g)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Buffering audit — ties the IR to the eq. 21/22 accounting
# ---------------------------------------------------------------------------


def skip_buffer_report(g_before: Graph, g_after: Graph) -> List[dict]:
    """For every residual block, report the skip buffering before (receptive
    field, eq. 21) and after (conv1 window buffer, eq. 22) optimization."""
    out = []
    g_before = merge_relu(fold_bn(g_before))  # blocks are visible post-folding
    for blk in find_residual_blocks(g_before):
        c0, c1 = blk.conv0.attrs, blk.conv1.attrs
        before = dataflow.skip_buffer_receptive_field(
            iw0=c0["iw"], ich0=c0["ich"], fh0=c0["fh"], fw0=c0["fw"],
            fh1=c1["fh"], fw1=c1["fw"],
        )
        after = dataflow.window_buffer_size(
            iw=c1["iw"], ich=c1["ich"], fh=c1["fh"], fw=c1["fw"]
        )
        out.append(dict(block=blk.add.name, before=before, after=after,
                        ratio=after / before))
    return out


# ---------------------------------------------------------------------------
# ResNet graph builders (mirror models/resnet.py)
# ---------------------------------------------------------------------------


def _conv(name, tin, tout, ich, och, iw, ih, fh=3, fw=3, stride=1,
          role=None, block=None):
    """``role``/``block`` bind a conv node to its parameter slot (stem |
    conv0 | conv1 | ds, block index) — the handle the lowering uses to fetch
    weights for each fused task."""
    return Node(name, "conv", [tin], [tout],
                dict(ich=ich, och=och, iw=iw, ih=ih, fh=fh, fw=fw,
                     stride=stride, ow=iw // stride, oh=ih // stride,
                     role=role, block=block))


def build_resnet_graph(num_blocks_per_stage: int, base_width: int = 16,
                       img: int = 32, num_classes: int = 10) -> Graph:
    """CIFAR ResNet family (ResNet8: 1 block/stage; ResNet20: 3)."""
    nodes = [Node("input", "input", ["%in"], ["t0"])]
    nodes.append(_conv("stem", "t0", "t1", 3, base_width, img, img,
                       role="stem"))
    nodes.append(Node("stem_bn", "bn", ["t1"], ["t1b"]))
    nodes.append(Node("stem_relu", "relu", ["t1b"], ["t1r"]))
    tin, ich, res, idx = "t1r", base_width, img, 0
    for stage in range(3):
        och = base_width * (2 ** stage)
        for b in range(num_blocks_per_stage):
            stride = 2 if (stage > 0 and b == 0) else 1
            ow = res // stride
            t0 = f"s{stage}b{b}c0"
            nodes.append(_conv(f"conv{idx}_0", tin, t0, ich, och, res, res,
                               stride=stride, role="conv0", block=idx))
            nodes.append(Node(f"bn{idx}_0", "bn", [t0], [t0 + "b"]))
            nodes.append(Node(f"relu{idx}_0", "relu", [t0 + "b"],
                              [t0 + "r"]))
            t1 = f"s{stage}b{b}c1"
            nodes.append(_conv(f"conv{idx}_1", t0 + "r", t1, och, och, ow,
                               ow, role="conv1", block=idx))
            nodes.append(Node(f"bn{idx}_1", "bn", [t1], [t1 + "b"]))
            if stride != 1 or ich != och:
                ds = f"s{stage}b{b}ds"
                nodes.append(_conv(f"ds{idx}", tin, ds, ich, och, res, res,
                                   fh=1, fw=1, stride=stride, role="ds",
                                   block=idx))
                skip = ds
            else:
                skip = tin
            tadd = f"s{stage}b{b}add"
            nodes.append(Node(f"add{idx}", "add", [t1 + "b", skip], [tadd]))
            nodes.append(Node(f"relu{idx}_a", "relu", [tadd], [tadd + "r"]))
            tin, ich, res = tadd + "r", och, ow
            idx += 1
    nodes.append(Node("pool", "pool", [tin], ["tp"],
                      dict(kind="avg", ih=res, iw=res, ich=ich)))
    nodes.append(Node("fc", "linear", ["tp"], ["logits"],
                      dict(din=ich, dout=num_classes, role="fc")))
    nodes.append(Node("output", "output", ["logits"], []))
    return Graph(nodes)


def resnet8_graph() -> Graph:
    return build_resnet_graph(1)


def resnet20_graph() -> Graph:
    return build_resnet_graph(3)


# ---------------------------------------------------------------------------
# LM graph builders (decoder-only transformer / Mamba) + the generic add-fold
# ---------------------------------------------------------------------------


def _matmul(name, tin, tout, din, dout, role, layer):
    """``role``/``layer`` bind a matmul node to its parameter slot, the same
    handle convention the conv builder uses (role | block)."""
    return Node(name, "matmul", [tin], [tout],
                dict(din=din, dout=dout, role=role, layer=layer))


def build_transformer_graph(cfg, seq_len: int) -> Graph:
    """Decoder-only transformer block stack as the IR the generic compiler
    lowers: per layer q/k/v projections -> causal attention -> output
    projection + residual add -> ReLU MLP (up, relu, down) + residual add.
    Matches the int8 arithmetic of ``compile.lm_params`` (pre-norm dropped:
    the int8 stack keeps the residual stream on one pow2 grid; see
    docs/compiler.md)."""
    d, L = cfg.d_model, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads or cfg.num_heads, cfg.head_dim
    nodes = [Node("input", "input", ["%in"], ["tok"]),
             Node("embed", "embed", ["tok"], ["h0"],
                  dict(vocab=cfg.vocab_size, dout=d, seq_len=seq_len))]
    h = "h0"
    for i in range(L):
        p = f"l{i}"
        nodes.append(_matmul(f"{p}.wq", h, f"{p}.q", d, H * hd, "wq", i))
        nodes.append(_matmul(f"{p}.wk", h, f"{p}.k", d, KV * hd, "wk", i))
        nodes.append(_matmul(f"{p}.wv", h, f"{p}.v", d, KV * hd, "wv", i))
        nodes.append(Node(f"{p}.attn", "attention",
                          [f"{p}.q", f"{p}.k", f"{p}.v"], [f"{p}.a"],
                          dict(heads=H, kv_heads=KV, head_dim=hd,
                               causal=True, layer=i, role="attn",
                               seq_len=seq_len)))
        nodes.append(_matmul(f"{p}.wo", f"{p}.a", f"{p}.o", H * hd, d,
                             "wo", i))
        nodes.append(Node(f"{p}.add0", "add", [f"{p}.o", h], [f"{p}.r"]))
        nodes.append(_matmul(f"{p}.up", f"{p}.r", f"{p}.u", d, cfg.d_ff,
                             "up", i))
        nodes.append(Node(f"{p}.relu", "relu", [f"{p}.u"], [f"{p}.ur"]))
        nodes.append(_matmul(f"{p}.down", f"{p}.ur", f"{p}.d", cfg.d_ff, d,
                             "down", i))
        nodes.append(Node(f"{p}.add1", "add", [f"{p}.d", f"{p}.r"],
                          [f"h{i + 1}"]))
        h = f"h{i + 1}"
    nodes.append(Node("unembed", "unembed", [h], ["logits"],
                      dict(din=d, dout=cfg.vocab_size)))
    nodes.append(Node("output", "output", ["logits"], []))
    return Graph(nodes)


def build_ssm_graph(cfg, seq_len: int) -> Graph:
    """Mamba1 block stack: per layer the five input projections (u/z/dt/B/C),
    the selective scan (SiLU-gated by z inside the scan task), and the
    output projection + residual add."""
    d, L = cfg.d_model, cfg.num_layers
    di, N = cfg.d_inner, cfg.ssm_state
    nodes = [Node("input", "input", ["%in"], ["tok"]),
             Node("embed", "embed", ["tok"], ["h0"],
                  dict(vocab=cfg.vocab_size, dout=d, seq_len=seq_len))]
    h = "h0"
    for i in range(L):
        p = f"l{i}"
        nodes.append(_matmul(f"{p}.wu", h, f"{p}.u", d, di, "wu", i))
        nodes.append(_matmul(f"{p}.wz", h, f"{p}.z", d, di, "wz", i))
        nodes.append(_matmul(f"{p}.wdt", h, f"{p}.dt", d, di, "wdt", i))
        nodes.append(_matmul(f"{p}.wb", h, f"{p}.b", d, N, "wb", i))
        nodes.append(_matmul(f"{p}.wc", h, f"{p}.c", d, N, "wc", i))
        nodes.append(Node(f"{p}.scan", "scan",
                          [f"{p}.u", f"{p}.dt", f"{p}.b", f"{p}.c",
                           f"{p}.z"], [f"{p}.y"],
                          dict(d_inner=di, ssm_state=N, gated=True, layer=i,
                               role="scan", seq_len=seq_len)))
        nodes.append(_matmul(f"{p}.wo", f"{p}.y", f"{p}.o", di, d, "wo", i))
        nodes.append(Node(f"{p}.add", "add", [f"{p}.o", h], [f"h{i + 1}"]))
        h = f"h{i + 1}"
    nodes.append(Node("unembed", "unembed", [h], ["logits"],
                      dict(din=d, dout=cfg.vocab_size)))
    nodes.append(Node("output", "output", ["logits"], []))
    return Graph(nodes)


def build_mamba1_graph(cfg, seq_len: int) -> Graph:
    """The published Mamba1 block stack (Falcon-Mamba's): per layer the
    RMSNorm, the input projection to ``[u | z]``, the causal depthwise conv
    of u with SiLU, ``x_proj`` to ``[dt | B | C]``, the weightless rms of
    each part (``rms_split``: dt to ``dt_proj``, B and C to the scan),
    ``dt_proj`` with its bias, the selective scan with the D skip and the
    SiLU(z) gate, and the output projection + residual add; a final norm
    before the unembed.  The embed node names the family, which selects
    the walk's handlers for these node kinds."""
    d, L = cfg.d_model, cfg.num_layers
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    nodes = [Node("input", "input", ["%in"], ["tok"]),
             Node("embed", "embed", ["tok"], ["h0"],
                  dict(vocab=cfg.vocab_size, dout=d, seq_len=seq_len,
                       family="mamba1"))]
    h = "h0"
    for i in range(L):
        p = f"l{i}"
        nodes.append(Node(f"{p}.norm", "norm", [h], [f"{p}.x"],
                          dict(layer=i, role="norm", eps=cfg.norm_eps)))
        nodes.append(_matmul(f"{p}.win", f"{p}.x", f"{p}.xz", d, 2 * di,
                             "win", i))
        nodes.append(Node(f"{p}.conv", "conv1d", [f"{p}.xz"], [f"{p}.u"],
                          dict(layer=i, role="conv", channels=di,
                               kernel=cfg.conv_kernel)))
        nodes.append(_matmul(f"{p}.wx", f"{p}.u", f"{p}.dbc", di,
                             R + 2 * N, "wx", i))
        nodes.append(Node(f"{p}.rms", "rms_split", [f"{p}.dbc"],
                          [f"{p}.dn", f"{p}.b", f"{p}.c"],
                          dict(layer=i, role="rms", splits=(R, N, N),
                               eps=cfg.mixer_rms_eps)))
        nodes.append(_matmul(f"{p}.wdt", f"{p}.dn", f"{p}.dt", R, di,
                             "wdt", i))
        nodes.append(Node(f"{p}.scan", "mamba1_scan",
                          [f"{p}.u", f"{p}.dt", f"{p}.b", f"{p}.c",
                           f"{p}.xz"], [f"{p}.y"],
                          dict(layer=i, role="scan", d_inner=di,
                               ssm_state=N, seq_len=seq_len)))
        nodes.append(_matmul(f"{p}.wo", f"{p}.y", f"{p}.o", di, d, "wo", i))
        nodes.append(Node(f"{p}.add", "add", [f"{p}.o", h], [f"h{i + 1}"]))
        h = f"h{i + 1}"
    nodes.append(Node("final_norm", "norm", [h], ["hn"],
                      dict(head=True, eps=cfg.norm_eps)))
    nodes.append(Node("unembed", "unembed", ["hn"], ["logits"],
                      dict(din=d, dout=cfg.vocab_size)))
    nodes.append(Node("output", "output", ["logits"], []))
    return Graph(nodes)


def add_fold_matmul(g: Graph) -> Graph:
    """The paper's add-fold (Fig. 13) generalized off the conv pipeline: an
    Add whose one input is produced by a matmul is deleted — the OTHER input
    (the skip stream) initializes that matmul's accumulator instead
    (``skip_in``): the ``acc_init`` operand of ``matmul_int8``."""
    prod = g.producers()
    for n in list(g.nodes):
        if n.op != "add":
            continue
        a, b = n.inputs[:2]
        pa, pb = prod.get(a), prod.get(b)
        for mm, skip in ((pa, b), (pb, a)):
            if mm is not None and mm.op == "matmul" and mm.skip_in is None:
                mm.skip_in = skip
                mm.fused.append("add_fold")
                mm.fused.extend(n.fused)
                mm.outputs = list(n.outputs)
                g.remove([n.name])
                break
    return g


def optimize_lm(g: Graph) -> Graph:
    """The LM counterpart of :func:`optimize`: ReLU merged into its
    producing matmul, every residual Add folded into a matmul accumulator.
    No bn/loop_merge/temporal_reuse — LM graphs have no convs or window
    buffers."""
    g = merge_relu(g)
    g = add_fold_matmul(g)
    g.validate()
    return g
