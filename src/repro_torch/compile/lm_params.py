"""Typed int8 parameter containers + serving config for LM graphs.

The port's copy of ``repro.compile.lm_params``.  The generic graph->task
compiler (``compile.lowering.plan_lm``) binds each matmul/attention/scan
node to a slot in these containers via the node's ``(layer, role)`` attrs,
as the conv pipeline binds ``(role, block)`` to ``QResNetParams``.

Arithmetic contract (the paper's pow2-int8 scheme on a residual LM stream):

  * every activation lives on a signed-int8 pow2 grid (``QSpec``); the
    residual stream keeps ONE grid per layer boundary so the add-fold is a
    pure shift;
  * a matmul task is ``acc = x_q @ w_q + b_q (+ shift_align(skip))`` in
    int32 at the product domain ``x_exp + w_exp``, then (optional fused
    ReLU and) ``requantize_shift`` onto the output grid;
  * attention and scan are float interludes: dequantize the int8 operands,
    run the kernel (or its plain version), quantize the result onto the
    consuming matmul's input grid;
  * embed / unembed run in float (the paper's host-side head).

``init_lm_params`` draws seeded synthetic weights from a
``torch.Generator`` on the target device (full width on the card takes
seconds); ``lm_params_from_numpy`` carries any other parameters across
(numpy arrays in the ``to_dict`` layout).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core.quant import QSpec

# default signed-int8 activation grid for LM streams (range ~±4 at exp -5);
# the per-matrix weight grids are calibrated at init time
LM_A_SPEC = QSpec(bits=8, signed=True, exp=-5)


@dataclasses.dataclass(frozen=True)
class QLMConfig:
    """What ``compile_model``/the engine need to serve one LM: identity,
    family (selects the graph builder), the shape, and the fixed sequence
    length every bucket runs at.  Built from a ``ModelConfig`` via
    :func:`lm_config`."""

    name: str
    family: str                  # "dense" (transformer) | "ssm" (mamba1)
    seq_len: int
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    d_inner: int = 0
    ssm_state: int = 0


def lm_config(model_cfg, seq_len: int) -> QLMConfig:
    """Project a ``repro_torch.configs.ModelConfig`` onto the serving config
    the generic compiler consumes."""
    if model_cfg.family not in ("dense", "ssm"):
        raise ValueError(
            f"{model_cfg.name}: family {model_cfg.family!r} has no LM "
            f"lowering (supported: dense, ssm)")
    return QLMConfig(
        name=model_cfg.name, family=model_cfg.family, seq_len=int(seq_len),
        num_layers=model_cfg.num_layers, d_model=model_cfg.d_model,
        vocab_size=model_cfg.vocab_size, num_heads=model_cfg.num_heads,
        num_kv_heads=model_cfg.num_kv_heads or model_cfg.num_heads,
        head_dim=model_cfg.head_dim, d_ff=model_cfg.d_ff,
        d_inner=model_cfg.d_inner, ssm_state=model_cfg.ssm_state)


@dataclasses.dataclass(frozen=True)
class QMatmulParams:
    """One quantized matmul task: ``acc = x_q @ wq + bq`` in int32 at the
    product domain (``x_spec.exp + w_spec.exp``), requantized onto
    ``y_spec``.  ``bq`` is int32 at the product domain."""

    wq: torch.Tensor             # (din, dout) int8
    bq: torch.Tensor             # (dout,) int32 at s_b = s_x + s_w
    w_spec: QSpec
    x_spec: QSpec
    y_spec: QSpec

    @property
    def product_exp(self) -> int:
        return self.x_spec.exp + self.w_spec.exp

    def to(self, device) -> "QMatmulParams":
        return dataclasses.replace(self, wq=self.wq.to(device),
                                   bq=self.bq.to(device))

    def to_dict(self) -> dict:
        return dict(wq=self.wq, bq=self.bq, w_spec=self.w_spec,
                    x_spec=self.x_spec, y_spec=self.y_spec)


@dataclasses.dataclass(frozen=True)
class QTransformerLayerParams:
    """One decoder block; field names ARE the graph node roles."""

    wq: QMatmulParams
    wk: QMatmulParams
    wv: QMatmulParams
    wo: QMatmulParams            # add-fold target: skip = block input
    up: QMatmulParams            # fused ReLU
    down: QMatmulParams          # add-fold target: skip = post-attn stream

    ROLES = ("wq", "wk", "wv", "wo", "up", "down")

    def to(self, device) -> "QTransformerLayerParams":
        return QTransformerLayerParams(
            *(getattr(self, r).to(device) for r in self.ROLES))

    def to_dict(self) -> dict:
        return {r: getattr(self, r).to_dict() for r in self.ROLES}


@dataclasses.dataclass(frozen=True)
class QSSMLayerParams:
    """One Mamba1 block; field names ARE the graph node roles (``A`` binds
    to the ``scan`` node)."""

    wu: QMatmulParams
    wz: QMatmulParams
    wdt: QMatmulParams
    wb: QMatmulParams
    wc: QMatmulParams
    wo: QMatmulParams            # add-fold target: skip = block input
    A: torch.Tensor              # (d_inner, ssm_state) float32, negative

    ROLES = ("wu", "wz", "wdt", "wb", "wc", "wo")

    def to(self, device) -> "QSSMLayerParams":
        return QSSMLayerParams(
            *(getattr(self, r).to(device) for r in self.ROLES),
            A=self.A.to(device))

    def to_dict(self) -> dict:
        out = {r: getattr(self, r).to_dict() for r in self.ROLES}
        out["A"] = self.A
        return out


LayerParams = Union[QTransformerLayerParams, QSSMLayerParams]


@dataclasses.dataclass(frozen=True)
class QLMParams:
    """The full LM: float embedding table, quantized layer stack, float
    unembedding.  One container for both families — the layer type carries
    the distinction."""

    embed: torch.Tensor          # (vocab, d) float32
    layers: Tuple[LayerParams, ...]
    unembed: torch.Tensor        # (d, vocab) float32
    emb_spec: QSpec = LM_A_SPEC  # grid the embedded tokens quantize onto

    def matmul(self, layer: int, role: str) -> QMatmulParams:
        """The parameter slot of one matmul node — the (layer, role) binding
        the lowering registry uses."""
        p = getattr(self.layers[layer], role, None)
        if not isinstance(p, QMatmulParams):
            raise KeyError(
                f"layer {layer} has no matmul role {role!r} "
                f"(layer type {type(self.layers[layer]).__name__})")
        return p

    def skip_exp(self, layer: int, role: str) -> int:
        """Exponent of the skip stream entering the (layer, role) matmul's
        accumulator — the residual-fold alignment.  ``wo``'s skip is the
        block input (the qkv/in-proj input grid); ``down``'s skip is the
        post-attention stream (``wo``'s output grid)."""
        lp = self.layers[layer]
        if role == "wo":
            first = lp.wq if isinstance(lp, QTransformerLayerParams) else lp.wu
            return first.x_spec.exp
        if role == "down":
            return lp.wo.y_spec.exp
        raise KeyError(f"role {role!r} is not an add-fold target")

    def to(self, device) -> "QLMParams":
        return QLMParams(self.embed.to(device),
                         tuple(lp.to(device) for lp in self.layers),
                         self.unembed.to(device), self.emb_spec)

    def to_dict(self) -> dict:
        return dict(embed=self.embed, unembed=self.unembed,
                    emb_spec=self.emb_spec,
                    layers=[lp.to_dict() for lp in self.layers])


def hidden_out_spec(params: QLMParams) -> QSpec:
    """Grid of the final hidden state entering the unembed head."""
    last = params.layers[-1]
    if isinstance(last, QTransformerLayerParams):
        return last.down.y_spec
    return last.wo.y_spec


def logit_tolerance(qa: torch.Tensor, qb: torch.Tensor, spec: QSpec,
                    unembed: torch.Tensor) -> torch.Tensor:
    """Per-logit bound on ``|logits_a - logits_b|`` for two forwards whose
    int8 final hidden states (``(B, S, d)`` on grid ``spec``) are ``qa`` and
    ``qb``; the logits are ``h[:, -1] @ unembed`` in float32.

    The bound is the hidden-state difference carried through the unembed
    exactly, ``2^exp * sum_i |qa_i - qb_i| * |U_iv|``, plus the worst-case
    float32 rounding of each side's d-term product, ``gamma_{d+1} * sum_i
    |h_i| * |U_iv|`` with ``gamma_n = n u / (1 - n u)``, ``u = 2^-24``.
    The float interludes (attention, scan) may move an int8 value by one
    grid step, and such steps propagate through the residual stream, so
    the final hidden states themselves are not bounded by the per-task
    limits: the caller reports their difference and this bound holds the
    unembed to it.  Returns ``(B, vocab)`` float64."""
    U = unembed.to(torch.float64).abs()
    n = U.shape[0] + 1
    u = 2.0 ** -24
    gamma = n * u / (1 - n * u)
    a = qa[:, -1].to(torch.float64)
    b = qb[:, -1].to(torch.float64)
    return ((a - b).abs() * spec.scale) @ U + \
        gamma * ((a.abs() + b.abs()) * spec.scale) @ U


# ---------------------------------------------------------------------------
# Synthetic seeded init (serving fixture)
# ---------------------------------------------------------------------------


def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, device=device) * std


def _q_matmul(gen, din: int, dout: int, a_spec: QSpec,
              device) -> QMatmulParams:
    """The JAX recipe: N(0, 1/din) weights on a per-matrix pow2 grid
    ``ceil(log2(amax / 127))`` covering the sampled range, N(0, 0.05)
    biases rounded onto the product domain."""
    w = _normal(gen, (din, dout), 1.0 / math.sqrt(din), device)
    amax = max(float(w.abs().max()), 1e-12)
    w_exp = int(math.ceil(math.log2(amax / 127.0)))
    wq = torch.clamp(torch.round(w * 2.0 ** -w_exp), -128, 127).to(
        torch.int8)
    del w
    b = _normal(gen, (dout,), 0.05, device)
    bq = torch.round(b * 2.0 ** -(a_spec.exp + w_exp)).to(torch.int32)
    return QMatmulParams(wq=wq, bq=bq,
                         w_spec=QSpec(bits=8, signed=True, exp=w_exp),
                         x_spec=a_spec, y_spec=a_spec)


def init_lm_params(cfg: QLMConfig, seed: int = 0,
                   a_spec: QSpec = LM_A_SPEC, device="cpu") -> QLMParams:
    """Seeded synthetic parameters for ``cfg``, drawn on ``device`` from a
    ``torch.Generator`` there (one float matrix at a time, so the peak is
    one layer's largest float32 weight beside the int8 stack): every
    activation grid is ``a_spec``, weight grids calibrated per matrix.
    The draws differ from the JAX package's numpy ones; the recipe is the
    same."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def mm(din, dout):
        return _q_matmul(gen, din, dout, a_spec, device)

    layers = []
    for _ in range(cfg.num_layers):
        if cfg.family == "dense":
            qkv = cfg.num_heads * cfg.head_dim
            kv = cfg.num_kv_heads * cfg.head_dim
            layers.append(QTransformerLayerParams(
                wq=mm(cfg.d_model, qkv), wk=mm(cfg.d_model, kv),
                wv=mm(cfg.d_model, kv), wo=mm(qkv, cfg.d_model),
                up=mm(cfg.d_model, cfg.d_ff), down=mm(cfg.d_ff, cfg.d_model)))
        else:
            A = -(0.5 + torch.rand((cfg.d_inner, cfg.ssm_state),
                                   generator=gen, device=device))
            layers.append(QSSMLayerParams(
                wu=mm(cfg.d_model, cfg.d_inner),
                wz=mm(cfg.d_model, cfg.d_inner),
                wdt=mm(cfg.d_model, cfg.d_inner),
                wb=mm(cfg.d_model, cfg.ssm_state),
                wc=mm(cfg.d_model, cfg.ssm_state),
                wo=mm(cfg.d_inner, cfg.d_model), A=A))
    embed = _normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, device)
    unembed = _normal(gen, (cfg.d_model, cfg.vocab_size),
                      1.0 / math.sqrt(cfg.d_model), device)
    return QLMParams(embed=embed, layers=tuple(layers), unembed=unembed,
                     emb_spec=a_spec)


# ---------------------------------------------------------------------------
# Bridge
# ---------------------------------------------------------------------------


def _spec(s) -> QSpec:
    return QSpec(bits=int(s.bits), signed=bool(s.signed), exp=int(s.exp))


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def lm_params_from_numpy(d: dict, device="cpu") -> QLMParams:
    """Build the port's LM params on ``device`` from the ``to_dict`` layout
    (``embed``, ``unembed``, ``emb_spec`` and ``layers``, a list of
    role -> ``{wq, bq, w_spec, x_spec, y_spec}`` dicts, plus ``A`` for an
    SSM layer) whose arrays ``np.asarray`` accepts and whose specs have
    ``bits``/``signed``/``exp``.  Array dtypes are kept as they come."""
    def mm(m):
        return QMatmulParams(wq=_tensor(m["wq"], device),
                             bq=_tensor(m["bq"], device),
                             w_spec=_spec(m["w_spec"]),
                             x_spec=_spec(m["x_spec"]),
                             y_spec=_spec(m["y_spec"]))

    layers = []
    for lp in d["layers"]:
        if "A" in lp:
            layers.append(QSSMLayerParams(
                *(mm(lp[r]) for r in QSSMLayerParams.ROLES),
                A=_tensor(lp["A"], device)))
        else:
            layers.append(QTransformerLayerParams(
                *(mm(lp[r]) for r in QTransformerLayerParams.ROLES)))
    return QLMParams(embed=_tensor(d["embed"], device), layers=tuple(layers),
                     unembed=_tensor(d["unembed"], device),
                     emb_spec=_spec(d["emb_spec"]))
