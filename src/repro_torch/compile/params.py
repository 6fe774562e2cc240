"""Typed quantized-parameter containers (frozen dataclasses of tensors).

  * ``QConvParams``   — one folded+quantized conv: int8 HWIO weights, int16
                        bias and the three :class:`QSpec` domains (weight,
                        input activation, bias).
  * ``QLinearParams`` — the classifier (int8 weights, float32 bias).
  * ``QBlockParams``  — one residual block: conv0, conv1, optional ds.
  * ``QResNetParams`` — the whole network; ``from_dict``/``to_dict`` adapt
                        the ``quantize_params`` dict layout both ways and
                        ``to(device)`` places every tensor.

``params_from_numpy`` carries weights across from any array source in the
``to_dict`` layout (numpy arrays, or anything ``np.asarray`` accepts) with
spec objects that have ``bits``/``signed``/``exp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QSpec


@dataclasses.dataclass(frozen=True)
class QConvParams:
    """One quantized conv task: ``acc = conv(x, wq) + bq`` in int32, with the
    product domain at exponent ``x_spec.exp + w_spec.exp`` (= ``b_spec.exp``)."""

    wq: torch.Tensor            # (fh, fw, ich, och) int8
    bq: torch.Tensor            # (och,) int16 at s_b = s_x + s_w
    w_spec: QSpec
    x_spec: QSpec
    b_spec: QSpec

    @property
    def product_exp(self) -> int:
        """Exponent of the int32 accumulator domain (s_x + s_w)."""
        return self.x_spec.exp + self.w_spec.exp

    @classmethod
    def from_dict(cls, d: dict) -> "QConvParams":
        return cls(wq=d["wq"], bq=d["bq"], w_spec=d["w_spec"],
                   x_spec=d["x_spec"], b_spec=d["b_spec"])

    def to_dict(self) -> dict:
        return dict(wq=self.wq, bq=self.bq, w_spec=self.w_spec,
                    x_spec=self.x_spec, b_spec=self.b_spec)

    def to(self, device) -> "QConvParams":
        return dataclasses.replace(self, wq=self.wq.to(device),
                                   bq=self.bq.to(device))


@dataclasses.dataclass(frozen=True)
class QLinearParams:
    """The classifier head: int8 weights, float bias.  ``x_spec`` is the grid
    of the head's input feature map; ``None`` means the model-level default
    (``models.resnet.A_SPEC``)."""

    wq: torch.Tensor            # (din, dout) int8
    b: torch.Tensor             # (dout,) float32
    w_spec: QSpec
    x_spec: Optional[QSpec] = None

    @classmethod
    def from_dict(cls, d: dict) -> "QLinearParams":
        return cls(wq=d["wq"], b=d["b"], w_spec=d["w_spec"],
                   x_spec=d.get("x_spec"))

    def to_dict(self) -> dict:
        out = dict(wq=self.wq, b=self.b, w_spec=self.w_spec)
        if self.x_spec is not None:
            out["x_spec"] = self.x_spec
        return out

    def to(self, device) -> "QLinearParams":
        return dataclasses.replace(self, wq=self.wq.to(device),
                                   b=self.b.to(device))


@dataclasses.dataclass(frozen=True)
class QBlockParams:
    """One residual block after graph optimization: two fused conv tasks and,
    for stage-entry blocks, the 1x1 downsample merged into conv0's task."""

    conv0: QConvParams
    conv1: QConvParams
    ds: Optional[QConvParams] = None

    @property
    def has_ds(self) -> bool:
        return self.ds is not None

    def shifts(self, a_exp: int) -> dict:
        """Fixed-grid variant of :meth:`shifts_for`: every activation on one
        global grid at exponent ``a_exp`` (``models.resnet.A_SPEC``'s
        layout).  Refuses calibrated per-tensor params, whose conv input
        grids differ from ``a_exp``: the fixed formula would requantize
        them wrongly without a word."""
        for c in (self.conv0, self.conv1):
            if c.x_spec.exp != a_exp:
                raise ValueError(
                    f"shifts({a_exp}) on per-tensor params (conv input grid "
                    f"exp {c.x_spec.exp}); use shifts_for()")
        return self.shifts_for(a_exp)

    def shifts_for(self, out_exp: int) -> dict:
        """The block's shifts, derived from the specs the params carry.
        ``out_exp`` is the exponent of the block output grid:

          * shift0      — conv0's product domain -> conv1's input grid;
          * shift1      — conv1's product domain -> the block output grid;
          * skip_shift  — the skip stream's domain (ds product domain, or the
            block input grid without a downsample) -> conv1's product domain
            (the add-fold accumulator init)."""
        out = dict(shift0=self.conv1.x_spec.exp - self.conv0.product_exp,
                   shift1=out_exp - self.conv1.product_exp)
        if self.ds is not None:
            out["skip_shift"] = self.ds.product_exp - self.conv1.product_exp
        else:
            out["skip_shift"] = self.conv0.x_spec.exp - \
                self.conv1.product_exp
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "QBlockParams":
        return cls(conv0=QConvParams.from_dict(d["conv0"]),
                   conv1=QConvParams.from_dict(d["conv1"]),
                   ds=QConvParams.from_dict(d["ds"]) if "ds" in d else None)

    def to_dict(self) -> dict:
        out = dict(conv0=self.conv0.to_dict(), conv1=self.conv1.to_dict())
        if self.ds is not None:
            out["ds"] = self.ds.to_dict()
        return out

    def to(self, device) -> "QBlockParams":
        return QBlockParams(self.conv0.to(device), self.conv1.to(device),
                            self.ds.to(device) if self.ds is not None
                            else None)


@dataclasses.dataclass(frozen=True)
class QResNetParams:
    """The full quantized network, in graph order: stem, residual blocks,
    classifier."""

    stem: QConvParams
    blocks: Tuple[QBlockParams, ...]
    fc: QLinearParams

    @classmethod
    def from_dict(cls, qp: dict) -> "QResNetParams":
        """Adapter from the ``quantize_params`` nested-dict layout."""
        return cls(stem=QConvParams.from_dict(qp["stem"]),
                   blocks=tuple(QBlockParams.from_dict(b)
                                for b in qp["blocks"]),
                   fc=QLinearParams.from_dict(qp["fc"]))

    def to_dict(self) -> dict:
        return dict(stem=self.stem.to_dict(),
                    blocks=[b.to_dict() for b in self.blocks],
                    fc=self.fc.to_dict())

    def to(self, device) -> "QResNetParams":
        return QResNetParams(self.stem.to(device),
                             tuple(b.to(device) for b in self.blocks),
                             self.fc.to(device))


def activation_out_specs(params: QResNetParams, default: QSpec):
    """The *output* activation grid of each task in graph order, read off the
    consumers' specs: the stem's output grid is block 0's input grid, block
    ``i``'s is block ``i+1``'s, and the last block's is the head's input spec
    (``default`` when the head carries none).  Returns ``(stem_out,
    block_outs)``."""
    head = params.fc.x_spec if params.fc.x_spec is not None else default
    if not params.blocks:
        return head, ()
    block_outs = tuple(b.conv0.x_spec for b in params.blocks[1:]) + (head,)
    return params.blocks[0].conv0.x_spec, block_outs


def ensure_typed(qparams):
    """Accept the ``quantize_params`` dict layout or a typed container
    (conv or LM)."""
    from repro_torch.compile.lm_params import QLMParams
    if isinstance(qparams, (QResNetParams, QLMParams)):
        return qparams
    if isinstance(qparams, dict):
        return QResNetParams.from_dict(qparams)
    raise TypeError(
        f"expected QResNetParams, QLMParams or a quantize_params() dict, "
        f"got {type(qparams).__name__}")


def _spec(s) -> QSpec:
    return QSpec(bits=int(s.bits), signed=bool(s.signed), exp=int(s.exp))


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(d: dict, device="cpu") -> QResNetParams:
    """Build the port's params on ``device`` from the ``to_dict`` layout of a
    quantized ResNet whose arrays ``np.asarray`` accepts and whose specs have
    ``bits``/``signed``/``exp``.  Array dtypes are kept as they come."""
    def conv(c):
        return QConvParams(wq=_tensor(c["wq"], device),
                           bq=_tensor(c["bq"], device),
                           w_spec=_spec(c["w_spec"]),
                           x_spec=_spec(c["x_spec"]),
                           b_spec=_spec(c["b_spec"]))

    fc = d["fc"]
    return QResNetParams(
        stem=conv(d["stem"]),
        blocks=tuple(QBlockParams(conv(b["conv0"]), conv(b["conv1"]),
                                  conv(b["ds"]) if "ds" in b else None)
                     for b in d["blocks"]),
        fc=QLinearParams(wq=_tensor(fc["wq"], device),
                         b=_tensor(fc["b"], device),
                         w_spec=_spec(fc["w_spec"]),
                         x_spec=_spec(fc["x_spec"])
                         if fc.get("x_spec") is not None else None))
