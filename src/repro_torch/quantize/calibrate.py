"""PTQ calibration: observed float ranges -> per-tensor pow2 grids.

The paper's accuracy numbers come from a calibrated power-of-two quantization
(§III-A): int8 weights/activations, int16 biases at ``s_b = s_x + s_w``,
int32 accumulators, every rescale a bit shift.  This module produces exactly
those grids from data:

  1. (optionally) write BN running stats from the calibration set
     (``models.resnet.calibrate_bn`` — the paper folds BN *then* calibrates);
  2. fold BN into the convs (``fold_params``);
  3. run the folded float reference forward
     (``models.resnet.folded_float_forward``) over the calibration batches
     with one :mod:`~repro.quantize.observers` observer attached per
     activation site;
  4. derive per-tensor pow2 exponents: activations unsigned-8 from the
     observers, weights signed-8 min/max on the folded weights (weights are
     fully known — no estimator needed), biases at ``s_x + s_w`` by
     construction when :mod:`~repro.quantize.export` builds the params.

The result is a JSON-serializable :class:`CalibrationResult` (the JAX
package's JSON, so either package reads the other's); feeding it to
``export.export_qparams`` yields ``compile.params.QResNetParams`` whose
requantization shifts (``QBlockParams.shifts_for``) follow
``core.quant.requantize_shift``'s rounding semantics on every backend.

The forwards run on the device of ``params``; the observers' statistics
are host float64 arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QSpec
from repro_torch.models import resnet as R
from repro_torch.quantize.observers import (
    Observer, make_observer, pow2_exponent)

# activation exponents are clamped to this window: below -12 the shift
# arithmetic is still exact but the grid is absurdly fine for u8 (range
# < 0.063), above 2 an activation amax > 1020 means the float model diverged
# — both indicate a calibration-set problem, not a real dynamic range.
EXP_CLAMP = (-12, 2)


def _spec_to_dict(s: QSpec) -> dict:
    return dict(bits=s.bits, signed=s.signed, exp=s.exp)


def _spec_from_dict(d: dict) -> QSpec:
    return QSpec(bits=int(d["bits"]), signed=bool(d["signed"]),
                 exp=int(d["exp"]))


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Per-tensor grids for one model, keyed by graph site.

    ``acts`` maps the activation sites of
    ``models.resnet.folded_float_forward`` (``stem.out`` / ``block{i}.mid`` /
    ``block{i}.out``) to unsigned-8 :class:`QSpec`; ``w_exps`` maps conv names
    (``stem``, ``block{i}.conv0|conv1|ds``, ``fc``) to signed-8 exponents;
    ``x_spec`` is the input-image grid."""

    model: str
    observer: str
    batches: int
    x_spec: QSpec
    acts: Dict[str, QSpec]
    w_exps: Dict[str, int]

    # -- site accessors (the export wiring in one place) --------------------

    def block_in(self, i: int) -> QSpec:
        """The input grid of block ``i`` (= stem.out for block 0, else the
        previous block's output grid) — conv0's and ds's ``x_spec``."""
        return self.acts["stem.out" if i == 0 else f"block{i-1}.out"]

    def block_mid(self, i: int) -> QSpec:
        """conv0's output grid == conv1's input grid."""
        return self.acts[f"block{i}.mid"]

    def block_out(self, i: int) -> QSpec:
        return self.acts[f"block{i}.out"]

    def head_in(self, n_blocks: int) -> QSpec:
        """The classifier's input grid (the last block's output)."""
        return self.acts[f"block{n_blocks-1}.out"]

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> dict:
        return dict(model=self.model, observer=self.observer,
                    batches=self.batches,
                    x_spec=_spec_to_dict(self.x_spec),
                    acts={k: _spec_to_dict(v)
                          for k, v in sorted(self.acts.items())},
                    w_exps=dict(sorted(self.w_exps.items())))

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationResult":
        return cls(model=d["model"], observer=d["observer"],
                   batches=int(d["batches"]),
                   x_spec=_spec_from_dict(d["x_spec"]),
                   acts={k: _spec_from_dict(v) for k, v in d["acts"].items()},
                   w_exps={k: int(v) for k, v in d["w_exps"].items()})

    def summary(self) -> str:
        lines = [f"calibration[{self.model}] observer={self.observer} "
                 f"batches={self.batches} input_exp={self.x_spec.exp}"]
        for site, s in sorted(self.acts.items()):
            lines.append(f"  act  {site:<14} exp={s.exp}")
        for name, e in sorted(self.w_exps.items()):
            lines.append(f"  wgt  {name:<14} exp={e}")
        return "\n".join(lines)


def _amax(w: torch.Tensor) -> float:
    return float(torch.max(torch.abs(w)))


def _weight_exps(folded, cfg) -> Dict[str, int]:
    """Signed-8 min/max exponents on the *folded* weights — BN folding
    rescales by gamma/sqrt(var), so these must be computed after the fold
    (same rule as ``core.quant.calibrate_exp``, one name per conv)."""
    out = {"stem": pow2_exponent(_amax(folded["stem"]["w"]), cfg.bw_w, True)}
    for i, blk in enumerate(folded["blocks"]):
        for conv in ("conv0", "conv1", "ds"):
            if conv in blk:
                out[f"block{i}.{conv}"] = pow2_exponent(
                    _amax(blk[conv]["w"]), cfg.bw_w, True)
    out["fc"] = pow2_exponent(_amax(folded["fc"]["w"]), cfg.bw_w, True)
    return out


def _images(batches, device) -> list:
    """The calibration batches (image arrays or tensors, or ``{"images":
    ...}`` dicts) as float32 tensors on ``device``."""
    out = []
    for b in batches:
        x = b["images"] if isinstance(b, dict) else b
        out.append(torch.as_tensor(x, dtype=torch.float32, device=device))
    return out


def _device(params) -> torch.device:
    return params["stem"]["w"].device


def calibrate(cfg, params, batches: Iterable, observer: str = "minmax",
              calibrate_bn: bool = True, clamp: Tuple[int, int] = EXP_CLAMP,
              **observer_kw) -> CalibrationResult:
    """Run the calibration flow over ``batches`` (an iterable of image
    arrays or tensors, or of ``{"images": ...}`` dicts) on the device of
    ``params`` and return the derived grids.

    ``observer`` picks the activation-range estimator (``minmax`` / ``ema`` /
    ``percentile``; ``observer_kw`` forwards e.g. ``percentile=99.9``).
    ``calibrate_bn=True`` first writes BN running stats from the calibration
    set so the folded graph matches what training saw (paper §III-A order:
    fold, then calibrate).
    """
    imgs = _images(batches, _device(params))
    if not imgs:
        raise ValueError("calibration needs at least one batch")

    if calibrate_bn:
        params = R.calibrate_bn(params, cfg, torch.cat(imgs, dim=0))
    folded = R.fold_params(params)

    taps: Dict[str, Observer] = {}

    def tap(site, h):
        if site not in taps:
            taps[site] = make_observer(observer, **observer_kw)
        taps[site].observe(h)

    for x in imgs:
        R.folded_float_forward(folded, cfg, x, tap=tap)

    lo, hi = clamp

    def act_spec(site) -> QSpec:
        e = int(np.clip(taps[site].exponent(cfg.bw_x, signed=False), lo, hi))
        return QSpec(bits=cfg.bw_x, signed=False, exp=e)

    acts = {site: act_spec(site) for site in taps if site != "input"}
    x_spec = QSpec(bits=cfg.bw_x, signed=False,
                   exp=int(np.clip(
                       taps["input"].exponent(cfg.bw_x, signed=False),
                       lo, hi)))
    return CalibrationResult(
        model=cfg.name, observer=observer, batches=len(imgs),
        x_spec=x_spec, acts=acts, w_exps=_weight_exps(folded, cfg))
