"""Power-of-two INT quantization (paper §III-A, eqs. 1-5) on torch tensors.

Weights and activations are 8-bit integers, biases 16-bit, accumulators
32-bit.  Every scale is a power of two, so a rescale between domains is a
bit shift:

    a = Q(b) = clip(round(b * 2^-s), a_min, a_max) * 2^s          (eq. 1)

The stored integer is ``clip(round(b * 2^-s), ...)``; the bias exponent is
``s_b = s_x + s_w`` so the bias adds straight onto the int32 accumulator.

Rounding is the integer pipeline's, not torch's:

  * ``quantize`` rounds half away from zero (``torch.round`` rounds half to
    even, so it is not used);
  * ``shift_align`` / ``requantize_shift`` compute ``(acc + half) >> s``,
    i.e. ``floor(x + 0.5)`` with ties toward +infinity and an arithmetic
    shift on negative values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QSpec:
    """Static description of one quantized tensor domain.

    ``bits``: total width (8 for weights/activations, 16 for biases);
    ``signed``: signed or unsigned (post-ReLU activations); ``exp``: the
    power-of-two exponent ``s`` of eq. (1) — the stored integer is
    ``round(x / 2**exp)`` and the real value ``int * 2**exp``."""

    bits: int = 8
    signed: bool = True
    exp: int = -7

    @property
    def scale(self) -> float:
        return float(2.0 ** self.exp)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0            # eq. 2

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1

    @property
    def int_dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.int8 if self.signed else torch.uint8
        if self.bits <= 16:
            return torch.int16 if self.signed else torch.uint16
        return torch.int32


def bias_spec(x_spec: QSpec, w_spec: QSpec, bits: int = 16) -> QSpec:
    """Paper: ``s_b = s_x + s_w`` so the int bias adds directly to the int32
    accumulator of the product domain."""
    return QSpec(bits=bits, signed=True, exp=x_spec.exp + w_spec.exp)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def quantize(x: torch.Tensor, spec: QSpec) -> torch.Tensor:
    """Real -> stored integer (eq. 1 without the final ``* 2**s``), computed
    in float32 as the JAX reference does."""
    q = _round_half_away(x.to(torch.float32) * (2.0 ** (-spec.exp)))
    q = torch.clamp(q, spec.qmin, spec.qmax)
    return q.to(spec.int_dtype)


def dequantize(q: torch.Tensor, spec: QSpec) -> torch.Tensor:
    return q.to(torch.float32) * spec.scale


def percentile_linear(a: torch.Tensor, percentile: float) -> float:
    """The ``percentile`` of the 1-D float32 tensor ``a`` with linear
    interpolation between the two nearest ranks, in the float32 arithmetic
    of ``jnp.percentile`` as XLA compiles it: the rank ``q / 100 * (n - 1)``
    becomes ``q * (float32(0.01) * float32(n - 1))`` (the division turned
    into a multiply by the reciprocal, folded with the constant ``n - 1``;
    past 2^24 elements this picks another rank than exact arithmetic
    would), and the weights and the blend round to float32.  Two
    ``kthvalue`` selections instead of ``torch.quantile``, which refuses
    inputs of more than 2^24 elements."""
    f32 = np.float32
    n = a.numel()
    pos = f32(f32(percentile) * f32(f32(0.01) * f32(f32(n) - f32(1))))
    lo, hi = (min(max(int(f(pos)), 0), n - 1) for f in (np.floor, np.ceil))
    w_hi = f32(pos - f32(lo))
    w_lo = f32(f32(1) - w_hi)
    v_lo = f32(float(torch.kthvalue(a, lo + 1).values))
    v_hi = f32(float(torch.kthvalue(a, hi + 1).values)) if hi != lo \
        else v_lo
    return float(f32(f32(v_lo * w_lo) + f32(v_hi * w_hi)))


def calibrate_exp(x: torch.Tensor, spec: QSpec,
                  percentile: float = 100.0) -> int:
    """Smallest power-of-two exponent that covers the (percentile-clipped)
    dynamic range of ``x``."""
    a = torch.abs(x.to(torch.float32)).flatten()
    amax = float(a.max()) if percentile >= 100.0 else \
        percentile_linear(a, percentile)
    amax = max(amax, 1e-12)
    # need amax <= qmax * 2**exp  =>  exp >= log2(amax / qmax)
    return int(np.ceil(np.log2(amax / spec.qmax)))


def shift_align(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """Rescale an int32 accumulator by ``2**shift``: left shift for
    ``shift >= 0``, rounding right shift ``(acc + half) >> -shift`` for
    ``shift < 0`` (ties toward +infinity: -0.5 -> 0).  The skip-stream
    alignment of the add-fold."""
    acc = acc.to(torch.int32)
    if shift >= 0:
        return acc << shift
    return (acc + (1 << (-shift - 1))) >> (-shift)


def requantize_shift(acc: torch.Tensor, from_exp: int,
                     to_spec: QSpec) -> torch.Tensor:
    """int32 accumulator at ``2**from_exp`` -> integer in ``to_spec`` by a
    rounding bit shift, then clip."""
    shift = to_spec.exp - from_exp
    acc = acc.to(torch.int32)
    if shift <= 0:
        q = acc << (-shift)
    else:
        q = (acc + (1 << (shift - 1))) >> shift
    q = torch.clamp(q, to_spec.qmin, to_spec.qmax)
    return q.to(to_spec.int_dtype)


def fold_batchnorm(w, b, gamma, beta, mean, var, eps=1e-5):
    """Return ``(w', b')`` with ``conv(x, w') + b' == BN(conv(x, w) + b)``.

    ``w``: ``(fh, fw, ich, och)`` HWIO conv weight; BN params are per-och."""
    inv = gamma / torch.sqrt(var + eps)
    return w * inv, (b - mean) * inv + beta
