"""Calibration observers — range statistics -> power-of-two exponents.

An observer watches one tensor site across calibration batches and, once
calibration ends, answers a single question: *what power-of-two exponent
covers this tensor's dynamic range for a given bit width?* (paper §III-A:
every scale factor is 2^s so requantization is a bit shift).

Three strategies, mirroring the common PTQ menu (Brevitas/FINN flows):

  * :class:`MinMaxObserver`        — running max of ``|x|``; exact coverage,
                                     sensitive to a single outlier.
  * :class:`MovingAverageObserver` — EMA of the per-batch ``max |x|``; damps
                                     one-off spikes, tracks the typical range.
  * :class:`PercentileObserver`    — running max of the per-batch percentile
                                     of ``|x|``; clips the tail outright
                                     (smaller exponent, finer grid, a little
                                     saturation).

All observers are deterministic: the same batches in the same order produce
the same exponent, which is what makes calibration reproducible across
machines.  The statistics are host float64 arithmetic (numpy), as in the
JAX package: ``observe`` takes a tensor on any device (it is detached and
copied to the host) or an array.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QSpec


def pow2_exponent(amax: float, bits: int, signed: bool) -> int:
    """Smallest integer ``s`` with ``amax <= qmax * 2**s`` — the same rule as
    ``core.quant.calibrate_exp``, on a plain float."""
    qmax = 2 ** (bits - 1) - 1 if signed else 2 ** bits - 1
    amax = max(float(amax), 1e-12)
    return int(np.ceil(np.log2(amax / qmax)))


class Observer:
    """Base: feed tensors with :meth:`observe`, read the range via
    :meth:`amax`, convert to a grid with :meth:`qspec`."""

    #: registry name (subclasses set it; ``make_observer`` resolves it)
    kind = "base"

    def __init__(self):
        self.batches = 0

    def observe(self, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.size == 0:
            return
        self._update(np.abs(x.astype(np.float64, copy=False)))
        self.batches += 1

    def _update(self, ax: np.ndarray) -> None:
        raise NotImplementedError

    def amax(self) -> float:
        raise NotImplementedError

    def exponent(self, bits: int = 8, signed: bool = False) -> int:
        return pow2_exponent(self.amax(), bits, signed)

    def qspec(self, bits: int = 8, signed: bool = False) -> QSpec:
        """The pow2 grid covering the observed range."""
        return QSpec(bits=bits, signed=signed,
                     exp=self.exponent(bits, signed))


class MinMaxObserver(Observer):
    """Running ``max |x|`` over everything ever observed."""

    kind = "minmax"

    def __init__(self):
        super().__init__()
        self._amax = 0.0

    def _update(self, ax):
        self._amax = max(self._amax, float(ax.max()))

    def amax(self) -> float:
        return self._amax


class MovingAverageObserver(Observer):
    """EMA of the per-batch ``max |x|`` (``momentum`` weights the history).
    The first batch seeds the average, so a single calibration batch behaves
    exactly like :class:`MinMaxObserver`."""

    kind = "ema"

    def __init__(self, momentum: float = 0.9):
        super().__init__()
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1): {momentum}")
        self.momentum = momentum
        self._avg = None

    def _update(self, ax):
        m = float(ax.max())
        self._avg = m if self._avg is None else \
            self.momentum * self._avg + (1.0 - self.momentum) * m

    def amax(self) -> float:
        return 0.0 if self._avg is None else self._avg


class PercentileObserver(Observer):
    """Running max of the per-batch ``percentile(|x|)`` — the classic
    outlier-clipping observer.  ``percentile=100`` degenerates to minmax."""

    kind = "percentile"

    def __init__(self, percentile: float = 99.9):
        super().__init__()
        if not 0.0 < percentile <= 100.0:
            raise ValueError(f"percentile must be in (0, 100]: {percentile}")
        self.percentile = percentile
        self._amax = 0.0

    def _update(self, ax):
        self._amax = max(self._amax,
                         float(np.percentile(ax, self.percentile)))

    def amax(self) -> float:
        return self._amax


_OBSERVERS = {c.kind: c for c in
              (MinMaxObserver, MovingAverageObserver, PercentileObserver)}


def make_observer(kind: str, **kw) -> Observer:
    """Factory by registry name (``minmax`` / ``ema`` / ``percentile``)."""
    if kind not in _OBSERVERS:
        raise ValueError(
            f"unknown observer {kind!r}; choose from {sorted(_OBSERVERS)}")
    return _OBSERVERS[kind](**kw)
