"""Deterministic, seeded arrival-process generators.

The port's copy of ``repro.traffic.loadgen``: numpy ``Generator`` draws in
the same order, so the same seed gives the same arrivals in both packages.
The paper's throughput claims (Table 3: ResNet8 at 30153 FPS, ResNet20 at
7601 FPS on the Kria KV260 FPGA) are steady-state numbers; real serving traffic
is not steady.  This module produces the arrival processes the SLO and
autoscaling layers are exercised against:

* :class:`PoissonProcess` — memoryless arrivals at a constant rate (the
  textbook open-loop load model).
* :class:`OnOffProcess` — Markov-modulated bursts: the source alternates
  between an ON state (high rate) and an OFF state (low/zero rate) with
  exponentially distributed holding times — the camera-stream / continuous
  -source shape of Baskin et al.'s streaming architecture (PAPERS.md).
* :class:`DiurnalProcess` — a sinusoidally rate-modulated Poisson process
  (generated by thinning), the day/night envelope scaled down to seconds.
* :class:`TraceReplay` — replay a recorded JSON trace file verbatim.

Every generator is a pure function of its ``seed``: the same seed produces
the *identical* arrival sequence (pinned in tests/test_torch_traffic.py),
so an overload experiment is reproducible down to the request.  Arrivals
carry the SLO class name they were admitted under (drawn from a weighted
``class_mix`` with the same seeded generator).

Trace JSON format (``save_trace`` / ``load_trace`` round-trip exactly)::

    {"version": 1,
     "meta":    {...anything, e.g. the generator spec...},
     "arrivals": [{"t": 0.0123, "slo": "standard", "source": 0}, ...]}
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One timestamped request: ``t`` seconds since trace start, the SLO
    class name it belongs to, and a logical source id (e.g. camera index)."""

    t: float
    slo: str
    source: int = 0

    def to_dict(self) -> dict:
        return dict(t=self.t, slo=self.slo, source=self.source)

    @classmethod
    def from_dict(cls, d: dict) -> "Arrival":
        return cls(t=float(d["t"]), slo=str(d["slo"]),
                   source=int(d.get("source", 0)))


def _normalize_mix(class_mix: Optional[Dict[str, float]]) -> Dict[str, float]:
    if not class_mix:
        return {"standard": 1.0}
    total = float(sum(class_mix.values()))
    if total <= 0:
        raise ValueError(f"class_mix weights must sum > 0: {class_mix}")
    return {name: w / total for name, w in class_mix.items()}


class ArrivalProcess:
    """Base: seeded rng + weighted SLO-class assignment.

    ``generate(horizon_s=..., n=...)`` returns the arrival list bounded by a
    time horizon, a request count, or both (whichever cuts first); at least
    one bound is required.  Subclasses implement ``_gap`` — the next
    inter-arrival gap in seconds — or override ``generate`` outright."""

    def __init__(self, seed: int = 0,
                 class_mix: Optional[Dict[str, float]] = None):
        self.seed = int(seed)
        self.class_mix = _normalize_mix(class_mix)

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def _pick_class(self, rng: np.random.Generator) -> str:
        names = sorted(self.class_mix)          # stable draw order
        probs = [self.class_mix[n] for n in names]
        return names[int(rng.choice(len(names), p=probs))]

    def generate(self, horizon_s: Optional[float] = None,
                 n: Optional[int] = None) -> List[Arrival]:
        if horizon_s is None and n is None:
            raise ValueError("bound the process with horizon_s and/or n")
        rng = self._rng()
        out: List[Arrival] = []
        t = 0.0
        while True:
            if n is not None and len(out) >= n:
                break
            t += self._gap(rng, t)
            if horizon_s is not None and t >= horizon_s:
                break
            out.append(Arrival(t=t, slo=self._pick_class(rng)))
        return out

    def _gap(self, rng: np.random.Generator, t: float) -> float:
        raise NotImplementedError


class PoissonProcess(ArrivalProcess):
    """Constant-rate memoryless arrivals: exponential inter-arrival gaps."""

    def __init__(self, rate_hz: float, seed: int = 0,
                 class_mix: Optional[Dict[str, float]] = None):
        super().__init__(seed=seed, class_mix=class_mix)
        if rate_hz <= 0:
            raise ValueError(f"rate_hz must be positive: {rate_hz}")
        self.rate_hz = float(rate_hz)

    def _gap(self, rng, t):
        return float(rng.exponential(1.0 / self.rate_hz))


class OnOffProcess(ArrivalProcess):
    """Markov-modulated on-off bursts.

    The source holds an ON state (arrivals at ``on_rate_hz``) for an
    exponentially distributed duration of mean ``mean_on_s``, then an OFF
    state (``off_rate_hz``, default 0 — silence) for mean ``mean_off_s``,
    and repeats.  The *mean* rate is ``(on_rate*mean_on + off_rate*mean_off)
    / (mean_on + mean_off)`` but the instantaneous rate whipsaws — exactly
    the burst shape that makes a fixed replica count either wasteful or
    deadline-missing, i.e. the autoscaler's reason to exist."""

    def __init__(self, on_rate_hz: float, mean_on_s: float = 0.2,
                 mean_off_s: float = 0.2, off_rate_hz: float = 0.0,
                 seed: int = 0, class_mix: Optional[Dict[str, float]] = None):
        super().__init__(seed=seed, class_mix=class_mix)
        if on_rate_hz <= 0 or mean_on_s <= 0 or mean_off_s <= 0:
            raise ValueError("on_rate_hz, mean_on_s, mean_off_s must be > 0")
        if off_rate_hz < 0:
            raise ValueError(f"off_rate_hz must be >= 0: {off_rate_hz}")
        self.on_rate_hz = float(on_rate_hz)
        self.off_rate_hz = float(off_rate_hz)
        self.mean_on_s = float(mean_on_s)
        self.mean_off_s = float(mean_off_s)

    def generate(self, horizon_s: Optional[float] = None,
                 n: Optional[int] = None) -> List[Arrival]:
        if horizon_s is None and n is None:
            raise ValueError("bound the process with horizon_s and/or n")
        rng = self._rng()
        out: List[Arrival] = []
        t = 0.0
        on = True
        state_end = float(rng.exponential(self.mean_on_s))
        while True:
            if n is not None and len(out) >= n:
                break
            rate = self.on_rate_hz if on else self.off_rate_hz
            if rate <= 0:                      # silent state: jump to its end
                t = state_end
            else:
                t = t + float(rng.exponential(1.0 / rate))
            while t >= state_end:              # state expired before arrival
                on = not on
                mean = self.mean_on_s if on else self.mean_off_s
                start = state_end
                state_end = start + float(rng.exponential(mean))
                rate = self.on_rate_hz if on else self.off_rate_hz
                if rate <= 0:
                    t = state_end
                else:
                    t = start + float(rng.exponential(1.0 / rate))
            if horizon_s is not None and t >= horizon_s:
                break
            out.append(Arrival(t=t, slo=self._pick_class(rng)))
        return out


class DiurnalProcess(ArrivalProcess):
    """Sinusoidally rate-modulated Poisson arrivals, generated by thinning.

    ``rate(t) = base + (peak - base) * (1 + sin(2*pi*t/period - pi/2)) / 2``
    starts at the trough, peaks at ``period/2`` — a day compressed into
    ``period_s`` seconds.  Candidate arrivals are drawn at the peak rate and
    accepted with probability ``rate(t)/peak`` (Lewis-Shedler thinning), so
    the output is an exact inhomogeneous Poisson sample."""

    def __init__(self, base_rate_hz: float, peak_rate_hz: float,
                 period_s: float = 10.0, seed: int = 0,
                 class_mix: Optional[Dict[str, float]] = None):
        super().__init__(seed=seed, class_mix=class_mix)
        if not (0 < base_rate_hz <= peak_rate_hz):
            raise ValueError(
                f"need 0 < base_rate_hz <= peak_rate_hz: "
                f"{base_rate_hz}, {peak_rate_hz}")
        if period_s <= 0:
            raise ValueError(f"period_s must be positive: {period_s}")
        self.base_rate_hz = float(base_rate_hz)
        self.peak_rate_hz = float(peak_rate_hz)
        self.period_s = float(period_s)

    def rate_at(self, t: float) -> float:
        phase = 2.0 * np.pi * t / self.period_s - np.pi / 2.0
        return self.base_rate_hz + (self.peak_rate_hz - self.base_rate_hz) \
            * (1.0 + float(np.sin(phase))) / 2.0

    def generate(self, horizon_s: Optional[float] = None,
                 n: Optional[int] = None) -> List[Arrival]:
        if horizon_s is None and n is None:
            raise ValueError("bound the process with horizon_s and/or n")
        rng = self._rng()
        out: List[Arrival] = []
        t = 0.0
        while True:
            if n is not None and len(out) >= n:
                break
            t += float(rng.exponential(1.0 / self.peak_rate_hz))
            if horizon_s is not None and t >= horizon_s:
                break
            if float(rng.random()) <= self.rate_at(t) / self.peak_rate_hz:
                out.append(Arrival(t=t, slo=self._pick_class(rng)))
        return out


class TraceReplay:
    """Replay a recorded arrival list (or JSON trace file) verbatim."""

    def __init__(self, arrivals: Sequence[Arrival]):
        self.arrivals = sorted(arrivals, key=lambda a: (a.t, a.source))

    @classmethod
    def from_file(cls, path: str) -> "TraceReplay":
        return cls(load_trace(path))

    def generate(self, horizon_s: Optional[float] = None,
                 n: Optional[int] = None) -> List[Arrival]:
        out = self.arrivals
        if horizon_s is not None:
            out = [a for a in out if a.t < horizon_s]
        if n is not None:
            out = out[:n]
        return list(out)


# ---------------------------------------------------------------------------
# Trace file IO
# ---------------------------------------------------------------------------


def save_trace(path: str, arrivals: Sequence[Arrival],
               meta: Optional[dict] = None) -> None:
    """Write arrivals as the versioned JSON trace format (round-trips via
    :func:`load_trace` exactly — floats survive JSON's repr round-trip)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = dict(version=TRACE_VERSION, meta=meta or {},
               arrivals=[a.to_dict() for a in arrivals])
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_trace(path: str) -> List[Arrival]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "arrivals" not in doc:
        raise ValueError(f"{path}: not a traffic trace file")
    if doc.get("version", TRACE_VERSION) > TRACE_VERSION:
        raise ValueError(
            f"{path}: trace version {doc['version']} is newer than "
            f"supported ({TRACE_VERSION})")
    return [Arrival.from_dict(d) for d in doc["arrivals"]]


def make_process(pattern: str, rate_hz: float, seed: int = 0,
                 class_mix: Optional[Dict[str, float]] = None,
                 period_s: float = 10.0,
                 burst_on_s: float = 0.2, burst_off_s: float = 0.2):
    """CLI/bench helper: a named arrival process at a target *mean* rate.

    ``bursty`` concentrates the mean rate into ON windows (ON rate =
    ``rate_hz * (on+off)/on``), so the burst peak overloads a capacity that
    the mean alone would not."""
    if pattern == "poisson":
        return PoissonProcess(rate_hz, seed=seed, class_mix=class_mix)
    if pattern == "bursty":
        on_rate = rate_hz * (burst_on_s + burst_off_s) / burst_on_s
        return OnOffProcess(on_rate, mean_on_s=burst_on_s,
                            mean_off_s=burst_off_s, seed=seed,
                            class_mix=class_mix)
    if pattern == "diurnal":
        return DiurnalProcess(max(rate_hz * 0.25, 1e-6), rate_hz * 1.75,
                              period_s=period_s, seed=seed,
                              class_mix=class_mix)
    raise ValueError(
        f"unknown pattern {pattern!r}; choose poisson|bursty|diurnal")
