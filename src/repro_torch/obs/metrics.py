"""Labelled counters / gauges / histograms with deterministic exposition.

The port's copy of ``repro.obs.metrics``, the same code, so that both
packages render the same text for the same operations.  Zero-dependency
(stdlib only) by design: this module is imported by the hottest layers of
the stack (``compile.compiler``, ``serve.engine``), so it must never pull
in torch or numpy, and recording a sample must stay a couple of dict
operations.

Determinism contract: the registry never reads a clock.  Every value it
holds comes from what the caller recorded, so under a ``FakeClock``-driven
simulation both ``snapshot()`` and ``render_text()`` are byte-stable across
runs — they iterate metrics and label-series in sorted order and format
floats via ``repr`` (shortest round-trip, version-stable on CPython 3.x).

Exposition is Prometheus text format (``# HELP`` / ``# TYPE`` headers,
``name{label="v"} value`` series, ``_bucket{le=...}``/``_sum``/``_count``
for histograms) so the files written by ``--metrics-out`` are scrapable
and diffable.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
]

# Generic latency buckets in milliseconds — wide enough for µs kernel calls
# and second-scale drains alike.  Histograms are cumulative (Prometheus
# style): a sample lands in every bucket whose upper bound is >= the value.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    """Canonical (sorted, stringified) form of a label set."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = key + extra
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def labelled(self) -> Iterable[Tuple[LabelKey, object]]:
        raise NotImplementedError

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count, one value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease: {amount}")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum over every label series."""
        return sum(self._series.values())

    def labelled(self):
        return sorted(self._series.items())

    def snapshot(self) -> dict:
        return {"kind": self.kind,
                "series": {_fmt_labels(k) or "": v
                           for k, v in self.labelled()}}


class Gauge(_Metric):
    """Last-written value per label set (set/add semantics)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = value

    def add(self, amount: float, **labels) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def labelled(self):
        return sorted(self._series.items())

    def snapshot(self) -> dict:
        return {"kind": self.kind,
                "series": {_fmt_labels(k) or "": v
                           for k, v in self.labelled()}}


class Histogram(_Metric):
    """Cumulative-bucket histogram per label set (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help)
        bs = tuple(sorted(buckets)) if buckets is not None else DEFAULT_BUCKETS
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        # label key -> [per-bucket counts..., +Inf count, sum]
        self._series: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        row = self._series.get(key)
        if row is None:
            row = self._series[key] = [0] * (len(self.buckets) + 1) + [0.0]
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                row[i] += 1
        row[len(self.buckets)] += 1          # +Inf == total count
        row[-1] += value

    def count(self, **labels) -> int:
        row = self._series.get(_label_key(labels))
        return int(row[len(self.buckets)]) if row else 0

    def sum(self, **labels) -> float:
        row = self._series.get(_label_key(labels))
        return float(row[-1]) if row else 0.0

    def labelled(self):
        return sorted(self._series.items())

    def snapshot(self) -> dict:
        out = {}
        for key, row in self.labelled():
            out[_fmt_labels(key) or ""] = {
                "buckets": {_fmt_value(ub): row[i]
                            for i, ub in enumerate(self.buckets)},
                "count": row[len(self.buckets)],
                "sum": row[-1],
            }
        return {"kind": self.kind, "series": out}


class MetricsRegistry:
    """Create-or-get metric factory plus deterministic export.

    One registry per :class:`repro_torch.obs.Observability` session.
    ``counter``/``gauge``/``histogram`` are idempotent by name (the help
    string of the first registration wins); asking for an existing name
    with a different kind is a programming error and raises.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kwargs)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def total(self, name: str) -> float:
        """Sum of a counter across all its label series (0 if absent)."""
        m = self._metrics.get(name)
        return m.total() if isinstance(m, Counter) else 0.0

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """Nested-dict view, sorted by metric name — JSON-stable."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def render_text(self) -> str:
        """Prometheus text exposition; byte-stable for identical contents."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, row in m.labelled():
                    acc_bounds = m.buckets + (float("inf"),)
                    for i, ub in enumerate(acc_bounds):
                        le = (("le", _fmt_value(ub)),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(key, le)} "
                            f"{_fmt_value(row[i])}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(row[-1])}")
                    lines.append(f"{name}_count{_fmt_labels(key)} "
                                 f"{_fmt_value(row[len(m.buckets)])}")
            else:
                for key, v in m.labelled():
                    lines.append(f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_text(text: str) -> Dict[str, Dict[str, float]]:
    """Parse Prometheus text exposition back to {metric: {series: value}}.

    Used by the ``python -m repro_torch.obs`` report CLI to summarize a
    ``--metrics-out`` file; tolerant of comments and blank lines, strict
    about malformed sample lines (raises ``ValueError``).
    """
    out: Dict[str, Dict[str, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ValueError(f"line {lineno}: unbalanced labels: {line}")
            name = line[:brace]
            series = line[brace:close + 1]
            rest = line[close + 1:].strip()
        else:
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: expected 'name value': "
                                 f"{line}")
            name, series, rest = parts[0], "", parts[1]
        if not name or not rest:
            raise ValueError(f"line {lineno}: malformed sample: {line}")
        try:
            value = float(rest.split()[0])
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value in: {line}") from e
        out.setdefault(name, {})[series] = value
    return out
