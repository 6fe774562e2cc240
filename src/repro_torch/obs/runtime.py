"""The on/off switch every instrumented call site checks.

The port's copy of ``repro.obs.runtime``.  The whole
zero-overhead-when-disabled contract lives here: instrumented code does

    ob = runtime.active()
    if ob is not None:
        ob.metrics.counter(...).inc(...)
        ob.trace.span(...)

so the disabled cost is one module-global read returning ``None`` — no
allocation, no method call, no event object.

``instrument()`` installs a session (optionally bound to a fake clock so a
virtual-time run yields a deterministic event log); ``disable()`` removes
it; ``instrumented()`` is the context-manager form.  Only one session is
active at a time — the last ``instrument()`` wins, which is the right
semantics for a CLI process.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Trace

__all__ = [
    "Observability", "active", "instrument", "install", "disable",
    "instrumented", "export",
]


class Observability:
    """One instrumentation session: a metrics registry + a trace + any
    kernel profiles attached along the way, sharing one clock domain."""

    def __init__(self, clock=None):
        self.clock = clock
        self.metrics = MetricsRegistry()
        self.trace = Trace(clock=clock)
        self.profiles: List = []          # TaskProfile rows (obs.profile)

    def now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.monotonic()

    def set_clock(self, clock) -> None:
        """Re-bind the clock domain (a runner that builds its clock after
        instrumentation was requested calls this before recording)."""
        self.clock = clock
        self.trace.clock = clock


_ACTIVE: Optional[Observability] = None


def active() -> Optional[Observability]:
    """The installed session, or None — THE hot-path check."""
    return _ACTIVE


def instrument(clock=None) -> Observability:
    """Install (and return) a fresh observability session."""
    global _ACTIVE
    _ACTIVE = Observability(clock=clock)
    return _ACTIVE


def install(ob: Optional[Observability]) -> Optional[Observability]:
    """(Re)install a specific session (or ``None`` to uninstall) — how a
    caller toggles one accumulating session on and off, and restores
    whatever was active before it borrowed the switch."""
    global _ACTIVE
    _ACTIVE = ob
    return ob


def disable() -> Optional[Observability]:
    """Uninstall the session; returns it so callers can still export."""
    global _ACTIVE
    ob, _ACTIVE = _ACTIVE, None
    return ob


@contextlib.contextmanager
def instrumented(clock=None):
    """``with obs.instrumented() as ob: ...`` — always uninstalls."""
    ob = instrument(clock=clock)
    try:
        yield ob
    finally:
        disable()


def export(ob: Observability, trace_out: Optional[str] = None,
           metrics_out: Optional[str] = None,
           jsonl_out: Optional[str] = None,
           strip_volatile: bool = False) -> dict:
    """Write the session's artifacts; returns {kind: path} for what was
    written.  ``trace_out`` gets Chrome ``trace_event`` JSON (Perfetto),
    ``jsonl_out`` the line-per-event log, ``metrics_out`` Prometheus text."""
    written = {}
    if trace_out:
        ob.trace.write_chrome(trace_out, strip_volatile=strip_volatile)
        written["trace"] = trace_out
    if jsonl_out:
        ob.trace.write_jsonl(jsonl_out, strip_volatile=strip_volatile)
        written["jsonl"] = jsonl_out
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(ob.metrics.render_text())
        written["metrics"] = metrics_out
    return written
