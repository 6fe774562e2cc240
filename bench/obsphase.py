"""The obs phase of a ``--trace 1`` run: the program's own call spans.

``record(rec)`` runs the phase once a run, on the first call of a reader
that needs it, and keeps what it found in ``rec["obs"]`` for the others.
It prints one line to standard error.  The phase runs in a process of its
own (``python3 -m bench.obsphase <spec>``): after a ``torch.profiler``
session a process's CUDA calls stay slower (the host's enqueue of a call
rose from 50 to 78-88 us on an H100's host), and the run's own program is
freed before its check.  There it builds the cell's program from the
run's seed (``models/<family>.py``), warms it with the mix's
``warmup_calls``, installs a session from ``repro_torch.obs.instrument()``
(no profiler), makes ``SESSION_WARMUP`` calls of the harness's closed
loop (``run.Loop``), whose first anchors the device and makes the
session's ring of events, then ``trace_calls`` calls more, calls the
session's ``flush()``, uninstalls it and reduces the spans of those
``trace_calls`` calls (``reduce``).  The process exits 3 if it holds JAX
or the JAX package after the phase, as ``run.main`` does after the
window.

The phase's process is not the window's, so which of the modes that
runs fall into between processes the window met cannot be read from it.
Its calls pay for the session, and where that makes them slower than the
window's (``PACED_SHARE``), its line says so: the device then waits for
a host the session slowed, and its spans and gaps hold that idle.

A program without call spans (no ``Observability.flush``) runs no phase:
the readers then find nothing and return None.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

EARLY_SLACK_S = 5e-6    # a device start may lead its host copy_in by this
PACED_SHARE = 0.10      # a phase period this far above the window's: flagged
PHASES = ("copy_in", "replay", "clone")
TIMER = "timer"         # the tracer's own child: the start event's record
SESSION_WARMUP = 64     # calls with the session on before the timed ones


def reduce(events, skip=0):
    """Per-call numbers from a session's trace events (``TraceEvent``):
    host span durations, ``call``'s self time, the device span of each
    call and the gap from one call's device end to the next one's start,
    the gaps' time summed by the innermost host span over their midpoint
    (``none``: no call's span, so the caller's own code), and the check of
    the clock: how many calls' device start lies before their host
    ``copy_in`` start by more than ``EARLY_SLACK_S`` plus the anchor's
    uncertainty (``early_calls``), and before the start of the ``timer``
    that recorded its start event (``early_record_calls``: a host stall
    after the record delays ``copy_in`` but not the device, so this one
    tests the clock alone); ``first_call_us``, the host span of the
    session's first call, which sets the tracing up.  Calls numbered up
    to ``skip`` are left out of the rest.  None when the events hold no
    call span."""
    host, dev, anchor_us = {}, {}, []
    for e in events:
        a = e.args or {}
        if e.ph == "i" and e.name == "anchor":
            anchor_us.append(a["wall_us"])
        elif e.ph == "X" and "call" in a:
            span = (e.ts, e.ts + e.dur)
            if e.cat == "kernel":
                dev[a["call"]] = span
            else:
                host.setdefault(a["call"], {})[e.name] = span
    calls = sorted(c for c, s in host.items() if "call" in s)
    if not calls or calls[-1] <= skip:
        return None
    first = (host[calls[0]]["call"][1] - host[calls[0]]["call"][0]) * 1e6
    calls = [c for c in calls if c > skip]
    out = dict(calls=len(calls), first_call_us=first, call_us=[],
               call_self_us=[], device_us=[], gap_us=[], gap_by_span_us={},
               anchor_us=max(anchor_us, default=None), early_calls=0,
               early_worst_us=None, early_record_calls=0, device_calls=0)
    slack_us = EARLY_SLACK_S * 1e6 + (out["anchor_us"] or 0.0)
    for name in (TIMER,) + PHASES:
        out[name + "_us"] = []
    for c in calls:
        s = host[c]
        t0, t1 = s["call"]
        kids = sum(b - a for n, (a, b) in s.items() if n != "call")
        out["call_us"].append((t1 - t0) * 1e6)
        out["call_self_us"].append((t1 - t0 - kids) * 1e6)
        for name in (TIMER,) + PHASES:
            if name in s:
                out[name + "_us"].append((s[name][1] - s[name][0]) * 1e6)
        if c in dev:
            out["device_calls"] += 1
            out["device_us"].append((dev[c][1] - dev[c][0]) * 1e6)
            if "copy_in" in s:
                lead = (s["copy_in"][0] - dev[c][0]) * 1e6
                worst = out["early_worst_us"]
                out["early_worst_us"] = lead if worst is None \
                    else max(worst, lead)
                out["early_calls"] += lead > slack_us
            if TIMER in s:
                lead = (s[TIMER][0] - dev[c][0]) * 1e6
                out["early_record_calls"] += lead > slack_us
    starts = [host[c]["call"][0] for c in calls]
    for c in calls:
        if c not in dev or c + 1 not in dev:
            continue
        gap = (dev[c + 1][0] - dev[c][1]) * 1e6
        out["gap_us"].append(gap)
        name = _covering(host, calls, starts,
                         (dev[c][1] + dev[c + 1][0]) / 2)
        out["gap_by_span_us"][name] = \
            out["gap_by_span_us"].get(name, 0.0) + max(gap, 0.0)
    return out


def _covering(host, calls, starts, t):
    """The innermost host span of any call that covers time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0 or host[calls[i]]["call"][1] < t:
        return "none"
    s = host[calls[i]]
    for name in (TIMER,) + PHASES:
        if name in s and s[name][0] <= t <= s[name][1]:
            return name
    return "call"


def median(values):
    return statistics.median(values) if values else None


def run_args():
    """``(seed, seconds)``: the run's ``--seed`` and ``--seconds``, from its
    command line, which must hold both."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    args = p.parse_known_args(sys.argv[1:])[0]
    if args.seed is None or args.seconds is None:
        raise RuntimeError("the obs phase needs the run's --seed and "
                           "--seconds on its command line")
    return args.seed, args.seconds


def record(rec):
    """``rec["obs"]``, the obs phase's reduction, run on first use; None
    without a profiled phase in ``rec`` (a ``--trace 0`` record), without
    a CUDA card, or with a program that records no call spans."""
    if "obs" not in rec:
        rec["obs"] = None
        if rec.get("trace") is not None and torch.cuda.is_available():
            from repro_torch import obs
            if hasattr(obs.Observability, "flush"):
                seed, seconds = run_args()
                rec["obs"] = isolated(rec["cfg"], rec["mix"], seed,
                                      "cuda:0")
                if rec["obs"] is not None:
                    calls = len(rec["window"]["enqueue_s"])
                    rec["obs"]["window_period_us"] = seconds / calls * 1e6
        if rec["obs"] is not None:
            print(summary(rec["obs"], rec), file=sys.stderr, flush=True)
    return rec["obs"]


def isolated(cfg, mix, seed, device: str):
    """``phase`` in a fresh process on ``device``; its reduction."""
    with tempfile.TemporaryDirectory() as d:
        spec = Path(d) / "spec.json"
        spec.write_text(json.dumps(dict(cfg=cfg, mix=mix, seed=seed,
                                        device=device)))
        sys.stderr.flush()
        proc = subprocess.run(
            [sys.executable, "-m", "bench.obsphase", str(spec)], cwd=ROOT,
            stdout=sys.stderr, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the obs phase exited {proc.returncode}")
        return json.loads((Path(d) / "out.json").read_text())


def main(argv) -> int:
    """The process of ``isolated``: the spec's phase, written beside it."""
    from bench import run

    spec_path = Path(argv[0])
    spec = json.loads(spec_path.read_text())
    run.import_port()
    from repro_torch import obs
    torch.set_num_threads(1)
    out = phase(spec["cfg"], spec["mix"], spec["seed"],
                torch.device(spec["device"]), obs)
    bad = run.forbidden_modules()
    if bad:
        print(f"bench: the obs phase's process holds {bad}", file=sys.stderr)
        return 3
    (spec_path.parent / "out.json").write_text(json.dumps(out))
    return 0


def phase(cfg, mix, seed, device, obs):
    """Build the cell's program on ``device``, warm it, run ``trace_calls``
    calls with a session of ``obs`` installed, and reduce the session's
    spans (None if it recorded no call span)."""
    from bench import run

    family = importlib.import_module(f"bench.models.{cfg['family']}")
    built = family.build(cfg, mix, seed, device, lambda name: None)
    loop = run.Loop(built.model, built.pool, mix, seed, built.out_width)
    loop.run(calls=mix["warmup_calls"])
    gc.collect()
    gc.disable()
    try:
        with obs.instrumented() as ob:
            loop.run(calls=SESSION_WARMUP)
            t0 = time.perf_counter()
            st = loop.run(calls=mix["trace_calls"])
            period_us = (time.perf_counter() - t0) / st.calls * 1e6
            ob.flush()
    finally:
        gc.enable()
    out = reduce(ob.trace.events, skip=SESSION_WARMUP)
    if out is not None:
        out.update(period_us=period_us,
                   enqueue_us=median(st.enqueue_s) * 1e6)
    return out


def paced_by_session(out):
    """How far the phase's period lies above the window's, as a share of
    the window's, where it lies more than ``PACED_SHARE`` above; else
    None."""
    win = out.get("window_period_us")
    if win is None or out["period_us"] <= win * (1 + PACED_SHARE):
        return None
    return out["period_us"] / win - 1


def summary(out, rec):
    """The phase's line on standard error."""
    def us(v):
        return "-" if v is None else f"{v:.2f}"

    win = median(rec.get("window", {}).get("enqueue_s") or [])
    gaps = len(out["gap_us"]) or 1
    split = ", ".join(f"{k} {v / gaps:.2f}" for k, v in sorted(
        out["gap_by_span_us"].items(), key=lambda kv: -kv[1]))
    paced = paced_by_session(out)
    flag = "" if paced is None else (
        f"; PACED BY THE SESSION: the phase's period is {paced:.1%} above "
        f"the window's, so its device spans and gaps hold idle the "
        f"session made")
    return (f"bench: obs phase {out['calls']} calls, host us a call "
            f"{us(out['period_us'])} (window "
            f"{us(out.get('window_period_us'))}), enqueue median "
            f"{us(out['enqueue_us'])} (window, no session: "
            f"{us(None if win is None else win * 1e6)}"
            f"; the session's first call {us(out['first_call_us'])}"
            f"); median us: call {us(median(out['call_us']))}, self "
            f"{us(median(out['call_self_us']))}, timer "
            f"{us(median(out['timer_us']))}, copy_in "
            f"{us(median(out['copy_in_us']))}, replay "
            f"{us(median(out['replay_us']))}, clone "
            f"{us(median(out['clone_us']))}, device "
            f"{us(median(out['device_us']))}, gap "
            f"{us(median(out['gap_us']))}; gap us a call by the host span "
            f"over it: {split or '-'}; device start before copy_in by more "
            f"than {EARLY_SLACK_S * 1e6:.0f} us + anchor "
            f"{us(out['anchor_us'])} us: {out['early_calls']} of "
            f"{out['device_calls']} calls (largest lead "
            f"{us(out['early_worst_us'])} us), before its start event's "
            f"record: {out['early_record_calls']}{flag}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
