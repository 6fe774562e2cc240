"""Reduce a profiler trace of the traced window to what the readers need.

The input is the Chrome trace that ``torch.profiler`` exports (CPU and CUDA
activities): device events are the kernels, copies and memsets CUPTI saw
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``), host events the
operators, annotations and CUDA runtime calls.  The window is the host
annotation ``WINDOW`` that the harness wraps around the traced calls.

Each device event gets one class:

* ``port`` - a kernel of the port, recognised by its entry point's name
  (``port_kernels/*.json``); ``conv`` marks the conv kernels among them;
* ``harness`` - the benchmark's own copy of the logits to pinned host
  memory (device to host);
* ``glue`` - everything else the program ran: PyTorch's elementwise and
  reduction kernels, the CUDA graph's device-to-device copies.
"""
from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 96


def kernel_table(directory: Path) -> list:
    """``[(compiled regex, kernel, conv)]`` from every ``*.json`` file of
    ``directory``: ``{"entries": [entry point names], "conv": bool}``,
    the kernel named by the file."""
    out = []
    for path in sorted(directory.glob("*.json")):
        d = json.loads(path.read_text())
        for entry in d["entries"]:
            out.append((re.compile(rf"\b{re.escape(entry)}\s*[<(]"),
                        path.stem, bool(d["conv"])))
    return out


def classify(ev, table):
    """``(class, kernel or None, conv)`` of one device event."""
    if ev["cat"] == "kernel":
        for rx, kernel, conv in table:
            if rx.search(ev["name"]):
                return "port", kernel, conv
    if ev["cat"] == "gpu_memcpy" and "DtoH" in ev["name"]:
        return "harness", None, False
    return "glue", None, False


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t):
    """Name of the shortest host event that covers time ``t``."""
    best = None
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        ts, end, name = host[j]
        if end >= t and (best is None or end - ts < best[0]):
            best = (end - ts, name)
    return best[1] if best else "python (no operator)"


def reduce(events, table) -> dict:
    """The traced window's numbers from a list of Chrome trace events:
    ``window_s``, ``busy_s`` (the union of device events inside the window),
    device seconds by class and by port kernel, and the breakdown's two
    lists (device operations by time; idle time by what the host ran)."""
    win = [e for e in events if e.get("ph") == "X" and
           e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t, e))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, e["name"]))
    by_class = dict(port=0.0, conv=0.0, harness=0.0, glue=0.0)
    by_kernel, by_name = {}, {}
    for s, t, e in dev:
        d = (t - s) * 1e-6
        cls, kernel, conv = classify(e, table)
        by_class[cls] += d
        if conv:
            by_class["conv"] += d
        if kernel is not None:
            by_kernel[kernel] = by_kernel.get(kernel, 0.0) + d
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + d
    busy = _union([(s, t) for s, t, _ in dev])
    host.sort()
    starts = [h[0] for h in host]
    gaps, edge = {}, w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            name = _innermost(host, starts, (edge + s) / 2)
            gaps[name] = gaps.get(name, 0.0) + (s - edge) * 1e-6
        edge = max(edge, t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=(w1 - w0) * 1e-6,
                busy_s=sum(t - s for s, t in busy) * 1e-6,
                device_s=by_class, kernel_s=by_kernel,
                breakdown=dict(device_ops=[list(kv) for kv in top],
                               idle_gaps=[list(kv) for kv in idle]))


def load(path: Path) -> list:
    d = json.loads(Path(path).read_text())
    return d["traceEvents"] if isinstance(d, dict) else d
