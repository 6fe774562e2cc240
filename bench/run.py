#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload resnet20.b256 --seed 7 --seconds 51 --trace 0

from the root of a checkout on a machine with a CUDA card.  A cell
(``BENCHMARK.json`` ``workloads``) is a configuration (``configs/``) under
a traffic mix (``traffic/``).  The run:

1. set-up (``setup_s``, from this file's first line): imports the port
   (``repro_torch``, from ``src/`` of this checkout); the configuration's
   family (``models/<family>.py``) builds the program under test and its
   inputs from ``--seed`` (for ResNet: the float weights and the image
   pool made on the card, folded, quantized and compiled through the port,
   the mix's bucket captured); then the mix's ``warmup_calls`` calls;
2. the window: ``--seconds`` of calls to ``CompiledModel.__call__`` on
   slices of the pool, in a closed loop of ``depth`` calls in flight, each
   call's logits copied to pinned host memory behind it and seen by the
   host when its event completes;
3. with ``--trace 1``, ``trace_calls`` more calls under ``torch.profiler``
   (the per-layer metrics, ``busy_s`` and ``window_s``, the breakdown);
4. the check: the program's state freed, the plain reference
   (``reference/<family>.py``) computes the logits of a seeded sample of the pool's
   slices, and every logit the program returned for them, in every call of
   the run, is held against it (``logit_gap``).

The result is the last line of standard output; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
the result.  Without a CUDA card, or with fewer cards than the cell asks
for, the run prints no result and exits 2; if the process holds JAX or the
JAX package after the window, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import cells, devtrace, weights, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
REF_BLOCK = 1024        # reference images a block


def import_port():
    """Import the port (``repro_torch``) from ``src/`` of this checkout and
    nowhere else."""
    src = ROOT / "src"
    sys.path.insert(0, str(src))
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise ImportError(f"repro_torch came from {where}, not from {src}")


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def host_cpu():
    """The CPU this process last ran on (Linux), or None."""
    try:
        stat = Path("/proc/self/stat").read_text()
        return int(stat[stat.rindex(")") + 2:].split()[36])
    except (OSError, ValueError, IndexError):
        return None


def slot_plan(n, mix, seed):
    """``(order, sampled)``: the seeded order in which the loop walks the
    pool's ``n`` slices, and the seeded sample of slices that the check
    holds against the reference.  Every seed walks every slice alike."""
    gen = torch.Generator().manual_seed(int(seed) & weights.SEED_MASK)
    order = torch.randperm(n, generator=gen).tolist()
    k = max(1, round(n * mix["sample_share"]))
    return order, sorted(torch.randperm(n, generator=gen)[:k].tolist())


class Stats:
    """What one pass of the loop saw."""

    def __init__(self):
        self.calls = 0
        self.done_in_window = 0
        self.wait_s = 0.0       # the host blocked on a call's event
        self.enqueue_s = []
        self.latency_s = []


class Loop:
    """The closed-loop client: ``depth`` calls of ``batch`` images in
    flight, the pool's slices in a seeded order, each call's logits copied
    to its slice's row of a pinned host buffer behind the call.  For the
    seeded sample of slices it keeps, per logit, the least and the most
    value any call returned, for the check."""

    def __init__(self, model, pool, mix, seed, out_width):
        self.model = model
        self.batch, self.depth = mix["batch"], mix["depth"]
        b = self.batch
        n = pool.shape[0] // b
        self.order, self.sampled = slot_plan(n, mix, seed)
        self.flag = [False] * n
        for s in self.sampled:
            self.flag[s] = True
        self.cuda = pool.device.type == "cuda"
        self.host = torch.empty((n, b, out_width), dtype=torch.float32,
                                pin_memory=self.cuda)
        self.host_np = self.host.numpy()
        self.inputs = [pool[s * b:(s + 1) * b] for s in range(n)]
        self.outputs = [self.host[s] for s in range(n)]
        self.events = [torch.cuda.Event() for _ in range(self.depth + 1)] \
            if self.cuda else None
        self.lo, self.hi = {}, {}
        self.issued = 0

    def _harvest(self, item, until, st):
        slot, t0, ev = item
        tw = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        t = time.perf_counter()
        st.wait_s += t - tw
        st.latency_s.append(t - t0)
        if t <= until:
            st.done_in_window += 1
        if self.flag[slot]:
            v = self.host_np[slot]
            lo = self.lo.get(slot)
            if lo is None:
                self.lo[slot], self.hi[slot] = v.copy(), v.copy()
            else:
                np.minimum(lo, v, out=lo)
                np.maximum(self.hi[slot], v, out=self.hi[slot])

    def run(self, seconds=None, calls=None) -> Stats:
        """Issue calls for ``seconds`` (or ``calls`` calls), then wait for
        the ones in flight."""
        st = Stats()
        pending = collections.deque()
        order, n, model = self.order, len(self.order), self.model
        t_first = time.perf_counter()
        until = t_first + seconds if seconds is not None else math.inf
        while calls is None or st.calls < calls:
            if time.perf_counter() >= until:
                break
            if len(pending) >= self.depth:
                self._harvest(pending.popleft(), until, st)
            slot = order[self.issued % n]
            ev = self.events[self.issued % (self.depth + 1)] \
                if self.cuda else None
            self.issued += 1
            t0 = time.perf_counter()
            out = model(self.inputs[slot])
            t1 = time.perf_counter()
            self.outputs[slot].copy_(out, non_blocking=True)
            if ev is not None:
                ev.record()
            pending.append((slot, t0, ev))
            st.enqueue_s.append(t1 - t0)
            st.calls += 1
        while pending:
            self._harvest(pending.popleft(), until, st)
        return st


def traced(loop, calls):
    """``calls`` calls under ``torch.profiler`` (CPU and CUDA activity), in
    the ``devtrace.WINDOW`` annotation, reduced by ``devtrace.reduce``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            st = loop.run(calls=calls)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = devtrace.load(path)
    out = devtrace.reduce(events,
                          devtrace.kernel_table(cells.BENCH / "port_kernels"))
    out.update(calls=st.calls, images=st.calls * loop.batch)
    return out


def check(loop, params, pool, cfg):
    """Hold every logit returned for the sampled slices against the plain
    reference: ``logit_gap`` is the widest distance of any returned logit
    from the reference's (over every call of the run), ``failed`` the
    sampled images with a logit beyond the limit, ``slots_unchecked`` the
    sampled slices no call returned."""
    ref = importlib.import_module(f"bench.reference.{cfg['family']}")
    net = ref.prepare(params, cfg)
    limit = cfg["limits"]["logit_gap"]
    seen = [s for s in loop.sampled if s in loop.lo]
    b = loop.batch
    per = max(1, REF_BLOCK // b)
    gap, failed = 0.0, 0
    with weights.exact_float():
        for i in range(0, len(seen), per):
            slots = seen[i:i + per]
            x = torch.cat([pool[s * b:(s + 1) * b] for s in slots])
            r = ref.logits(net, x).cpu().numpy().reshape(len(slots), b, -1)
            lo = np.stack([loop.lo[s] for s in slots]).astype(np.float64)
            hi = np.stack([loop.hi[s] for s in slots]).astype(np.float64)
            g = np.maximum(np.abs(hi - r), np.abs(lo - r)).max(axis=-1)
            g = np.where(np.isnan(g), np.inf, g)
            gap = max(gap, float(g.max()))
            failed += int((g > limit).sum())
    return dict(logit_gap=gap, failed=failed, checked=len(seen) * b,
                slots_unchecked=len(loop.sampled) - len(seen))


def run_cell(cell, seed, seconds, trace, device, t_start):
    """One run of ``cell`` on ``device``; returns the result dict (without
    the ``device`` block's name, which the caller adds)."""
    stages = {"import": time.perf_counter() - t_start}

    def stage(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stages[name] = time.perf_counter() - t_start - sum(stages.values())

    import_port()
    stage("port")           # the port imported, the CUDA context made
    cfg, mix = cell.cfg, cell.mix
    family = importlib.import_module(f"bench.models.{cfg['family']}")
    built = family.build(cfg, mix, seed, device, stage)
    params, pool = built.params, built.pool
    loop = Loop(built.model, pool, mix, seed, built.out_width)
    loop.run(calls=mix["warmup_calls"])
    stage("warmup")
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.disable()        # no collector pass inside the window
    try:
        win = loop.run(seconds=seconds)
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    tr = traced(loop, mix["trace_calls"]) if trace else None
    loop.model = built = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chk = check(loop, params, pool, cfg)
    return dict(setup_s=setup_s, stages=stages, window=win, seconds=seconds,
                trace=tr, check=chk, memory_peak_bytes=int(peak),
                batch=loop.batch, attempted=win.calls * loop.batch)


def metrics_of(cell, res, peak):
    """The result's ``metrics``: the cell's end-to-end metrics (trace 0) or
    its per-layer metrics (trace 1), each reader's value with its unit."""
    out, win = {}, res["window"]
    if res["trace"] is None:
        values = dict(images_per_s=win.done_in_window * res["batch"]
                      / res["seconds"],
                      setup_s=res["setup_s"])
        for m in cell.end_to_end:
            out[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
        return out
    rec = dict(cfg=cell.cfg, mix=cell.mix, peak=peak, trace=res["trace"],
               window=dict(enqueue_s=win.enqueue_s, latency_s=win.latency_s))
    for m in cell.per_layer:
        v = cells.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def result_line(cell, res, kind, count):
    limits = cell.cfg["limits"]
    chk = res["check"]
    checks = dict(
        logit_gap=dict(value=chk["logit_gap"], limit=limits["logit_gap"]),
        slots_unchecked=dict(value=chk["slots_unchecked"],
                             limit=limits["slots_unchecked"]))
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and chk["failed"] == 0
    device = dict(platform="gpu", kind=kind, count=count,
                  memory_peak_bytes=res["memory_peak_bytes"])
    line = dict(correct=correct, attempted=res["attempted"],
                failed=chk["failed"],
                metrics=metrics_of(cell, res, work.peaks(kind)),
                device=device)
    if res["trace"] is not None:
        tr = res["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = tr["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.cell(cells.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    line = result_line(cell, res, torch.cuda.get_device_name(device),
                       cell.chips)
    chk = res["check"]
    print("bench: set-up s " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stages"].items()), file=sys.stderr)
    win = res["window"]
    print(f"bench: window {win.calls} calls, host us a call "
          f"{args.seconds / max(win.calls, 1) * 1e6:.2f} (enqueue "
          f"{sum(win.enqueue_s) / max(win.calls, 1) * 1e6:.2f}, blocked on "
          f"the device {win.wait_s / max(win.calls, 1) * 1e6:.2f}), "
          f"last on cpu {host_cpu()}", file=sys.stderr)
    print(f"bench: {cell.name} seed {args.seed}: checked {chk['checked']} "
          f"images over every call of the run", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
