"""Fault-tolerant training loop.

  * periodic async checkpoints (atomic; retention);
  * auto-resume from the latest checkpoint, including the data-pipeline
    state (kept in the checkpoint's ``extra``), so restarts are bitwise
    reproducible;
  * SIGTERM/SIGINT -> checkpoint now, then a clean exit (preemption);
  * step watchdog: a step exceeding ``watchdog_s`` is logged as a straggler
    or hang and (optionally) aborts so a scheduler can restart the job.

A train step is ``train_step(params, opt_state, step, batch) -> (params,
opt_state, metrics)`` over trees of tensors; :func:`make_train_step` builds
one from a loss and an optimizer.  The loop waits for each step's metrics
on their device before it disarms the watchdog.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import tree as T
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    watchdog_s: float = 0.0          # 0 = disabled
    abort_on_hang: bool = False
    log_every: int = 10


class Watchdog:
    def __init__(self, limit_s: float, abort: bool, log):
        self.limit_s, self.abort, self.log = limit_s, abort, log
        self._timer = None
        self.fired = 0

    def _fire(self):
        self.fired += 1
        self.log(f"[watchdog] step exceeded {self.limit_s}s — straggler or "
                 f"hung collective; {'aborting' if self.abort else 'noting'}")
        if self.abort:
            os._exit(42)  # let the scheduler restart from the last checkpoint

    def arm(self):
        if self.limit_s <= 0:
            return
        self.disarm()
        self._timer = threading.Timer(self.limit_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def value_and_grad(loss_fn: Callable, params):
    """``((loss, aux), grads)`` of ``loss_fn(params) -> (loss, aux)``:
    ``grads`` has the structure of ``params``, with ``None`` where the loss
    does not read a leaf (the optimizers count it as zero), each DTensor
    gradient on its leaf's placements.  The tensors of ``aux`` come back
    detached, so that no metric holds the graph."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    loss, aux = loss_fn(T.unflatten(params, leaves))
    grads = [_on_placements(g, p) for g, p in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    aux = T.tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                     else x, aux)
    return (loss.detach(), aux), T.unflatten(params, list(grads))


def _on_placements(g, p):
    """A DTensor gradient on its parameter's placements (a gradient that
    arrives partial, e.g. the embedding's scatter-add summed over the
    ranks' rows, is reduced here)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(loss_fn: Callable, opt, device) -> Callable:
    """``train_step(params, opt_state, step, batch)`` for :func:`run`:
    the batch's arrays become tensors on ``device``, then one gradient of
    ``loss_fn(params, batch) -> (loss, metrics)`` and one optimizer
    update."""
    def step(params, opt_state, i, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        (_, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, batch), params)
        params, opt_state = opt.update(grads, opt_state, params, i)
        return params, opt_state, metrics
    return step


def _wait(metrics: dict) -> None:
    """Block until the step's metrics exist on their device."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return


def run(loop_cfg: LoopConfig, *, params, opt_state, train_step: Callable,
        pipeline, shardings=None, log: Callable = print):
    """Generic loop over ``train_step(params, opt_state, step, batch)``.
    A restore places each of the checkpoint's leaves on ``shardings`` (the
    ``(params, opt_state)`` shardings, any mesh) when given, else on the
    device (or the mesh and placements) of the leaf it replaces.  Under a
    process group every rank runs the loop and rank 0 alone writes."""
    start_step = 0
    if loop_cfg.ckpt_dir and ckpt_lib.latest_steps(loop_cfg.ckpt_dir):
        (params, opt_state), start_step, extra = ckpt_lib.restore(
            loop_cfg.ckpt_dir, (params, opt_state), shardings=shardings)
        if "pipeline" in extra:
            pipeline.state = type(pipeline.state).from_dict(extra["pipeline"])
        log(f"[resume] restored step {start_step}")
        start_step += 1

    stop = {"now": False}

    def _sig(_signum, _frame):
        log("[signal] preemption — checkpointing and exiting")
        stop["now"] = True

    prev_int = signal.signal(signal.SIGINT, _sig)
    prev_term = signal.signal(signal.SIGTERM, _sig)
    wd = Watchdog(loop_cfg.watchdog_s, loop_cfg.abort_on_hang, log)
    metrics = {}
    step = start_step
    try:
        t_loop = time.time()
        for step in range(start_step, loop_cfg.total_steps):
            batch = pipeline.next()
            wd.arm()
            params, opt_state, metrics = train_step(params, opt_state, step,
                                                    batch)
            _wait(metrics)
            wd.disarm()
            if step % loop_cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                log(f"[step {step}] {m} ({time.time()-t_loop:.1f}s)")
            if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every and
                    (step + 1) % loop_cfg.ckpt_every == 0):
                ckpt_lib.save_async(
                    loop_cfg.ckpt_dir, step, (params, opt_state),
                    extra=dict(pipeline=pipeline.state.to_dict()),
                    keep=loop_cfg.keep)
            if stop["now"]:
                break
    finally:
        wd.disarm()
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)
    if loop_cfg.ckpt_dir:
        # an async save of this same step writes the same tmp.<step>
        # directory: let it finish before the final synchronous save
        ckpt_lib.wait_pending()
        ckpt_lib.save(loop_cfg.ckpt_dir, step, (params, opt_state),
                      extra=dict(pipeline=pipeline.state.to_dict()),
                      keep=loop_cfg.keep)
    return params, opt_state, metrics
