"""Step builders shared by the trainer and the server (the port of
``repro.launch.steps``): the train step with gradient accumulation, the
prefill and decode steps (run without autograd), and the default LM
optimizer."""
from __future__ import annotations

import torch

from repro_torch.core import tree as T
from repro_torch.models import model as M
from repro_torch.parallel import ctx
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import value_and_grad


def make_train_step(cfg, opt, grad_accum: int = 1):
    """``(params, opt_state, step, batch) -> (params, opt_state,
    metrics)`` over a batch of tensors on the parameters' device.

    ``grad_accum > 1`` splits the leading batch axis into ``grad_accum``
    microbatches of ``B // grad_accum`` rows and sums their gradients in
    each parameter's dtype (a bf16 model accumulates in bf16, as the
    reference's ``zeros(p.shape, p.dtype)`` plus ``add``), then divides by
    ``grad_accum`` in that dtype; ``metrics`` are the last microbatch's.
    This bounds activation memory; the optimizer step happens once.

    The params and moments are donated, as the reference jits this step
    with ``donate_argnums=(0, 1)``: ``opt.update_`` writes the new values
    into their storage, so the caller's trees hold them afterwards (and
    the step returns those trees).

    Under a mesh (``parallel.ctx.mesh_context``) the params and moments
    are DTensors (``parallel.sharding.params_shardings``) and the batch is
    the whole batch on every rank (DTensors of it are gathered first):
    each microbatch is the reference's (the same rows), and each rank
    computes its share of its rows (``ctx.local_rows``), the gradients
    summed over the ranks by the weights' reduce-scatters."""
    if opt.update_ is None:
        raise ValueError("the LM train step updates in place: the "
                         "optimizer needs update_")

    def grads_of(params, batch):
        rows, axes = ctx.local_rows(batch)
        with ctx.rows_split_over(axes):
            return value_and_grad(lambda p: M.loss_fn(p, cfg, rows), params)

    def accumulate(acc, g):
        if g is not None:
            acc.add_(g)
        return acc

    def train_step(params, opt_state, step, batch):
        batch = ctx.full_batch(batch)
        if grad_accum == 1:
            (_, metrics), grads = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % grad_accum:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"grad_accum={grad_accum} microbatches")
            mb = B // grad_accum
            grads = T.tree_map(torch.zeros_like, params)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                (_, metrics), g = grads_of(params, micro)
                T.tree_map(accumulate, grads, g)
                del g
            T.tree_map(lambda a: a.div_(grad_accum), grads)
        params, opt_state = opt.update_(grads, opt_state, params, step)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg):
    """``(params, batch) -> last-position logits``; ``batch`` holds
    ``tokens`` and, per family, ``frames`` / ``patches``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        extra = {k: v for k, v in batch.items() if k in ("frames", "patches")}
        return M.prefill(params, cfg, batch["tokens"], extra)

    return prefill_step


def make_serve_step(cfg):
    """One decode step: new token against a deep KV cache/SSM state.
    ``(params, batch) -> (logits, cache)``; ``batch`` holds ``tokens``
    (B, 1), ``pos`` (B,) and ``cache``."""
    @torch.no_grad()
    def serve_step(params, batch):
        return M.decode_step(params, cfg, batch["tokens"], batch["pos"],
                             batch["cache"])

    return serve_step


def default_optimizer(cfg, total_steps=10_000):
    """AdamW with int8 pow2 moments for the huge archs (more than 5e10
    parameters)."""
    big = M.param_count(cfg) > 5e10
    return opt_lib.adamw(total_steps=total_steps, int8_state=big)
