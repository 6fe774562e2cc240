"""Step builders of the float LMs: the serving half of
``repro.launch.steps`` (``make_prefill_step``, ``make_serve_step``).  The
train step waits for LM training (ROADMAP A9.2).  Both steps run without
autograd."""
from __future__ import annotations

import torch

from repro_torch.models import model as M


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
