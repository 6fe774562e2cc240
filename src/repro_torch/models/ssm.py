"""Attention-free Mamba1 LM (falcon-mamba-7b): the port of
``repro.models.ssm``.  Blocks are stacked ``(L, ...)`` and run by a loop
over the layers, each checkpointed under autograd as the reference
remats it."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import ctx


def init_params(cfg: ModelConfig, draw: L.Draw) -> dict:
    d, V = cfg.d_model, cfg.vocab_size

    def blk(dr):
        return dict(ln=L.norm_init(cfg, d, dr.device),
                    mamba=L.mamba_init(dr, cfg, d, cfg.pdtype))

    return dict(
        embed=L._init(draw, (V, d), cfg.pdtype, scale=1.0),
        blocks=L.stack_init(blk, draw, cfg.num_layers),
        final_norm=L.norm_init(cfg, d, draw.device),
        unembed=L.dense_init(draw, d, V, cfg.pdtype),
    )


def _block(p, h, cfg, state=None):
    # the norm's weights at their use (the mixer splits or gathers its own)
    p = dict(ln=ctx.gather_tree(p["ln"]), mamba=p["mamba"])
    skip = h
    m, new_state = L.mamba_apply(
        p["mamba"], L.norm(h, p["ln"], cfg), cfg, state=state,
        acc_init=skip if cfg.residual_fusion else None)
    h = m if cfg.residual_fusion else h + m
    return h, new_state


def _embed(params, cfg, tokens):
    return ctx.sharded_take(params["embed"], tokens).to(cfg.compute_dtype)


def hidden_states(params, cfg, tokens, extra=None):
    """Remat per layer under autograd, as the reference's scan body."""
    def body(h, p):
        h = ctx.constrain(h, ctx.batch_axes(), None, None)
        return _block(p, h, cfg)[0]

    body = L.remat(body, cfg.remat, cfg.remat_policy)
    h = _embed(params, cfg, tokens)
    for p in L.layers(params["blocks"]):
        h = body(h, p)
    return L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)


def loss_fn(params, cfg, batch):
    h = hidden_states(params, cfg, batch["tokens"])
    emb, v0 = L.vocab_part(params["unembed"], 1)
    s, cnt = L.chunked_xent(h, emb.to(cfg.compute_dtype), batch["labels"],
                            cfg.loss_chunk, v0=v0)
    loss = s / torch.clamp_min(cnt, 1)
    return loss, dict(loss=loss, tokens=cnt)


def prefill(params, cfg, tokens, extra=None):
    h = hidden_states(params, cfg, tokens, extra)
    return L.logits(h[:, -1:], params["unembed"], 1, h.dtype)


def decode_step(params, cfg, tokens, pos, cache, *, donate=False):
    """One token a row against the Mamba1 states; each layer writes its new
    states once, into stacked buffers allocated here or, with ``donate``,
    into ``cache``'s own tensors (see ``transformer.decode_step``)."""
    h = _embed(params, cfg, tokens)
    new = {k: cache[k] if donate else torch.empty_like(cache[k])
           for k in ("ssm_state", "conv_state")}
    for i, p in enumerate(L.layers(params["blocks"])):
        h, ns = _block(p, h, cfg, state=dict(ssm=cache["ssm_state"][i],
                                             conv=cache["conv_state"][i]))
        new["ssm_state"][i].copy_(ns["ssm"])
        new["conv_state"][i].copy_(ns["conv"])
    h = L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)
    return L.logits(h, params["unembed"], 1, h.dtype), new
