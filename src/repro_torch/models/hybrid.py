"""Hybrid Mamba2 + shared-attention LM (zamba2-7b): the port of
``repro.models.hybrid``.

Structure: ``num_layers`` Mamba2 (SSD) blocks; after every
``shared_block_period``-th block the single *shared* transformer block
(attention + MLP, one weight set reused at every call site) is applied —
the Zamba2 design.  Layers are stored in groups of ``period`` (leaves
``(n_groups, period, ...)``), so the shared block's per-call-site KV cache
slot ``g`` goes with group ``g``; the remainder (num_layers % period)
Mamba2 layers are a tail stack.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as T
from repro_torch.models import layers as L
from repro_torch.parallel import ctx


def _mamba_blk_init(cfg, d):
    def blk(draw):
        return dict(ln=L.norm_init(cfg, d, draw.device),
                    mamba=L.mamba2_init(draw, cfg, d, cfg.pdtype))
    return blk


def init_params(cfg: ModelConfig, draw: L.Draw) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    dev = draw.device
    period = cfg.shared_block_period
    n_groups = cfg.num_layers // period
    rem = cfg.num_layers - n_groups * period
    blk = _mamba_blk_init(cfg, d)
    grouped = T.tree_map(
        lambda t: t.reshape((n_groups, period) + tuple(t.shape[1:])),
        L.stack_init(blk, draw, n_groups * period))
    p = dict(
        embed=L._init(draw, (V, d), cfg.pdtype, scale=1.0),
        groups=grouped,
        shared=dict(
            ln1=L.norm_init(cfg, d, dev),
            attn=L.gqa_init(draw, cfg, d, cfg.pdtype),
            ln2=L.norm_init(cfg, d, dev),
            mlp=L.mlp_init(draw, cfg, d, cfg.d_ff, cfg.pdtype),
        ),
        final_norm=L.norm_init(cfg, d, dev),
        unembed=L.dense_init(draw, d, V, cfg.pdtype),
    )
    if rem:
        p["tail"] = L.stack_init(blk, draw, rem)
    return p


def _mamba_block(p, h, cfg, state=None):
    p = ctx.gather_tree(p)            # the layer's weights, at their use
    skip = h
    m, ns = L.mamba2_apply(p["mamba"], L.norm(h, p["ln"], cfg), cfg,
                           state=state,
                           acc_init=skip if cfg.residual_fusion else None)
    return (m if cfg.residual_fusion else h + m), ns


def _shared_block(p, h, cfg, cache=None, pos=None):
    p = ctx.gather_tree(p)            # gathered again at every call site
    skip = h
    a, kv = L.gqa_apply(p["attn"], L.norm(h, p["ln1"], cfg), cfg,
                        cache=cache, pos=pos,
                        acc_init=skip if cfg.residual_fusion else None)
    h = a if cfg.residual_fusion else h + a
    skip = h
    m = L.mlp_apply(p["mlp"], L.norm(h, p["ln2"], cfg), cfg,
                    acc_init=skip if cfg.residual_fusion else None)
    return (m if cfg.residual_fusion else h + m), kv


def _run(params, cfg, h, *, states=None, kv=None, pos=None):
    """states (dict ssm, conv, each (L, ...)) / kv (dict k, v, each
    (n_groups, ...)): None for train/prefill; the decode state otherwise.
    Returns (h, new states, new kv).  Without a decode state, each group
    (its Mamba2 layers and the shared block) is rematerialized under
    autograd per ``cfg.remat_policy``, and each tail layer with nothing
    saved (the reference's plain ``jax.checkpoint``)."""
    period = cfg.shared_block_period
    decode = states is not None
    new_states, new_kv = [], []

    def mamba(h, p, l):
        st = None if not decode else {k: v[l] for k, v in states.items()}
        return _mamba_block(p, h, cfg, state=st)

    def group(h, layer_params, first, gkv):
        h = ctx.constrain(h, ctx.batch_axes(), None, None)
        sts = []
        for j, p in enumerate(layer_params):
            h, ns = mamba(h, p, first + j)
            sts.append(ns)
        h, nkv = _shared_block(params["shared"], h, cfg, cache=gkv, pos=pos)
        return h, sts, nkv

    tail = mamba
    if not decode:
        group = L.remat(group, cfg.remat, cfg.remat_policy)
        tail = L.remat(mamba, cfg.remat, "nothing")
    for g, gp in enumerate(L.layers(params["groups"])):
        gkv = None if not decode else {k: v[g] for k, v in kv.items()}
        h, sts, nkv = group(h, L.layers(gp), g * period, gkv)
        new_states += sts
        new_kv.append(nkv)
    if "tail" in params:
        first = len(new_states)
        for j, p in enumerate(L.layers(params["tail"])):
            h, ns = tail(h, p, first + j)
            new_states.append(ns)
    if not decode:
        return h, None, None
    stack = lambda parts: {k: torch.stack([s[k] for s in parts])  # noqa: E731
                           for k in parts[0]}
    return h, stack(new_states), stack(new_kv)


def _embed(params, cfg, tokens):
    return ctx.sharded_take(params["embed"], tokens).to(cfg.compute_dtype)


def hidden_states(params, cfg, tokens, extra=None):
    h, _, _ = _run(params, cfg, _embed(params, cfg, tokens))
    return L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)


def loss_fn(params, cfg, batch):
    h = hidden_states(params, cfg, batch["tokens"])
    emb = ctx.constrain(ctx.gather(params["unembed"]).T.to(
        cfg.compute_dtype), "model", None)
    s, cnt = L.chunked_xent(h, emb, batch["labels"], cfg.loss_chunk)
    loss = s / torch.clamp_min(cnt, 1)
    return loss, dict(loss=loss, tokens=cnt)


def prefill(params, cfg, tokens, extra=None):
    h = hidden_states(params, cfg, tokens, extra)
    return torch.matmul(h[:, -1:], ctx.gather(params["unembed"]).to(h.dtype))


def decode_step(params, cfg, tokens, pos, cache):
    h, new_states, new_kv = _run(
        params, cfg, _embed(params, cfg, tokens),
        states=dict(ssm=cache["ssm_state"], conv=cache["conv_state"]),
        kv=dict(k=cache["k"], v=cache["v"]), pos=pos)
    h = L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)
    logits = torch.matmul(h, ctx.gather(params["unembed"]).to(h.dtype))
    return logits, dict(ssm_state=new_states["ssm"],
                        conv_state=new_states["conv"],
                        k=new_kv["k"], v=new_kv["v"])
