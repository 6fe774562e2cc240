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
    # the norm's weights at their use (the mixer splits or gathers its own)
    p = dict(ln=ctx.gather_tree(p["ln"]), mamba=p["mamba"])
    skip = h
    m, ns = L.mamba2_apply(p["mamba"], L.norm(h, p["ln"], cfg), cfg,
                           state=state,
                           acc_init=skip if cfg.residual_fusion else None)
    return (m if cfg.residual_fusion else h + m), ns


def _shared_block(p, h, cfg, cache=None, pos=None, cache_out=None):
    # gathered again at every call site (attention and MLP gather or split
    # their own weights)
    p = {k: v if k in ("attn", "mlp") else ctx.gather_tree(v)
         for k, v in p.items()}
    skip = h
    a, kv = L.gqa_apply(p["attn"], L.norm(h, p["ln1"], cfg), cfg,
                        cache=cache, pos=pos,
                        acc_init=skip if cfg.residual_fusion else None,
                        cache_out=cache_out)
    h = a if cfg.residual_fusion else h + a
    skip = h
    m = L.mlp_apply(p["mlp"], L.norm(h, p["ln2"], cfg), cfg,
                    acc_init=skip if cfg.residual_fusion else None)
    return (m if cfg.residual_fusion else h + m), kv


def _run(params, cfg, h, *, states=None, kv=None, pos=None, out=None):
    """states (dict ssm, conv, each (L, ...)) / kv (dict k, v, each
    (n_groups, ...)): None for train/prefill; the decode state otherwise,
    whose new values each layer writes once into ``out`` (stacked buffers
    of the same keys and shapes).  Returns h.  Without a decode state,
    each group (its Mamba2 layers and the shared block) is
    rematerialized under autograd per ``cfg.remat_policy``, and each tail
    layer with nothing saved (the reference's plain ``jax.checkpoint``)."""
    period = cfg.shared_block_period
    decode = states is not None

    def mamba(h, p, l):
        st = None if not decode else {k: v[l] for k, v in states.items()}
        h, ns = _mamba_block(p, h, cfg, state=st)
        if decode:
            for k, v in ns.items():
                out[k][l].copy_(v)
        return h

    def group(h, layer_params, first, g):
        h = ctx.constrain(h, ctx.batch_axes(), None, None)
        for j, p in enumerate(layer_params):
            h = mamba(h, p, first + j)
        gkv = kv_out = None
        if decode:
            gkv = {k: v[g] for k, v in kv.items()}
            kv_out = {k: out[k][g] for k in kv}
        h, _ = _shared_block(params["shared"], h, cfg, cache=gkv, pos=pos,
                             cache_out=kv_out)
        return h

    tail = mamba
    if not decode:
        group = L.remat(group, cfg.remat, cfg.remat_policy)
        tail = L.remat(mamba, cfg.remat, "nothing")
    n = 0
    for g, gp in enumerate(L.layers(params["groups"])):
        layer_params = L.layers(gp)
        h = group(h, layer_params, n, g)
        n += len(layer_params)
    if "tail" in params:
        for j, p in enumerate(L.layers(params["tail"])):
            h = tail(h, p, n + j)
    return h


def _embed(params, cfg, tokens):
    return ctx.sharded_take(params["embed"], tokens).to(cfg.compute_dtype)


def hidden_states(params, cfg, tokens, extra=None):
    h = _run(params, cfg, _embed(params, cfg, tokens))
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
    """One token a row; each layer writes its new states and the shared
    block's new K/V once, into stacked buffers allocated here or, with
    ``donate``, into ``cache``'s own tensors (see
    ``transformer.decode_step``)."""
    new = {k: v if donate else torch.empty_like(v) for k, v in cache.items()}
    h = _run(params, cfg, _embed(params, cfg, tokens),
             states=dict(ssm=cache["ssm_state"], conv=cache["conv_state"]),
             kv=dict(k=cache["k"], v=cache["v"]), pos=pos,
             out=dict(ssm=new["ssm_state"], conv=new["conv_state"],
                      k=new["k"], v=new["v"]))
    h = L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)
    return L.logits(h, params["unembed"], 1, h.dtype), new
