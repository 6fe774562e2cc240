"""Decoder-only / encoder-decoder transformer LMs (dense, MoE, VLM, audio).

The port of ``repro.models.transformer``.  Layers are stored stacked, a
``(L, ...)`` leading axis on every leaf as the reference's ``jax.vmap``
init lays them out, and run by a Python loop over the layers (the
reference's ``lax.scan``), each checkpointed under autograd as the
reference remats it.
Under a mesh (``parallel.ctx``) the forward computes this rank's rows with
each layer's weights gathered at their use, inside the layer's
rematerialized body: over the batch axes only where GQA or MLA heads, the
MLP's or the experts' width or the vocabulary split over 'model'
(Megatron's tensor parallelism), whole elsewhere; the MoE's expert
segments also split over the ranks that split the rows.
The residual stream uses the paper's add-fold: the block output matmul
receives the skip stream as its accumulator initializer (``acc_init``)
instead of a separate Add node (``cfg.residual_fusion``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import ctx


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _block_init(cfg: ModelConfig, d, use_moe: bool, cross_attn: bool = False):
    def init(draw: L.Draw):
        dev = draw.device
        p = dict(ln1=L.norm_init(cfg, d, dev))
        if cfg.attn_type == "mla":
            p["attn"] = L.mla_init(draw, cfg, d, cfg.pdtype)
        else:
            p["attn"] = L.gqa_init(draw, cfg, d, cfg.pdtype)
        if cross_attn:
            p["ln_x"] = L.norm_init(cfg, d, dev)
            p["xattn"] = L.gqa_init(draw, cfg, d, cfg.pdtype)
        p["ln2"] = L.norm_init(cfg, d, dev)
        if use_moe:
            p["moe"] = L.moe_init(draw, cfg, d, cfg.pdtype)
        else:
            p["mlp"] = L.mlp_init(draw, cfg, d, cfg.d_ff, cfg.pdtype)
        return p
    return init


def init_params(cfg: ModelConfig, draw: L.Draw) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    dev = draw.device
    p = dict(
        embed=L._init(draw, (V, d), cfg.pdtype, scale=1.0),
        final_norm=L.norm_init(cfg, d, dev),
    )
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_init(draw, d, V, cfg.pdtype)
    n_moe = 0
    if cfg.family == "moe":
        n_moe = cfg.num_layers - cfg.first_dense_layers
        n_dense = cfg.first_dense_layers
    else:
        n_dense = cfg.num_layers
    if cfg.family == "audio":
        p["enc_blocks"] = L.stack_init(
            _block_init(cfg, d, use_moe=False), draw, cfg.encoder_layers)
        p["enc_norm"] = L.norm_init(cfg, d, dev)
        p["enc_pos"] = L._init(draw, (cfg.encoder_len, d), cfg.pdtype,
                               scale=0.02)
        p["dec_pos"] = L._init(draw, (32_768, d), cfg.pdtype, scale=0.02)
        # decoder blocks get cross-attention
        p["blocks"] = L.stack_init(
            _block_init(cfg, d, use_moe=False, cross_attn=True), draw,
            cfg.num_layers)
    elif n_dense:
        p["blocks"] = L.stack_init(_block_init(cfg, d, use_moe=False), draw,
                                   n_dense)
    if n_moe:
        p["moe_blocks"] = L.stack_init(_block_init(cfg, d, use_moe=True),
                                       draw, n_moe)
    if cfg.family == "vlm":
        p["patch_proj"] = L.dense_init(draw, d, d, cfg.pdtype)
    if cfg.mtp_depth:
        p["mtp"] = L.stack_init(_block_init(cfg, d, use_moe=False), draw,
                                cfg.mtp_depth)
        p["mtp_norm"] = L.norm_init(cfg, d, dev)
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


# the sub-trees whose layer function gathers its own weights (GQA, MLA, the
# MLP and the MoE split or gather them at their use)
_GATHERS_OWN = ("attn", "xattn", "mlp", "moe")


def _apply_block(p, h, cfg, *, use_moe, causal=True, cache=None, pos=None,
                 enc_out=None, xattn_cache=None, cache_out=None):
    """One pre-norm block with add-fold residuals.  ``cache_out``: the
    buffers a decode writes the layer's new cache into.  Returns (h,
    new_cache)."""
    # the norms' weights gathered at their use
    p = {k: v if k in _GATHERS_OWN else ctx.gather_tree(v)
         for k, v in p.items()}
    fuse = cfg.residual_fusion
    skip = h
    if cfg.attn_type == "mla":
        a, new_kv = L.mla_apply(p["attn"], L.norm(h, p["ln1"], cfg), cfg,
                                cache=cache, pos=pos,
                                acc_init=skip if fuse else None,
                                cache_out=cache_out)
    else:
        a, new_kv = L.gqa_apply(p["attn"], L.norm(h, p["ln1"], cfg), cfg,
                                causal=causal, cache=cache, pos=pos,
                                acc_init=skip if fuse else None,
                                cache_out=cache_out)
    h = a if fuse else h + a
    if enc_out is not None or xattn_cache is not None:
        skip = h
        x, _ = L.gqa_apply(p["xattn"], L.norm(h, p["ln_x"], cfg), cfg,
                           xattn_kv=xattn_cache, enc_out=enc_out,
                           acc_init=skip if fuse else None)
        h = x if fuse else h + x
    skip = h
    hn = L.norm(h, p["ln2"], cfg)
    if use_moe:
        m = L.moe_apply(p["moe"], hn, cfg, acc_init=skip if fuse else None)
    else:
        m = L.mlp_apply(p["mlp"], hn, cfg, acc_init=skip if fuse else None)
    h = m if fuse else h + m
    return h, new_kv


def _scan_blocks(stack, h, cfg, *, use_moe, causal=True, cache=None, pos=None,
                 enc_out=None, xattn_cache=None, cache_out=None):
    """Run a stacked block over the layer axis, rematerialized per layer
    under autograd (``cfg.remat``, ``cfg.remat_policy``).  ``cache`` /
    ``xattn_cache`` are stacked along the same axis; a decode (``cache``)
    writes layer ``i``'s new cache into ``cache_out[k][i]`` (stacked
    buffers of ``cache``'s shapes: the reference's scan outputs).
    Returns h."""
    def body(h, p, kv, xkv, kv_out):
        # pin the residual stream: batch over (pod,data), d replicated
        h = ctx.constrain(h, ctx.batch_axes(),
                          "model" if cfg.seq_shard else None, None)
        return _apply_block(p, h, cfg, use_moe=use_moe, causal=causal,
                            cache=kv, pos=pos, enc_out=enc_out,
                            xattn_cache=xkv, cache_out=kv_out)

    body = L.remat(body, cfg.remat, cfg.remat_policy)
    for i, p in enumerate(L.layers(stack)):
        kv = kv_out = None
        if cache is not None:
            kv = {k: v[i] for k, v in cache.items()}
            kv_out = {k: v[i] for k, v in cache_out.items()}
        xkv = (None if xattn_cache is None
               else {k: v[i] for k, v in xattn_cache.items()})
        h, _ = body(h, p, kv, xkv, kv_out)
    return h


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens):
    h = ctx.sharded_take(params["embed"], tokens).to(cfg.compute_dtype)
    if cfg.emb_scale:
        # sqrt(d) rounded to the compute dtype first, as the reference
        # rounds it (a host scalar: no copy to the card)
        h = h * float(torch.tensor(math.sqrt(cfg.d_model),
                                   dtype=cfg.compute_dtype))
    return h


def _encode(params, cfg, frames):
    """Whisper encoder over stub frame embeddings (conv frontend is a stub)."""
    h = frames.to(cfg.compute_dtype) + \
        ctx.gather(params["enc_pos"])[None, :frames.shape[1]]
    h = _scan_blocks(params["enc_blocks"], h, cfg, use_moe=False,
                     causal=False)
    return L.norm(h, ctx.gather_tree(params["enc_norm"]), cfg)


def encoder_cache(params, cfg: ModelConfig, frames) -> dict:
    """Whisper's cross-attention cache entries ``xk`` / ``xv`` (L, B,
    encoder_len, KV, hd) over the encoder states of ``frames``: what a
    decoder reads at every step after a prefill (the reference's decode
    reads them from the cache and has no function that fills them)."""
    enc_out = _encode(params, cfg, frames)
    kvs = [L.cross_kv(ctx.gather_tree(p["xattn"]), enc_out, cfg)
           for p in L.layers(params["blocks"])]
    return dict(xk=torch.stack([kv["k"] for kv in kvs]),
                xv=torch.stack([kv["v"] for kv in kvs]))


def hidden_states(params, cfg: ModelConfig, tokens, extra=None):
    """Token embeddings -> final hidden states (train/prefill path)."""
    extra = extra or {}
    h = _embed(params, cfg, tokens)
    enc_out = None
    if cfg.family == "audio":
        enc_out = _encode(params, cfg, extra["frames"])
        h = h + ctx.gather(params["dec_pos"])[None, :h.shape[1]].to(h.dtype)
    if cfg.family == "vlm":
        patches = L.dense(extra["patches"].to(cfg.compute_dtype),
                          ctx.gather(params["patch_proj"]), cfg=cfg)
        # stub frontend: patch embeddings replace the first P token slots so
        # the cell's (B, S) shape is preserved exactly
        h = torch.cat([patches, h[:, patches.shape[1]:]], dim=1)
    if cfg.family == "moe":
        if cfg.first_dense_layers:
            h = _scan_blocks(params["blocks"], h, cfg, use_moe=False)
        h = _scan_blocks(params["moe_blocks"], h, cfg, use_moe=True)
    else:
        h = _scan_blocks(params["blocks"], h, cfg, use_moe=False,
                         enc_out=enc_out)
    return L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)


def logits(params, cfg, h):
    """``h``'s logits (B, S, V), whole on every rank (the vocabulary split
    over 'model' where it divides the axis, ``layers.logits``)."""
    if cfg.tie_embeddings:
        return L.logits(h, params["embed"], 0, cfg.compute_dtype)
    return L.logits(h, params["unembed"], 1, cfg.compute_dtype)


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross entropy (chunked over sequence; the vocabulary
    split over 'model' where it divides the axis, ``layers.vocab_part``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    extra = {k: v for k, v in batch.items() if k in ("frames", "patches")}
    h = hidden_states(params, cfg, tokens, extra)
    emb, v0 = (L.vocab_part(params["embed"], 0) if cfg.tie_embeddings
               else L.vocab_part(params["unembed"], 1))
    emb = emb.to(cfg.compute_dtype)
    s, cnt = L.chunked_xent(h, emb, labels, cfg.loss_chunk, cfg.logit_softcap,
                            v0=v0)
    loss = s / torch.clamp_min(cnt, 1)
    if cfg.mtp_depth:
        # deepseek MTP: one extra depth predicting t+2 from the trunk states
        # (no remat on the MTP blocks, as in the reference)
        hm = h
        for p in L.layers(params["mtp"]):
            hm, _ = _apply_block(p, hm, cfg, use_moe=False)
        hm = L.norm(hm, ctx.gather_tree(params["mtp_norm"]), cfg)
        lab2 = torch.cat([labels[:, 1:], -torch.ones_like(labels[:, :1])],
                         dim=1)
        s2, c2 = L.chunked_xent(hm, emb, lab2, cfg.loss_chunk,
                                cfg.logit_softcap, v0=v0)
        loss = loss + 0.3 * s2 / torch.clamp_min(c2, 1)
    return loss, dict(loss=loss, tokens=cnt)


def prefill(params, cfg: ModelConfig, tokens, extra=None):
    """Prefill forward: last-position logits (B, 1, V)."""
    h = hidden_states(params, cfg, tokens, extra)
    return logits(params, cfg, h[:, -1:])


# ---------------------------------------------------------------------------
# decode (one token against a KV cache)
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, tokens, pos, cache, *,
                donate=False):
    """tokens (B,1), pos (B,), cache per configs.base.cache_specs.
    Returns (logits (B,1,V), new_cache).  Each layer writes its new cache
    once, into one stacked buffer a cache entry allocated here, or, with
    ``donate`` (a caller that never reads the old cache again, as the
    reference's donated buffer), into ``cache``'s own tensors."""
    h = _embed(params, cfg, tokens)
    if cfg.family == "audio":
        h = h + ctx.gather(params["dec_pos"])[pos.to(torch.long)][:, None].to(
            h.dtype)
    keys = [k for k in ("k", "v", "ckv", "krope") if k in cache]
    new_cache = dict(cache)
    for k in keys:
        new_cache[k] = cache[k] if donate else torch.empty_like(cache[k])

    if cfg.family == "moe":
        nd, nl = cfg.first_dense_layers, cfg.num_layers
        if nd:
            h = _scan_blocks(params["blocks"], h, cfg, use_moe=False,
                             cache={k: cache[k][:nd] for k in keys},
                             pos=pos,
                             cache_out={k: new_cache[k][:nd] for k in keys})
        h = _scan_blocks(params["moe_blocks"], h, cfg, use_moe=True,
                         cache={k: cache[k][nd:nl] for k in keys}, pos=pos,
                         cache_out={k: new_cache[k][nd:nl] for k in keys})
    else:
        xattn_cache = None
        if cfg.family == "audio":
            xattn_cache = dict(
                k=cache["xk"].to(cfg.compute_dtype),
                v=cache["xv"].to(cfg.compute_dtype))
        h = _scan_blocks(
            params["blocks"], h, cfg, use_moe=False,
            cache={k: cache[k] for k in keys}, pos=pos,
            xattn_cache=xattn_cache,
            cache_out={k: new_cache[k] for k in keys})
    h = L.norm(h, ctx.gather_tree(params["final_norm"]), cfg)
    return logits(params, cfg, h), new_cache
