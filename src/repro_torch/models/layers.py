"""Model building blocks of the float LMs (plain functions on tensors).

The port of ``repro.models.layers``: every function under the same name,
computing the same thing in the same dtypes (each cast of the reference
is kept where it is, so a bf16 forward rounds where the reference's
does).  The reference computes all of this in plain ``jnp`` outside any
Pallas kernel, and so does the port: its products are ``torch.matmul``
and ``torch.einsum``; the port's hand-written kernels serve only the int8
LM compile path.

* ``dense()`` is the single matmul entry point: it applies the pow2-INT8
  QAT fake-quantization (``_fq8``) when ``cfg.quant == "qat"``, reads
  int8w weights (``core.quant.BlockQuantized``) through ``getw``, and takes
  an ``acc_init`` operand, the paper's add-fold: the residual stream
  enters the next matmul's accumulator instead of a standalone Add.
* attention and the loss are chunked, so long sequences run with bounded
  activation memory.
* stacked ``(L, ...)`` weights are read a layer at a time through
  ``layers()`` (one unbind a leaf), and a layer's forward is checkpointed
  under autograd by ``remat()`` where the reference remats.

Random initializers draw from a ``Draw``: a ``torch.Generator`` and the
device it draws on (``meta`` draws nothing, for shapes only).  The draws
differ from the JAX package's ``jax.random`` ones; the recipe (normal
times ``1/sqrt(fan_in)``, cast to the parameter dtype) is the same.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import per_rank_cache
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.parallel import ctx

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


class Draw:
    """Seeded draws on one device: ``gen`` a ``torch.Generator`` on
    ``device`` (``None`` on ``meta``, which allocates nothing)."""

    def __init__(self, gen: Optional[torch.Generator], device):
        self.gen, self.device = gen, torch.device(device)

    def normal(self, shape, dtype, scale) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return x.mul_(scale).to(dtype)


def _init(draw: Draw, shape, dtype, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return draw.normal(tuple(shape), dtype, float(s))


def dense_init(draw: Draw, d_in, d_out, dtype, scale=None):
    return _init(draw, (d_in, d_out), dtype, scale)


def stack_init(fn, draw: Draw, n: int) -> dict:
    """``n`` draws of ``fn(draw)`` stacked along a new leading axis (the
    reference's ``jax.vmap`` over split keys).  The stack is allocated
    once and filled a layer at a time, so the peak is the stack plus one
    layer."""
    first = fn(draw)
    if n == 1:
        return T.tree_map(lambda t: t.unsqueeze(0), first)
    out = T.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    T.tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        T.tree_map(lambda o, t: o[i].copy_(t), out, fn(draw))
    return out


# ---------------------------------------------------------------------------
# pow2 fake quant (dynamic per-tensor exponent, STE) — paper eq. 1-3 in QAT
# ---------------------------------------------------------------------------


def _fq8(x, parts=False):
    """Power-of-two-scale int8 fake quantization with dynamic range.
    ``parts``: ``x`` is this rank's part over 'model' (a split weight or a
    row-parallel input), whose range is that of the whole over 'model'."""
    # the whole batch's range under a mesh (each rank holds its rows)
    amax = ctx.batch_max(x.detach().abs().max())
    if parts:
        amax = ctx.model_max(amax)
    amax = torch.clamp_min(amax, 1e-8)
    e = torch.ceil(torch.log2(amax / 127.0))
    scale = torch.exp2(e).to(x.dtype)
    spec_like = x / scale
    q = Q.ste_round_clip(spec_like.to(torch.float32), -128.0, 127.0)
    return q.to(x.dtype) * scale


def getw(w, dtype=None):
    """Materialize a weight: int8w-quantized weights (pow2-block int8,
    ``core.quant.BlockQuantized``) are dequantized here, at their use."""
    if isinstance(w, Q.BlockQuantized):
        w = Q.block_dequantize(w)
    if dtype is not None:
        w = w.to(dtype)
    return w


def slice_expert(w, e):
    """Per-expert slice that preserves int8w storage until use."""
    if isinstance(w, Q.BlockQuantized):
        return Q.BlockQuantized(w.q[e], w.exp[e])
    return w[e]


def dense(x, w, b=None, *, cfg=None, acc_init=None, parts=False):
    """x @ w (+ b) (+ acc_init).

    ``acc_init`` is the paper's add-fold (Fig. 13): the skip stream enters as
    the accumulator initializer of this matmul.  ``parts``: ``x`` and ``w``
    are this rank's parts of a matmul split over 'model', whose
    fake-quantization ranges are those of the whole tensors."""
    w = getw(w, x.dtype)
    if cfg is not None and cfg.quant == "qat":
        x = _fq8(x, parts)
        w = _fq8(w, parts)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    if acc_init is not None:
        y = y + acc_init
    return y


def row_parallel(x, w, *, cfg, acc_init=None, split=False, keep=True):
    """``dense(x, w, acc_init=acc_init)``; ``split``: ``x`` and ``w`` are
    this rank's rows of a matmul split over 'model' (its input columns and
    the weight's rows), whose partial products are summed over 'model'
    before the add-fold's ``acc_init`` is added, once.  ``keep=False``: a
    rank that computed another rank's rows again enters zeros (and so
    passes back a zero gradient)."""
    if not split:
        return dense(x, w, cfg=cfg, acc_init=acc_init)
    y = dense(x, w, cfg=cfg, parts=True)
    if not keep:
        y = torch.where(torch.zeros((), dtype=torch.bool, device=y.device),
                        y, 0.0)
    y = ctx.model_sum(y)
    return y if acc_init is None else y + acc_init


# ---------------------------------------------------------------------------
# norms / activations / rope
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def norm(x, params, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def norm_init(cfg, d, device):
    if cfg.norm_type == "layernorm":
        return dict(scale=torch.ones((d,), dtype=torch.float32, device=device),
                    bias=torch.zeros((d,), dtype=torch.float32, device=device))
    return dict(scale=torch.zeros((d,), dtype=torch.float32, device=device))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * sigmoid(x)``, rounded once to ``x``'s dtype
    as XLA's fused form rounds it (in bf16, ``x * torch.sigmoid(x)``
    would round the sigmoid first)."""
    return F.silu(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (torch's
    ``F.softplus`` returns ``x`` itself above 20: within float32 tolerance
    of this, but not the reference's formula)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def act_fn(kind):
    if kind == "relu2":
        return lambda x: torch.square(F.relu(x))
    if kind == "silu":
        return silu
    if kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation; torch's default
        # is the exact erf form
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def rope(x, pos, theta):
    """x: (..., S, H, hd); pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python scalar base: no host-to-device copy (which would wait for
    # the card) on every call
    freqs = 1.0 / torch.pow(float(theta), exps)
    ang = pos.to(torch.float32)[..., None, None] * freqs  # (..., S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA/MQA, optional sliding window, chunked over queries)
# ---------------------------------------------------------------------------


def _attn_scores_mask(qpos, kpos, causal, window):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _grouped_attn(q, k, v, mask, softcap=0.0):
    """Softmax attention in float32.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd); query
    head ``h`` reads KV head ``h // G`` (the reshape of the reference);
    ``mask`` broadcasts against the (B,KV,G,Sq,Sk) scores."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.to(torch.float32) * (1.0 / np.sqrt(hd))
    qg = qf.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _attn_block(q, k, v, qpos, kpos, causal, window, softcap=0.0):
    """q (B,Sq,H,hd) k/v (B,Sk,KV,hd) -> (B,Sq,H,hd).  GQA by reshape."""
    mask = _attn_scores_mask(qpos, kpos, causal, window)
    return _grouped_attn(q, k, v, mask[None, None, None], softcap)


def attention(q, k, v, *, causal=True, window=0, q_offset=None, chunk=0,
              softcap=0.0):
    """Chunked (over queries) masked attention: memory is O(chunk * Sk) per
    step instead of O(Sq * Sk).  Masked positions are still computed."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qpos0 = torch.arange(Sq, device=q.device)
    if q_offset is not None:
        qpos0 = q_offset + qpos0
    kpos = torch.arange(Sk, device=q.device)
    if chunk <= 0 or Sq <= chunk or Sq % chunk != 0:
        # unchunked fallback (also for non-divisible lengths, e.g. whisper's
        # 1500-frame encoder)
        return _attn_block(q, k, v, qpos0, kpos, causal, window, softcap)
    outs = [_attn_block(q[:, i:i + chunk], k, v, qpos0[i:i + chunk], kpos,
                        causal, window, softcap)
            for i in range(0, Sq, chunk)]
    return torch.cat(outs, dim=1)


def gqa_init(draw: Draw, cfg, d, dtype):
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return dict(
        wq=dense_init(draw, d, H * hd, dtype),
        wk=dense_init(draw, d, KV * hd, dtype),
        wv=dense_init(draw, d, KV * hd, dtype),
        wo=dense_init(draw, H * hd, d, dtype),
    )


def update_at(c, u, start, out=None):
    """Per batch row ``b``: ``c[b, start[b]:start[b] + S] = u[b]`` written
    into ``out`` (``jax.lax.dynamic_update_slice_in_dim`` along axis 1
    under ``vmap``).  As there, the start is clamped so that the whole
    update lands in range: a write at ``start >= S_c - S`` goes to the last
    slots.  ``out`` is where the new cache goes: ``None`` makes a copy of
    ``c`` (the functional form); a buffer of ``c``'s shape (a layer's slice
    of the decode step's stacked new cache) is filled from ``c`` first,
    unless it is ``c``'s own memory (a donated cache), which is written in
    place."""
    B, S_c = c.shape[:2]
    S = u.shape[1]
    start = torch.clamp(start.to(torch.long), 0, S_c - S)
    rows = start[:, None] + torch.arange(S, device=c.device)
    if out is None:
        out = c.clone()
    elif not out.is_set_to(c):
        out.copy_(c)
    out[torch.arange(B, device=c.device)[:, None], rows] = u
    return out


def positions(pos, S, device):
    """Absolute positions (B, S) of ``S`` new tokens at ``pos`` (B,), or
    (1, S) from 0 without a ``pos``."""
    ar = torch.arange(S, device=device)
    return ar[None, :] if pos is None else pos[:, None] + ar[None, :]


def gqa_split(p, cfg):
    """How GQA splits its heads over 'model': ``(w, H, KV, keep, kv0,
    src)``, the weights of this rank's query heads and of the K/V heads
    they read, their counts, whether this rank's partial product enters
    the reduce after ``wo``, the first of its K/V heads, and where each
    K/V head lies in the ranks' K/V heads gathered over 'model'
    (``ctx.model_gather``); ``None`` where the block repeats whole on
    every 'model' rank.

    The heads split ``s = gcd(num_heads, tp)`` ways (Megatron's split when
    ``s == tp``): the ranks of group ``j = rank // (tp / s)`` compute query
    heads ``[j H/s, (j+1) H/s)``, and each group's first rank alone adds
    them into the reduce (the others' products are zeroed, so their
    gradients are too).  The K/V heads go with them where their count
    divides ``s``, or, where a rank's query heads all read one K/V head,
    that head.  With ``s == tp`` the weights arrive column-parallel
    (``wq`` / ``wk`` / ``wv``) and row-parallel (``wo``) by
    ``ctx.model_part``; otherwise each is gathered whole
    (``ctx.gather_for_parts``) and the group's slice taken."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = ctx.model_size()
    s = math.gcd(H, tp)
    if s == 1 or not ctx.on_model(p["wq"]):
        return None
    Hl, G = H // s, H // KV
    if KV % s and G % Hl:
        return None
    copies = tp // s

    def first_kv(j):
        return j * KV // s if KV % s == 0 else j * Hl // G
    nkv = KV // s if KV % s == 0 else 1
    j = ctx.model_rank() // copies
    kv0 = first_kv(j)
    src = {}
    for rank in range(tp):
        for t in range(nkv):
            src.setdefault(first_kv(rank // copies) + t, rank * nkv + t)
    q_cols, kv_cols = (slice(j * Hl * hd, (j + 1) * Hl * hd),
                       slice(kv0 * hd, (kv0 + nkv) * hd))
    if copies == 1:
        w = dict(wq=ctx.model_part(p["wq"], 1), wo=ctx.model_part(p["wo"], 0))
    else:
        w = dict(wq=ctx.gather_for_parts(p["wq"])[:, q_cols],
                 wo=ctx.gather_for_parts(p["wo"])[q_cols])
    for k in ("wk", "wv"):
        w[k] = (ctx.model_part(p[k], 1) if copies == 1 and KV % s == 0
                else ctx.gather_for_parts(p[k])[:, kv_cols])
    return (w, Hl, nkv, ctx.model_rank() % copies == 0, kv0,
            [src[i] for i in range(KV)])


def _own_heads(t, kv0, n, whole):
    """``t``'s K/V heads (dim 2) ``[kv0, kv0 + n)``: a cache entry that
    holds every head (``whole``), sliced; one that holds this rank's as it
    is."""
    return t[:, :, kv0:kv0 + n] if whole else t


def cross_kv(w, enc_out, cfg, KV=None, parts=False):
    """Cross-attention K/V over the encoder states ``enc_out`` from the
    weights ``w`` (``wk`` / ``wv`` of ``KV`` heads, all of them by default;
    ``parts``: this rank's heads, see ``dense``)."""
    B, hd = enc_out.shape[0], cfg.head_dim
    KV = cfg.num_kv_heads if KV is None else KV
    return dict(
        k=dense(enc_out, w["wk"], cfg=cfg, parts=parts).reshape(B, -1, KV, hd),
        v=dense(enc_out, w["wv"], cfg=cfg, parts=parts).reshape(B, -1, KV, hd))


def gqa_apply(p, x, cfg, *, causal=True, cache=None, pos=None, xattn_kv=None,
              enc_out=None, acc_init=None, cache_out=None):
    """GQA attention over x.  If ``cache=(k,v)`` is given (decode), append at
    ``pos`` (into ``cache_out``'s buffers where given, see ``update_at``)
    and attend over the cache.  ``xattn_kv`` replaces self K/V with encoder
    states' K/V (whisper cross-attention from its cache), ``enc_out`` with
    K/V computed here from the encoder states.  The heads split over
    'model' where they share a factor with it (``gqa_split``): this rank's
    heads, then ``wo`` row-parallel.  A decode cache that holds every K/V
    head (the same on every 'model' rank) gets the new token's K/V of
    every rank (gathered over 'model') and is attended at this rank's
    heads; one that holds this rank's heads (``configs.base.per_rank_cache``
    names it) gets its own.  Returns (out, new_cache)."""
    B, S, d = x.shape
    hd = cfg.head_dim
    split = gqa_split(p, cfg)
    ctx.note("attention", cfg.num_heads // split[1] if split else 1)
    keep = True
    if split is None:
        w, H, KV = ctx.gather_tree(p), cfg.num_heads, cfg.num_kv_heads
    else:
        (w, H, KV, keep, kv0, src), x = split, ctx.to_model(x)
        enc_out = None if enc_out is None else ctx.to_model(enc_out)
    parts = split is not None
    own = per_rank_cache(cfg, ctx.model_size())
    q = dense(x, w["wq"], cfg=cfg, parts=parts).reshape(B, S, H, hd)
    if enc_out is not None:
        xattn_kv = cross_kv(w, enc_out, cfg, KV, parts=parts)
    if xattn_kv is not None:
        kx = xattn_kv["k"]
        vx = xattn_kv["v"]
        if parts:
            whole = "xk" not in own
            kx, vx = (_own_heads(kx, kv0, KV, whole),
                      _own_heads(vx, kv0, KV, whole))
        o = attention(q, kx.to(q.dtype), vx.to(q.dtype), causal=False,
                      chunk=cfg.attn_chunk)
        return row_parallel(o.reshape(B, S, H * hd), w["wo"], cfg=cfg,
                            acc_init=acc_init, split=parts, keep=keep), None
    k = dense(x, w["wk"], cfg=cfg, parts=parts).reshape(B, S, KV, hd)
    v = dense(x, w["wv"], cfg=cfg, parts=parts).reshape(B, S, KV, hd)
    if cfg.use_rope:
        qpos = positions(pos, S, x.device)
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
    new_cache = None
    window = cfg.sliding_window
    if cache is not None:
        out = cache_out or {}
        ck, cv = cache["k"], cache["v"]
        S_kv = ck.shape[1]
        if window and window < S_kv:
            S_kv = window
        # ring-buffer update for SWA; linear append otherwise
        slot = (pos % S_kv) if window else pos
        kn, vn = _maybe_quant_kv(k, cfg), _maybe_quant_kv(v, cfg)
        whole = "k" not in own
        if parts and whole:
            # every rank's new K/V heads, so that the cache stays whole
            kn, vn = ctx.model_gather(kn, 2), ctx.model_gather(vn, 2)
            if src != list(range(kn.shape[2])):
                idx = torch.tensor(src, device=x.device)
                kn, vn = kn.index_select(2, idx), vn.index_select(2, idx)
        ck = update_at(ck, kn, slot, out.get("k"))
        cv = update_at(cv, vn, slot, out.get("v"))
        new_cache = dict(k=ck, v=cv)
        if parts:
            ck, cv = (_own_heads(ck, kv0, KV, whole),
                      _own_heads(cv, kv0, KV, whole))
        ar = torch.arange(S_kv, device=x.device)[None]
        # positions of cache slots (ring for SWA)
        if window:
            kpos = (pos[:, None] // S_kv) * S_kv + ar
            kpos = torch.where(ar <= (pos % S_kv)[:, None], kpos, kpos - S_kv)
            valid = kpos >= 0
        else:
            valid = ar.expand(B, S_kv) <= pos[:, None]
        o = _decode_attn(q, ck, cv, valid, cfg)
    else:
        o = attention(q, k, v, causal=causal, window=window,
                      chunk=cfg.attn_chunk, softcap=cfg.logit_softcap)
    out = row_parallel(o.reshape(B, S, H * hd), w["wo"], cfg=cfg,
                       acc_init=acc_init, split=parts, keep=keep)
    return out, new_cache


# the float32 K/V bytes a decode step upcasts at once: a longer cache is
# attended a few batch rows at a time, so a step never holds a whole
# layer's float32 copy beside its new cache
DECODE_UPCAST_BYTES = 1 << 28


def _decode_attn(q, k, v, valid, cfg):
    """Single-query attention against a (possibly ring) cache with per-batch
    validity mask (B, Skv).  q: (B,1,H,hd), k/v: (B,Skv,KV,hd) as the cache
    stores them, dequantized and upcast ``DECODE_UPCAST_BYTES`` at a time
    (whole batch rows; each row's arithmetic is the same either way)."""
    rows = max(1, DECODE_UPCAST_BYTES // (8 * k[0].numel()))
    outs = [_grouped_attn(q[i:i + rows],
                          _maybe_dequant_kv(k[i:i + rows], cfg).to(q.dtype),
                          _maybe_dequant_kv(v[i:i + rows], cfg).to(q.dtype),
                          valid[i:i + rows, None, None, None, :],
                          cfg.logit_softcap)
            for i in range(0, q.shape[0], rows)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


KV_SPEC = Q.QSpec(8, True, -3)


def _maybe_quant_kv(x, cfg):
    if cfg.kv_cache_dtype != "int8":
        return x.to(cfg.compute_dtype)
    # paper pow2-int8 on the KV cache: static exponent -3 covers post-norm
    # attention K/V ranges; exactness is not required for the cache.
    return Q.quantize(x.to(torch.float32), KV_SPEC)


def _maybe_dequant_kv(x, cfg):
    if cfg.kv_cache_dtype != "int8":
        return x
    return Q.dequantize(x, KV_SPEC)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3) — low-rank Q/KV with compressed-latent cache
# ---------------------------------------------------------------------------


def mla_init(draw: Draw, cfg, d, dtype):
    H = cfg.num_heads
    dev = draw.device
    return dict(
        wq_a=dense_init(draw, d, cfg.q_lora_rank, dtype),
        q_norm=norm_init(cfg, cfg.q_lora_rank, dev),
        wq_b=dense_init(draw, cfg.q_lora_rank,
                        H * (cfg.qk_nope_dim + cfg.qk_rope_dim), dtype),
        wkv_a=dense_init(draw, d, cfg.kv_lora_rank + cfg.qk_rope_dim, dtype),
        kv_norm=norm_init(cfg, cfg.kv_lora_rank, dev),
        wkv_b=dense_init(draw, cfg.kv_lora_rank,
                         H * (cfg.qk_nope_dim + cfg.v_head_dim), dtype),
        wo=dense_init(draw, H * cfg.v_head_dim, d, dtype),
    )


def mla_apply(p, x, cfg, *, cache=None, pos=None, acc_init=None,
              cache_out=None):
    """MLA (deepseek-v3) over x; decode writes the latent cache into
    ``cache_out``'s buffers where given (``update_at``).  Where the heads
    divide the 'model' axis (``ctx.splits``) each rank computes its
    ``H / tp`` heads: ``wq_b`` / ``wkv_b`` (head-major) column-parallel,
    ``wo`` row-parallel; ``wq_a``, ``wkv_a`` and the norms whole on every
    rank, their outputs the input of the split (``ctx.to_model``).  Decode
    attends the whole latent cache with this rank's heads; every rank
    writes the same new latent row."""
    H = cfg.num_heads
    split = ctx.splits(p["wq_b"], H)
    ctx.note("mla", ctx.model_size() if split else 1)
    if split:
        part = ctx.to_model
        H //= ctx.model_size()
        p = dict(ctx.gather_tree({k: p[k] for k in ("wq_a", "q_norm",
                                                     "wkv_a", "kv_norm")}),
                 wq_b=ctx.model_part(p["wq_b"], 1),
                 wkv_b=ctx.model_part(p["wkv_b"], 1),
                 wo=ctx.model_part(p["wo"], 0))
    else:
        def part(t):
            return t
        p = ctx.gather_tree(p)
    B, S, d = x.shape
    dn, dr, dv, dc = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    f32 = torch.float32
    q = dense(part(norm(dense(x, p["wq_a"], cfg=cfg), p["q_norm"], cfg)),
              p["wq_b"], cfg=cfg, parts=split).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv_a = dense(x, p["wkv_a"], cfg=cfg)
    ckv, k_rope = kv_a[..., :dc], kv_a[..., dc:]
    ckv = part(norm(ckv, p["kv_norm"], cfg))
    qpos = positions(pos, S, x.device)
    q_rope = rope(q_rope, qpos, cfg.rope_theta)
    k_rope = part(rope(k_rope[:, :, None, :], qpos, cfg.rope_theta)[:, :, 0])

    wkv_b = getw(p["wkv_b"], x.dtype).reshape(dc, H, dn + dv)
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]

    if cache is None:
        # prefill/train: expand to per-head K/V (standard form)
        k_nope = torch.einsum("bsc,chn->bshn", ckv, wk_b)
        v = torch.einsum("bsc,chv->bshv", ckv, wv_b)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = attention(qq, k, v, causal=True, chunk=cfg.attn_chunk)
        out = row_parallel(o.reshape(B, S, H * dv), p["wo"], cfg=cfg,
                           acc_init=acc_init, split=split)
        return out, None
    # decode: absorbed attention over the compressed latent cache
    out = cache_out or {}
    cc = update_at(cache["ckv"], _maybe_quant_kv(ckv, cfg), pos,
                   out.get("ckv"))
    ckr = update_at(cache["krope"], _maybe_quant_kv(k_rope, cfg), pos,
                    out.get("krope"))
    S_kv = cc.shape[1]
    new_cache = dict(ckv=cc, krope=ckr)
    ccf = _maybe_dequant_kv(cc, cfg).to(f32)
    ckrf = _maybe_dequant_kv(ckr, cfg).to(f32)
    # absorb W_k into q:   score = (q_nope W_kb) . c  +  q_rope . k_rope
    q_abs = torch.einsum("bshn,chn->bshc", q_nope.to(f32), wk_b.to(f32))
    scale = 1.0 / np.sqrt(dn + dr)
    s = (torch.einsum("bshc,btc->bhst", q_abs, ccf)
         + torch.einsum("bshr,btr->bhst", q_rope.to(f32), ckrf))
    s = s * scale
    valid = torch.arange(S_kv, device=x.device)[None] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btc->bshc", pr, ccf)
    o = torch.einsum("bshc,chv->bshv", o_lat, wv_b.to(f32))
    out = row_parallel(o.reshape(B, S, H * dv).to(x.dtype), p["wo"],
                       cfg=cfg, acc_init=acc_init, split=split)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(draw: Draw, cfg, d, d_ff, dtype):
    if cfg.mlp_type in ("silu", "geglu"):
        return dict(w_gate=dense_init(draw, d, d_ff, dtype),
                    w_up=dense_init(draw, d, d_ff, dtype),
                    w_down=dense_init(draw, d_ff, d, dtype))
    return dict(w_up=dense_init(draw, d, d_ff, dtype),
                w_down=dense_init(draw, d_ff, d, dtype))


def mlp_apply(p, x, cfg, acc_init=None):
    """Dense or gated MLP.  Where its width divides the 'model' axis
    (``ctx.splits``), ``w_gate`` / ``w_up`` are column-parallel and
    ``w_down`` row-parallel, summed over 'model' before ``acc_init``."""
    a = act_fn(cfg.mlp_type)
    split = ctx.splits(p["w_up"])
    ctx.note("mlp", ctx.model_size() if split else 1)
    if split:
        x = ctx.to_model(x)
        p = {k: ctx.model_part(w, 0 if k == "w_down" else 1)
             for k, w in p.items()}
    else:
        p = ctx.gather_tree(p)
    if cfg.mlp_type in ("silu", "geglu"):
        h = a(dense(x, p["w_gate"], cfg=cfg, parts=split)) * \
            dense(x, p["w_up"], cfg=cfg, parts=split)
    else:
        h = a(dense(x, p["w_up"], cfg=cfg, parts=split))
    return row_parallel(h, p["w_down"], cfg=cfg, acc_init=acc_init,
                        split=split)


# ---------------------------------------------------------------------------
# MoE — sorted grouped matmul (dropless up to a capacity factor)
# ---------------------------------------------------------------------------


def moe_init(draw: Draw, cfg, d, dtype):
    E, ff = cfg.num_experts, cfg.moe_d_ff
    p = dict(
        router=dense_init(draw, d, E, torch.float32),
        w_gate=_init(draw, (E, d, ff), dtype),
        w_up=_init(draw, (E, d, ff), dtype),
        w_down=_init(draw, (E, ff, d), dtype),
    )
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(draw, cfg, d,
                               cfg.moe_d_ff * cfg.num_shared_experts, dtype)
    return p


def _route(p, x2d, cfg):
    """Softmax router, top-k renormalized: (gates (T,k), experts (T,k))."""
    logits = x2d.to(torch.float32) @ getw(p["router"], torch.float32)
    gates_full = torch.softmax(logits, dim=-1)
    topg, topi = torch.topk(gates_full, cfg.top_k, dim=-1)
    return topg / torch.sum(topg, dim=-1, keepdim=True), topi


def _moe_dense_ref(p, x2d, cfg):
    """Reference dense-dispatch MoE (every token through every expert,
    mask-combined).  O(E) flops — tests only."""
    T_, d = x2d.shape
    E = cfg.num_experts
    topg, topi = _route(p, x2d, cfg)
    a = act_fn(cfg.mlp_type)
    h = torch.einsum("td,edf->tef", x2d, getw(p["w_gate"], x2d.dtype))
    u = torch.einsum("td,edf->tef", x2d, getw(p["w_up"], x2d.dtype))
    y_all = torch.einsum("tef,efd->ted", a(h) * u,
                         getw(p["w_down"], x2d.dtype))  # (T,E,d)
    w = torch.zeros((T_, E), dtype=x2d.dtype, device=x2d.device)
    w = w.scatter_add(1, topi, topg.to(x2d.dtype))
    return torch.einsum("te,ted->td", w, y_all)


def moe_apply(p, x, cfg, acc_init=None):
    """Sorted grouped-matmul MoE: sort tokens by expert, run the experts in
    order, each on a static ``cap``-row slice from its start (so an
    expert's spill past its own rows is overwritten by the next experts,
    and rows past capacity are zeroed after), as the reference's scan
    does.  Routing and capacity are global: where the rows split over the
    mesh, or the experts' width over 'model', the experts' segments split
    over the ranks that split the rows and their width over 'model'
    (``_moe_split``; on a mesh of 'model' extent 1 that splits the rows,
    then, within float rounding of the unsplit block, not bitwise).  The
    dense dispatch, which has no capacity, reads only its own rows."""
    over_model = ctx.splits(p["w_up"])
    if cfg.moe_impl != "dense" and (over_model or ctx.row_share()[1] > 1):
        ctx.note("moe", ctx.model_size() if over_model else 1)
        y = _moe_split(p, x, cfg, over_model)
    else:
        ctx.note("moe", 1)
        y = _moe_rows(ctx.gather_tree(p), x, cfg)
    if acc_init is not None:
        y = y + acc_init
    return y


def _moe_split(p, x, cfg, over_model):
    """``_moe_rows`` with its work split over the mesh.  Each rank routes
    its own rows; the expert ids and gates are gathered over the ranks
    that split the rows (``n``), and the global stable sort, ``cap`` and
    ``starts`` are the reference's.  Rank ``r`` computes rows ``[r c, (r +
    1) c)`` of every expert's ``cap``-row segment (``c = ceil(cap / n)``,
    read from ``ctx.all_rows`` of the rows), through this rank's
    ``moe_d_ff / tp`` columns of ``w_gate`` / ``w_up`` and rows of
    ``w_down`` where ``over_model``.  A computed row enters only where it
    is the expert's own slot within capacity (a spill row, which the
    reference's next expert overwrites, and the padding enter zeros), so
    each kept slot is counted once; its gated output is added into its
    token's row, and the ranks' parts are summed onto each row's own
    rank by one reduce-scatter (``ctx.sum_own_rows``).  The shared experts
    run on this rank's rows through ``mlp_apply``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    r, n = ctx.row_share()
    parts = ctx.split_axes() + (("model",) if over_model else ())
    x2d = x.reshape(B * S, d)
    topg, topi = _route(ctx.gather_tree({"router": p["router"]}), x2d, cfg)
    x_all = ctx.all_rows(x2d, parts)
    g_all = ctx.all_rows(topg.to(x.dtype), parts).reshape(-1)
    flat_e = ctx.all_rows(topi).reshape(-1)
    T_ = B * S * n
    order = torch.argsort(flat_e, stable=True)
    cap = int(np.ceil(T_ * k / E * cfg.moe_capacity_factor))
    cap = max(8, min(cap, T_ * k))
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    c = -(-cap // n)
    j = r * c + torch.arange(c, device=x.device)   # slots of a segment
    pad = torch.zeros(n * c, dtype=torch.long, device=x.device)
    tok = torch.cat([order // k, pad])
    gate = torch.cat([g_all[order], g_all.new_zeros(n * c)])
    if over_model:
        w = dict(w_gate=ctx.model_part(p["w_gate"], 2),
                 w_up=ctx.model_part(p["w_up"], 2),
                 w_down=ctx.model_part(p["w_down"], 1))
    else:
        w = ctx.gather_tree({q: p[q] for q in ("w_gate", "w_up", "w_down")})
    a = act_fn(cfg.mlp_type)
    rows, outs = [], []
    for e, we in enumerate(layers(w)):
        slot = starts[e] + j
        rows.append(tok[slot])
        seg = x_all[rows[-1]]
        h = a(seg @ getw(we["w_gate"], seg.dtype)) * \
            (seg @ getw(we["w_up"], seg.dtype))
        own = (j < cap) & (j < counts[e])
        outs.append(torch.where(own[:, None], h @ getw(we["w_down"],
                                                       seg.dtype), 0.0)
                    * gate[slot][:, None])
    y = x_all.new_zeros((T_, d)).index_add(0, torch.cat(rows),
                                            torch.cat(outs))
    y = ctx.sum_own_rows(y, parts)
    if cfg.num_shared_experts:
        y = y + mlp_apply(p["shared"], x2d, cfg)
    return y.reshape(B, S, d)


def _moe_rows(p, x, cfg):
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    T_ = B * S
    E, k = cfg.num_experts, cfg.top_k
    if cfg.moe_impl == "dense":
        y = _moe_dense_ref(p, x2d, cfg)
    else:
        topg, topi = _route(p, x2d, cfg)              # (T,k)
        flat_e = topi.reshape(-1)                    # (T*k,)
        order = torch.argsort(flat_e, stable=True)
        tok = order // k
        cap = int(np.ceil(T_ * k / E * cfg.moe_capacity_factor))
        cap = max(8, min(cap, T_ * k))
        # bincount on CUDA reads its input's max back to the host; a
        # scatter-add counts without waiting for the card
        counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 0) - counts
        xs = torch.cat([x2d[tok], x2d.new_zeros((cap, d))])
        ys = x.new_zeros((T_ * k + cap, d))
        a = act_fn(cfg.mlp_type)
        span = torch.arange(cap, device=x.device)
        experts = layers({k: p[k] for k in ("w_gate", "w_up", "w_down")})
        for e, w in enumerate(experts):
            rows = starts[e] + span
            seg = xs[rows]
            h = a(seg @ getw(w["w_gate"], seg.dtype)) * \
                (seg @ getw(w["w_up"], seg.dtype))
            ys[rows] = h @ getw(w["w_down"], seg.dtype)
        ys = ys[:T_ * k]
        # tokens beyond an expert's capacity were never written by their own
        # expert; zero them (standard token dropping).
        slot_in_e = torch.arange(T_ * k, device=x.device) - starts[flat_e[order]]
        ys = ys.masked_fill((slot_in_e >= cap)[:, None], 0)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T_ * k, device=x.device)
        y_tk = ys[inv].reshape(T_, k, d)
        y = torch.einsum("tk,tkd->td", topg.to(x.dtype), y_tk)
    if cfg.num_shared_experts:
        y = y + mlp_apply(p["shared"], x2d, cfg)
    return y.reshape(B, S, d)


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba) — chunked selective scan
# ---------------------------------------------------------------------------


def mamba_init(draw: Draw, cfg, d, dtype):
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    ck = cfg.conv_kernel
    dev = draw.device
    f32 = torch.float32
    A = torch.arange(1, N + 1, dtype=f32, device=dev).expand(di, N)
    return dict(
        in_proj=dense_init(draw, d, 2 * di, dtype),
        conv_w=_init(draw, (ck, di), dtype, scale=1.0 / np.sqrt(ck)),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        x_proj=dense_init(draw, di, R + 2 * N, dtype),
        dt_proj=dense_init(draw, R, di, dtype),
        dt_bias=torch.zeros((di,), dtype=f32, device=dev),
        A_log=torch.log(A),
        D=torch.ones((di,), dtype=f32, device=dev),
        out_proj=dense_init(draw, di, d, dtype),
    )


def _causal_conv1d(x, w, b, state=None):
    """x: (B,S,di); w: (K,di) depthwise.  Returns (y, new_state) where state
    carries the trailing K-1 inputs for decode."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return y + b, new_state


def _linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` from ``h = 0`` along
    axis 1: the pairs ``(a, b)`` composed under ``(a1, b1), (a2, b2) ->
    (a1 a2, a2 b1 + b2)`` (the reference's ``associative_scan`` operator),
    in log2(n) doubling steps (Hillis-Steele).  Returns (a_cum, b_cum)."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_cur = a[:, off:]
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a_cur,
                                                 b[:, :-off])], dim=1)
        a = torch.cat([a[:, :off], a_cur * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def selective_scan_chunked(u, dt, A, Bc, Cc, D, h0=None, chunk=256):
    """Mamba1 selective scan, chunked for bounded memory.

    u, dt: (B,S,di);  A: (di,N);  Bc, Cc: (B,S,N);  h0: (B,di,N) or None.
    Returns (y: (B,S,di), h_last).  The reference pads the sequence to
    whole chunks with dt = 0 (a step that multiplies the state by exactly
    1 and adds exactly 0); the port runs the last chunk short instead,
    with the same result."""
    B, S, di = u.shape
    N = A.shape[1]
    f32 = torch.float32
    h = (torch.zeros((B, di, N), dtype=f32, device=u.device) if h0 is None
         else h0.to(f32))
    ys = []
    for c0 in range(0, S, chunk):
        dtf = dt[:, c0:c0 + chunk].to(f32)
        uc = u[:, c0:c0 + chunk].to(f32)
        a = torch.exp(dtf[..., None] * A)                   # (B,c,di,N)
        binc = (dtf * uc)[..., None] * Bc[:, c0:c0 + chunk].to(f32)[:, :, None, :]
        a_cum, b_cum = _linear_scan(a, binc)
        hs = a_cum * h[:, None] + b_cum                      # (B,c,di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs,
                               Cc[:, c0:c0 + chunk].to(f32)))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + D * u.to(f32)
    return y, h


def mamba_apply(p, x, cfg, *, state=None, acc_init=None):
    """Falcon-Mamba block.  state = dict(ssm, conv) for decode.  Where
    ``d_inner`` divides the 'model' axis (``ctx.splits``) each rank runs
    its ``d_inner / tp`` channels: its columns of both halves of
    ``in_proj`` (``[x | z]``: the weight gathered whole, then sliced),
    ``conv_*``, ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` by channel,
    ``x_proj`` row-parallel (its ``R + 2N`` outputs summed over 'model'),
    the scan on its channels, ``out_proj`` row-parallel.  A decode state
    then holds this rank's channels: ``configs.base.per_rank_cache`` (the
    reference's ``"heads"`` placement) names both states exactly where
    ``d_inner`` divides the axis."""
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    f32 = torch.float32
    split = ctx.splits(p["in_proj"], di)
    ctx.note("mamba1", ctx.model_size() if split else 1)
    if split:
        di //= ctx.model_size()
        c0 = ctx.model_rank() * di
        w_in = ctx.gather_for_parts(p["in_proj"])
        cd = cfg.d_inner
        p = dict({k: ctx.model_part(p[k], 0) for k in (
                      "conv_b", "x_proj", "dt_bias", "A_log", "D",
                      "out_proj")},
                 conv_w=ctx.model_part(p["conv_w"], 1),
                 dt_proj=ctx.model_part(p["dt_proj"], 1),
                 in_proj=torch.cat([w_in[:, c0:c0 + di],
                                    w_in[:, cd + c0:cd + c0 + di]], dim=1))
        x = ctx.to_model(x)
    else:
        p = ctx.gather_tree(p)
    xz = dense(x, p["in_proj"], cfg=cfg, parts=split)
    xin, z = xz[..., :di], xz[..., di:]
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = silu(xc)
    proj = dense(xc, p["x_proj"], cfg=cfg, parts=split)
    if split:
        # dt, B and C are read by every channel: summed over 'model', and
        # their gradients (each rank's channels' part) summed back
        proj = ctx.to_model(ctx.model_sum(proj))
    dt_in, Bc, Cc = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = softplus(dense(dt_in, p["dt_proj"], cfg=cfg, parts=split).to(f32)
                  + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if state is None:
        y, _ = selective_scan_chunked(xc, dt, A, Bc, Cc, p["D"])
        new_state = None
    else:
        h0 = state["ssm"]
        a = torch.exp(dt[:, 0, :, None] * A)                 # (B,di,N)
        binc = (dt[:, 0] * xc[:, 0].to(f32))[..., None] * \
            Bc[:, 0].to(f32)[:, None, :]
        h = a * h0 + binc
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].to(f32))
        y = (y + p["D"] * xc[:, 0].to(f32))[:, None]
        new_state = dict(ssm=h, conv=new_conv)
    y = y.to(x.dtype) * silu(z)
    out = row_parallel(y, p["out_proj"], cfg=cfg, acc_init=acc_init,
                       split=split)
    return out, new_state


# ---------------------------------------------------------------------------
# Mamba2 / SSD (zamba2) — chunked matmul form
# ---------------------------------------------------------------------------


def mamba2_init(draw: Draw, cfg, d, dtype):
    di, N, hd = cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim
    nh = di // hd
    ck = cfg.conv_kernel
    d_conv = di + 2 * N  # x, B, C all pass through the conv (mamba2 layout)
    dev = draw.device
    f32 = torch.float32
    return dict(
        in_proj=dense_init(draw, d, 2 * di + 2 * N + nh, dtype),
        conv_w=_init(draw, (ck, d_conv), dtype, scale=1.0 / np.sqrt(ck)),
        conv_b=torch.zeros((d_conv,), dtype=dtype, device=dev),
        dt_bias=torch.zeros((nh,), dtype=f32, device=dev),
        A_log=torch.zeros((nh,), dtype=f32, device=dev),
        D=torch.ones((nh,), dtype=f32, device=dev),
        norm_scale=torch.zeros((di,), dtype=f32, device=dev),
        out_proj=dense_init(draw, di, d, dtype),
    )


def ssd_chunked(xh, dt, A, Bc, Cc, h0=None, chunk=128):
    """SSD (mamba2) in chunked matmul form.

    xh: (B,S,H,P) head inputs; dt: (B,S,H) (post-softplus);
    A: (H,) negative; Bc, Cc: (B,S,N).  Returns (y, h_last (B,H,P,N))."""
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    assert S % chunk == 0 or S < chunk, (S, chunk)
    c = min(chunk, S)
    f32 = torch.float32
    h = (torch.zeros((B, H, P, N), dtype=f32, device=xh.device) if h0 is None
         else h0.to(f32))
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    ys = []
    for c0 in range(0, S, c):
        xr = xh[:, c0:c0 + c]
        dtr = dt[:, c0:c0 + c]
        Br = Bc[:, c0:c0 + c].to(f32)
        Cr = Cc[:, c0:c0 + c].to(f32)
        cum = torch.cumsum(dtr * A, dim=1)                     # (B,c,H)
        # intra-chunk: decay(i,j) = exp(cum_i - cum_j) for i >= j
        dec = torch.exp(cum[:, :, None] - cum[:, None, :, :])  # (B,c,c,H)
        dec = torch.where(mask[None, :, :, None], dec, 0.0)
        cb = torch.einsum("bin,bjn->bij", Cr, Br)
        scores = cb[..., None] * dec                           # (B,c,c,H)
        xw = dtr[..., None] * xr.to(f32)                       # dt-weighted input
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xw)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bin,bhpn->bihp", Cr, h) * \
            torch.exp(cum)[..., None]
        # state update
        tot = cum[:, -1:, :]                                   # (B,1,H)
        w = torch.exp(tot - cum)                               # (B,c,H)
        dBx = torch.einsum("bjn,bjhp->bhpn", Br, xw * w[..., None])
        h = torch.exp(tot[:, 0])[:, :, None, None] * h + dBx
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _mamba2_split(p, cfg):
    """This rank's weights of a Mamba2 block whose heads split over
    'model': of the packed ``in_proj`` (``[z | x | B | C | dt]``) its
    columns of z, x and dt and the whole B and C (read by every head); of
    ``conv_*`` (``[x | B | C]``) its x channels and the whole B and C; the
    per-head and per-channel leaves by head; ``out_proj`` row-parallel.
    Returns (weights, the first of its ``d_inner`` channels)."""
    di, N, hd = cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim
    tp, r = ctx.model_size(), ctx.model_rank()
    dl, hl = di // tp, di // hd // tp
    c0 = r * dl
    w_in = ctx.gather_for_parts(p["in_proj"])
    t0 = 2 * di + 2 * N + r * hl
    w = dict(in_proj=torch.cat([w_in[:, c0:c0 + dl],
                                w_in[:, di + c0:di + c0 + dl],
                                w_in[:, 2 * di:2 * di + 2 * N],
                                w_in[:, t0:t0 + hl]], dim=1))
    for k in ("conv_w", "conv_b"):
        cw = ctx.gather_for_parts(p[k])
        w[k] = torch.cat([cw[..., c0:c0 + dl], cw[..., di:]], dim=-1)
    w.update({k: ctx.model_part(p[k], 0) for k in (
        "dt_bias", "A_log", "D", "norm_scale", "out_proj")})
    return w, c0


def mamba2_apply(p, x, cfg, *, state=None, acc_init=None):
    """Zamba2's Mamba2 (SSD) block.  Where its heads divide the 'model'
    axis each rank runs its ``nh / tp`` heads (``_mamba2_split``); the
    gated RMSNorm's mean square is summed over 'model'.  Decode, as
    ``configs.base.per_rank_cache`` has it wherever the heads divide the
    axis: the SSM state holds this rank's heads; the conv state (``[x | B
    | C]``, whose contiguous 'model' shard is not a rank's channels) is
    whole on every rank, and its new row is the new token's inputs
    gathered whole."""
    B, S, d = x.shape
    di, N, hd = cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim
    nh = di // hd
    f32 = torch.float32
    split = ctx.splits(p["in_proj"], nh)
    ctx.note("mamba2", ctx.model_size() if split else 1)
    conv_state = None if state is None else state["conv"]
    if split:
        p, c0 = _mamba2_split(p, cfg)
        di, nh = di // ctx.model_size(), nh // ctx.model_size()
        x = ctx.to_model(x)
        if conv_state is not None:
            conv_state = torch.cat([conv_state[..., c0:c0 + di],
                                    conv_state[..., cfg.d_inner:]], dim=-1)
    else:
        p = ctx.gather_tree(p)
    zxbcdt = dense(x, p["in_proj"], cfg=cfg, parts=split)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt_in = zxbcdt[..., -nh:]
    xBC, new_conv = _causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    if split and state is not None and new_conv is not None:
        # the new conv state whole: the last inputs, this token's x
        # channels gathered from every rank
        u = zxbcdt[..., di:di + di + 2 * N]
        u = torch.cat([ctx.model_gather(u[..., :di], -1), u[..., di:]], -1)
        new_conv = torch.cat([state["conv"].to(u.dtype), u],
                             dim=1)[:, -(cfg.conv_kernel - 1):]
    xBC = silu(xBC)
    xin = xBC[..., :di].reshape(B, S, nh, hd)
    Bc = xBC[..., di:di + N]
    Cc = xBC[..., di + N:]
    dt = softplus(dt_in.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if state is None:
        y, _ = ssd_chunked(xin, dt, A, Bc, Cc)
        new_state = None
    else:
        h0 = state["ssm"]
        la = dt[:, 0] * A                                     # (B,H)
        xw = dt[:, 0, :, None] * xin[:, 0].to(f32)
        dBx = torch.einsum("bn,bhp->bhpn", Bc[:, 0].to(f32), xw)
        h = torch.exp(la)[:, :, None, None] * h0 + dBx
        y = torch.einsum("bhpn,bn->bhp", h, Cc[:, 0].to(f32))[:, None]
        new_state = dict(ssm=h, conv=new_conv)
    y = y + p["D"][:, None] * xin.to(f32)
    y = y.reshape(B, S if state is None else 1, di)
    g = y.to(x.dtype) * silu(z[:, :y.shape[1]])
    if split:
        # the gated RMSNorm over all d_inner channels: each rank's sum of
        # squares summed over 'model' (and its gradient summed back)
        gf = g.to(f32)
        ss = ctx.to_model(ctx.model_sum(torch.sum(gf * gf, -1,
                                                  keepdim=True)))
        y = (gf * torch.rsqrt(ss / cfg.d_inner + 1e-6)
             * (1.0 + p["norm_scale"].to(f32))).to(g.dtype)
    else:
        y = rmsnorm(g, p["norm_scale"])
    out = row_parallel(y, p["out_proj"], cfg=cfg, acc_init=acc_init,
                       split=split)
    return out, new_state


# ---------------------------------------------------------------------------
# chunked softmax cross-entropy (never materializes (B,S,V) logits)
# ---------------------------------------------------------------------------


def vocab_part(w, vdim: int):
    """The (V, d) logits weight from its stored leaf (``(V, d)`` with
    ``vdim`` 0, ``(d, V)`` with 1) and the first vocabulary id it holds:
    this rank's V/tp rows where the vocabulary divides the 'model' axis
    (``ctx.splits``), else the whole table and ``None``."""
    V = w.shape[vdim]
    split = ctx.splits(w, V)
    ctx.note("logits", ctx.model_size() if split else 1)
    if not split:
        w = ctx.gather(w)
        return (w if vdim == 0 else w.T), None
    w = ctx.model_part(w, vdim)
    v0 = ctx.model_rank() * (V // ctx.model_size())
    return (w if vdim == 0 else w.T), v0


def logits(h, w, vdim: int, dtype):
    """``h`` times the (V, d) logits table in ``dtype`` (stored as ``w``,
    ``(V, d)`` with ``vdim`` 0, ``(d, V)`` with 1): the whole (B, S, V) on
    every rank.  Under a 'model' axis the product splits along the dim
    the table is stored split on: a table stored with d on 'model' (the
    tied embedding) gives each rank its d/tp columns' partial logits (in
    float32), summed over 'model', so no part of the table moves; else
    the vocabulary splits where it divides the axis (``vocab_part``: this
    rank's V/tp logits, then one all-gather over 'model').  Where neither
    holds, the table is whole on every rank, as the reference leaves it,
    but gathered, cast and multiplied ``DECODE_UPCAST_BYTES`` of float32
    rows at a time, so that no step holds the whole table beside the
    cache."""
    if not ctx.on_model(w):
        emb = ctx.gather(w)
        emb = emb if vdim == 0 else emb.T
        return torch.matmul(h, emb.to(dtype).T.to(h.dtype))
    V, d = w.shape[vdim], w.shape[1 - vdim]
    tp = ctx.model_size()
    if ctx.model_dim(w) == 1 - vdim:
        ctx.note("logits", tp)
        emb = ctx.model_part(w, 1 - vdim)
        emb = emb if vdim == 0 else emb.T
        c0 = ctx.model_rank() * (d // tp)
        part = torch.matmul(ctx.to_model(h)[..., c0:c0 + d // tp].to(
            torch.float32), emb.to(dtype).T.to(torch.float32))
        return ctx.model_sum(part).to(h.dtype)
    if ctx.splits(w, V):
        emb, _ = vocab_part(w, vdim)
        return ctx.model_gather(
            torch.matmul(h, emb.to(dtype).T.to(h.dtype)), -1)
    ctx.note("logits", 1)
    rows = max(1, DECODE_UPCAST_BYTES // (4 * d))
    outs = []
    for v0 in range(0, V, rows):
        part = w[v0:v0 + rows] if vdim == 0 else w[:, v0:v0 + rows].T
        outs.append(torch.matmul(h, ctx.gather(part).to(dtype).T.to(
            h.dtype)))
    return torch.cat(outs, dim=-1)


def chunked_xent(h, emb, labels, chunk=1024, logit_softcap=0.0, v0=None):
    """h: (B,S,d), emb: (V,d), labels: (B,S) int (-100 = ignore).
    Returns (sum_nll, count).  With ``v0`` (``vocab_part``), ``emb`` is
    this rank's rows of the vocabulary from id ``v0`` on: each rank
    computes its logits, and the log-sum-exp's max and sum and the gold
    logit (from the rank that holds it) are reduced over 'model'."""
    B, S, d = h.shape
    c = min(chunk, S)
    assert S % c == 0, (S, c)
    s = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    if v0 is not None:
        h = ctx.to_model(h)
    w = emb.T.to(h.dtype)
    for c0 in range(0, S, c):
        hc, lc = h[:, c0:c0 + c], labels[:, c0:c0 + c]
        logits = torch.matmul(hc, w).to(torch.float32)
        if logit_softcap:
            logits = torch.tanh(logits / logit_softcap) * logit_softcap
        if v0 is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, torch.clamp(lc, min=0).to(
                torch.long)[..., None])[..., 0]
        else:
            m = ctx.model_max(logits.amax(dim=-1))
            lse = m + torch.log(ctx.model_sum(
                torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
            idx = lc.to(torch.long) - v0
            mine = (idx >= 0) & (idx < logits.shape[-1])
            g = torch.gather(logits, -1, torch.clamp(
                idx, 0, logits.shape[-1] - 1)[..., None])[..., 0]
            gold = ctx.model_sum(torch.where(mine, g, 0.0))
        valid = lc >= 0
        nll = torch.where(valid, lse - gold, 0.0)
        s = s + torch.sum(nll)
        cnt = cnt + torch.sum(valid).to(torch.int32)
    # under a mesh: summed over the ranks' rows
    return ctx.batch_sum(s), ctx.batch_sum(cnt)


def stack_len(stack) -> int:
    """Leading (layer) extent of a stacked parameter tree."""
    node = stack
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return (node.q if isinstance(node, Q.BlockQuantized) else node).shape[0]


def layers(stack) -> list:
    """The per-layer trees of a stacked parameter tree (views): one
    ``torch.unbind`` per leaf, a ``BlockQuantized``'s ``q`` and ``exp``
    alike.  Under autograd the backward then writes each stacked leaf's
    gradient once (``UnbindBackward`` stacks the per-layer gradients),
    where reading layer ``i`` as ``t[i]`` would write a zero tensor the
    size of the whole stack for every layer and add it in.  A DTensor
    leaf sharded on its layer dim is gathered along it first (DTensor
    unbinds no sharded dim)."""
    parts = [torch.unbind(ctx.whole_along(t, 0)) for t in T.leaves(stack)]
    return [T.unflatten(stack, [p[i] for p in parts])
            for i in range(stack_len(stack))]


# ---------------------------------------------------------------------------
# rematerialization (the reference's ``jax.checkpoint`` around a layer)
# ---------------------------------------------------------------------------

# the matmuls with no batch dimension, as PyTorch dispatches them (a
# ``torch.matmul`` of (B, S, d) by (d, n) folds into ``mm``): what
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, enabled: bool, policy: str):
    """``fn`` checkpointed per call when ``enabled`` and autograd is
    recording (serving runs without autograd and is left as it is): the
    backward recomputes ``fn``'s forward instead of keeping what it saved.
    ``policy == "dots"`` keeps the outputs of the matmuls with no batch
    dimension (selective checkpointing); any other value keeps nothing, as
    the reference's ``policy=None``.  The recomputed forward is the same
    arithmetic, so no value changes."""
    if not (enabled and torch.is_grad_enabled()):
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return checkpoint(fn, *args, **kw)
    return run
