"""Analytic roofline terms (exact formulas from the architecture): the
port of ``repro.launch.analytic``.

Per-device-per-step flops, bytes and collective bytes, each term the
reference's formula over the port's ``configs`` and ``models.model``
(``param_bytes``, ``active_param_count``, ``model_flops``); the seconds
terms divide them by the H100's peaks (``launch.mesh``).  Executed flops
include the known inefficiencies (masked causal upper triangle in chunked
attention, MoE capacity padding) so the "useful ratio" against 6ND is
honest.  A training run reads ``an_flops_per_device`` and ``an_step_s``
beside its measured step.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeSpec
    chips: int
    tp: int
    fsdp: int           # data(+pod) ways
    grad_accum: int = 1
    causal_skip: bool = False   # hillclimb: halve masked attention flops
    opt_state_bytes_per_param: float = 8.0  # f32 m+v; 2.0 when int8


def _attn_kv_len(cfg, shape):
    if shape.kind == "decode":
        S = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
            else shape.seq_len
        return S
    S = shape.seq_len
    return min(S, cfg.sliding_window) if cfg.sliding_window else S


def _layer_flops_per_token(cfg: ModelConfig, shape: ShapeSpec,
                           causal_skip=False) -> dict:
    """Forward flops per token, split mm vs attention (executed)."""
    d = cfg.d_model
    out = dict(mm=0.0, attn=0.0)
    S_kv = _attn_kv_len(cfg, shape)
    # attention executed length: chunked masked compute does the full S_kv
    # (upper triangle wasted) unless causal_skip halves it for train/prefill
    s_att = S_kv if shape.kind == "decode" else (
        S_kv / 2 if causal_skip else S_kv)

    def dense_attn():
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        mm = 2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d
        attn = 4 * H * hd * s_att
        return mm, attn

    def mla_attn():
        H = cfg.num_heads
        dn, dr, dv, dc = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                          cfg.kv_lora_rank)
        mm = (2 * d * cfg.q_lora_rank + 2 * cfg.q_lora_rank * H * (dn + dr)
              + 2 * d * (dc + dr) + 2 * H * dv * d)
        if shape.kind == "decode":
            # absorbed: q W_kb + scores over latent + out latent + v expand
            mm += 2 * H * dn * dc + 2 * H * dc * dv
            attn = 2 * H * (dc + dr) * s_att + 2 * H * dc * s_att
        else:
            mm += 2 * dc * H * (dn + dv)     # K/V expansion per token
            attn = 4 * H * (dn + dr + dv) / 2 * s_att  # qk(dn+dr) + av(dv)
        return mm, attn

    def mlp(ff):
        n_proj = 3 if cfg.mlp_type in ("silu", "geglu") else 2
        return 2 * d * ff * n_proj

    if cfg.family in ("dense", "vlm"):
        mm, attn = dense_attn()
        out["mm"] = mm + mlp(cfg.d_ff)
        out["attn"] = attn
        out["layers"] = cfg.num_layers
    elif cfg.family == "audio":
        mm, attn = dense_attn()
        # decoder: self + cross + mlp; encoder accounted separately (enc_len)
        out["mm"] = mm * 2 + mlp(cfg.d_ff)
        out["attn"] = attn + 4 * cfg.num_heads * cfg.head_dim * cfg.encoder_len
        out["layers"] = cfg.num_layers
    elif cfg.family == "moe":
        mm, attn = mla_attn() if cfg.attn_type == "mla" else dense_attn()
        moe = (cfg.top_k * 1.25 * mlp(cfg.moe_d_ff)  # capacity waste
               + cfg.num_shared_experts * mlp(cfg.moe_d_ff)
               + 2 * d * cfg.num_experts)
        n_moe = cfg.num_layers - cfg.first_dense_layers
        dense_part = cfg.first_dense_layers * (mm + mlp(cfg.d_ff) + attn)
        moe_part = n_moe * (mm + moe + attn)
        out["mm"] = (dense_part + moe_part) / cfg.num_layers
        # fold attn into mm-average above; keep attn separate:
        out["mm"] = (cfg.first_dense_layers * (mm + mlp(cfg.d_ff))
                     + n_moe * (mm + moe)) / cfg.num_layers
        out["attn"] = attn
        out["layers"] = cfg.num_layers
    elif cfg.family == "ssm":
        di, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.conv_kernel
        out["mm"] = (2 * d * 2 * di + 2 * K * di + 2 * di * (R + 2 * N)
                     + 2 * R * di + 2 * di * d)
        out["attn"] = 12 * di * N          # scan elementwise
        out["layers"] = cfg.num_layers
    elif cfg.family == "hybrid":
        di, N, K = cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
        hd = cfg.mamba_headdim
        nh = di // hd
        c = 128
        mamba = (2 * d * (2 * di + 2 * N + nh) + 2 * K * (di + 2 * N)
                 + 2 * di * d)
        ssd = nh * (2 * c * N + 2 * c * hd + 4 * N * hd) if \
            shape.kind != "decode" else nh * (4 * N * hd)
        H, hdh = cfg.num_heads, cfg.head_dim
        shared_mm = (2 * d * H * hdh * 2 + 2 * H * hdh * d + mlp(cfg.d_ff))
        shared_attn = 4 * H * hdh * s_att
        n_shared = cfg.num_layers // cfg.shared_block_period
        out["mm"] = mamba + (n_shared * shared_mm) / cfg.num_layers
        out["attn"] = ssd + (n_shared * shared_attn) / cfg.num_layers
        out["layers"] = cfg.num_layers
    return out


def analytic_terms(cell: Cell) -> dict:
    cfg, shape = cell.cfg, cell.shape
    chips = cell.chips
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    lf = _layer_flops_per_token(cfg, shape, cell.causal_skip)
    L = lf["layers"]
    head = 2 * cfg.d_model * cfg.vocab_size
    enc = 0.0
    if cfg.family == "audio" and shape.kind != "decode":
        # encoder flops over encoder_len frames
        H, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
        enc_per_tok = (2 * d * H * hd * 2 + 2 * H * hd * d + 2 * d * cfg.d_ff * 3
                       + 4 * H * hd * cfg.encoder_len)
        enc = cfg.encoder_layers * enc_per_tok * B * cfg.encoder_len

    fwd_mm = tokens * (L * lf["mm"] + head) + enc
    fwd_attn = tokens * L * lf["attn"]
    if shape.kind == "train":
        flops = 3 * fwd_mm + 4 * fwd_attn          # bwd 2x + attn recompute
    else:
        flops = fwd_mm + fwd_attn
    flops_dev = flops / chips

    # ---- memory bytes per device ----
    pbytes = M.param_bytes(cfg)
    act_bytes_param = M.active_param_count(cfg) * cfg.pdtype.itemsize
    d_eff = cfg.d_model
    ff_eff = max(cfg.d_ff, cfg.moe_d_ff * max(1, cfg.top_k), 2 * cfg.d_inner)
    per_tok_act = (4 * d_eff + 2 * ff_eff) * 2  # bf16 saved tensors/layer
    if shape.kind == "train":
        tokens_mb_dev = tokens / max(1, cell.grad_accum) / chips
        acts = L * per_tok_act * tokens_mb_dev * 3 * cell.grad_accum
        params_io = (pbytes * (2 * cell.grad_accum + 2)   # re-read per mb
                     + pbytes * 2                          # grads
                     + M.param_count(cfg) * cell.opt_state_bytes_per_param)
        mem_dev = params_io / chips + acts
    elif shape.kind == "prefill":
        acts = L * per_tok_act * tokens / chips
        mem_dev = pbytes / chips + acts
    else:
        S_kv = _attn_kv_len(cfg, shape)
        if cfg.attn_type == "mla":
            kv_row = cfg.kv_lora_rank + cfg.qk_rope_dim
        elif cfg.family == "ssm":
            kv_row = 0
        elif cfg.family == "hybrid":
            kv_row = 2 * cfg.num_kv_heads * cfg.head_dim / cfg.shared_block_period
        else:
            kv_row = 2 * cfg.num_kv_heads * cfg.head_dim
        kv_b = 1 if cfg.kv_cache_dtype == "int8" else 2
        kv_bytes = L * B * S_kv * kv_row * kv_b
        state_bytes = 0
        if cfg.family in ("ssm", "hybrid"):
            di = cfg.d_inner
            state_bytes = L * B * di * cfg.ssm_state * 4
        mem_dev = (act_bytes_param + 2 * kv_bytes + 2 * state_bytes) / chips
    # ---- collective bytes per device ----
    tp, fsdp = cell.tp, cell.fsdp
    p_tp = pbytes / tp
    coll = 0.0
    if shape.kind == "train":
        ag_params = 2 * cell.grad_accum * p_tp * (fsdp - 1) / fsdp
        rs_grads = 2 * p_tp * (fsdp - 1) / fsdp
        tok_mb_shard = tokens / max(1, cell.grad_accum) / fsdp
        ar_tp = (4 * L * tok_mb_shard * d_eff * 2 * (tp - 1) / tp
                 * cell.grad_accum)
        coll = ag_params + rs_grads + ar_tp
    elif shape.kind == "prefill":
        ag_params = p_tp * (fsdp - 1) / fsdp
        tok_shard = tokens / fsdp
        ar_tp = 2 * L * tok_shard * d_eff * 2 * (tp - 1) / tp
        coll = ag_params + ar_tp
    else:
        ag_params = act_bytes_param / tp * (fsdp - 1) / fsdp
        tok_shard = max(1.0, tokens / fsdp)
        ar_tp = 2 * L * tok_shard * d_eff * 2 * (tp - 1) / tp
        coll = ag_params + ar_tp

    compute_s = flops_dev / mesh_lib.PEAK_BF16_FLOPS
    memory_s = mem_dev / mesh_lib.HBM_BW
    collective_s = coll / mesh_lib.ICI_BW
    model_fl = M.model_flops(cfg, shape)
    step_s = max(compute_s, memory_s, collective_s)
    return dict(
        an_flops_per_device=flops_dev,
        an_bytes_per_device=mem_dev,
        an_collective_bytes_per_device=coll,
        an_compute_s=compute_s,
        an_memory_s=memory_s,
        an_collective_s=collective_s,
        an_bottleneck=max((("compute", compute_s), ("memory", memory_s),
                           ("collective", collective_s)),
                          key=lambda t: t[1])[0],
        an_step_s=step_s,
        an_mfu=(model_fl / chips / mesh_lib.PEAK_BF16_FLOPS) / step_s
        if step_s else None,
        an_useful_ratio=model_fl / chips / flops_dev if flops_dev else None,
    )
