"""Architecture/shape configuration system: the port's copy of
``repro.configs.base``.

Every architecture is a ``ModelConfig`` in ``repro_torch.configs.<id>``;
``get_config(name)`` resolves it.  Shape cells (train_4k / prefill_32k /
decode_32k / long_500k) are ``ShapeSpec``s; ``input_specs()`` and
``cache_specs()`` describe a cell's inputs and decode state without
allocating: each entry is made by a factory ``sds(shape, dtype, axes)``,
by default a ``TensorSpec`` (shape, torch dtype).  ``axes`` names the
logical axes of each dimension, as the JAX package hands them to its
sharding rules (the port's are ``parallel.sharding``); the default factory
drops them.  ``model.init_cache`` passes a factory that allocates zeros.
``per_rank_cache()`` names the cache entries a rank holds at its own
'model' shard.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm | resnet
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    mlp_type: str = "silu"           # silu | geglu | relu2
    attn_type: str = "gqa"           # gqa | mla | none
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    emb_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    sliding_window: int = 0          # SWA window (0 = full attention)
    logit_softcap: float = 0.0
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: first k layers are dense
    moe_capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0               # deepseek multi-token-prediction heads
    # --- SSM ---
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    conv_kernel: int = 4
    mamba_version: int = 1           # 1 (falcon-mamba) | 2 (zamba2 SSD)
    mamba_headdim: int = 64          # mamba2 only
    shared_block_period: int = 0     # zamba2: shared attn block every N layers
    # --- enc-dec / multimodal (whisper, internvl2) ---
    encoder_layers: int = 0          # whisper: encoder depth (== num_layers)
    encoder_len: int = 1500          # stub frame/patch sequence length
    num_patches: int = 0             # internvl2 patch embedding count
    # --- numerics / technique (paper) ---
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "bfloat16"
    quant: str = "none"              # none | qat | int8w  (paper pow2-int8)
    kv_cache_dtype: str = "bfloat16"  # or "int8" (paper scheme on the cache)
    residual_fusion: bool = True     # paper add-fold on the residual stream
    # --- schedule / memory (kept for parity; the port does not shard yet,
    # and remat changes no forward value) ---
    kv_shard_model: bool = False   # shard KV-cache head_dim over 'model'
    seq_shard: bool = False        # Megatron-SP: shard activations' seq dim
    remat: bool = True
    remat_policy: str = "dots"       # dots | nothing (recompute everything)
    scan_layers: bool = True
    attn_chunk: int = 512            # flash-style chunking for long seq
    loss_chunk: int = 1024           # chunked softmax-xent
    moe_impl: str = "grouped"        # grouped (sort+scan) | dense (ref)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived ----
    @property
    def qk_head_dim(self) -> int:
        if self.attn_type == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic sequence mixers."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def supports_shape(self, shape: str) -> bool:
        if shape == "long_500k":
            return self.supports_long_context()
        return True


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


ARCH_IDS = [
    "gemma-2b",
    "llama3.2-3b",
    "nemotron-4-340b",
    "granite-8b",
    "whisper-large-v3",
    "internvl2-1b",
    "falcon-mamba-7b",
    "mixtral-8x22b",
    "deepseek-v3-671b",
    "zamba2-7b",
]


# ---------------------------------------------------------------------------
# Input specs (shape/dtype stand-ins; no allocation)
# ---------------------------------------------------------------------------


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tensor_spec(shape, dtype, axes=None) -> TensorSpec:
    """The default ``sds`` factory: the shape and dtype only."""
    return TensorSpec(tuple(shape), dtype)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, sds=tensor_spec) -> dict:
    """Model inputs for one shape cell, each made by ``sds(shape, dtype,
    logical_axes)``."""
    B, S = shape.global_batch, shape.seq_len
    i32, f = torch.int32, cfg.compute_dtype

    def extras(specs):
        if cfg.family == "audio":
            # conv-frontend STUB: precomputed frame embeddings for the encoder
            specs["frames"] = sds((B, cfg.encoder_len, cfg.d_model), f,
                                  ("batch", "seq", "embed"))
        if cfg.family == "vlm":
            specs["patches"] = sds((B, cfg.num_patches, cfg.d_model), f,
                                   ("batch", "seq", "embed"))
        return specs

    if shape.kind == "train":
        return extras(dict(
            tokens=sds((B, S), i32, ("batch", "seq")),
            labels=sds((B, S), i32, ("batch", "seq")),
        ))
    if shape.kind == "prefill":
        return extras(dict(tokens=sds((B, S), i32, ("batch", "seq"))))
    # decode: one new token against a seq_len-deep cache/state
    return dict(
        tokens=sds((B, 1), i32, ("batch", None)),
        pos=sds((B,), i32, ("batch",)),
        cache=cache_specs(cfg, B, S, sds),
    )


def cache_specs(cfg: ModelConfig, B: int, S: int, sds) -> dict:
    """Decode-state stand-ins.  SWA bounds the cache to the window (the reason
    mixtral runs long_500k); SSM state is O(1) in S."""
    kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.compute_dtype
    f32 = torch.float32
    out = {}
    L = cfg.num_layers
    S_kv = min(S, cfg.sliding_window) if cfg.sliding_window else S

    if cfg.family in ("ssm",):
        out["ssm_state"] = sds((L, B, cfg.d_inner, cfg.ssm_state), f32,
                               (None, "batch", "heads", None))
        out["conv_state"] = sds((L, B, cfg.conv_kernel - 1, cfg.d_inner),
                                cfg.compute_dtype, (None, "batch", None, "heads"))
        return out
    if cfg.family == "hybrid":
        nh = cfg.d_inner // cfg.mamba_headdim
        out["ssm_state"] = sds((L, B, nh, cfg.mamba_headdim, cfg.ssm_state),
                               f32, (None, "batch", "heads", None, None))
        # mamba2 convolves x, B and C jointly -> d_inner + 2*N channels
        out["conv_state"] = sds(
            (L, B, cfg.conv_kernel - 1, cfg.d_inner + 2 * cfg.ssm_state),
            cfg.compute_dtype, (None, "batch", None, "heads"))
        # the single shared attention block's KV cache
        n_shared = L // cfg.shared_block_period
        out["k"] = sds((n_shared, B, S_kv, cfg.num_kv_heads, cfg.head_dim),
                       kv_dt, (None, "batch", "seq", "heads", None))
        out["v"] = sds((n_shared, B, S_kv, cfg.num_kv_heads, cfg.head_dim),
                       kv_dt, (None, "batch", "seq", "heads", None))
        return out
    if cfg.attn_type == "mla":
        # MLA caches the compressed latent + rope key only (paper-faithful
        # int8 quantization applies to this latent as well)
        hd_ax = "embed" if cfg.kv_shard_model else None
        out["ckv"] = sds((L, B, S_kv, cfg.kv_lora_rank), kv_dt,
                         (None, "batch", "seq", hd_ax))
        out["krope"] = sds((L, B, S_kv, cfg.qk_rope_dim), kv_dt,
                           (None, "batch", "seq", None))
        return out
    # GQA/MQA transformer KV cache; optionally shard head_dim over 'model'
    # (kv head counts are rarely divisible by 16, head_dim always is)
    hd_ax = "embed" if cfg.kv_shard_model else None
    out["k"] = sds((L, B, S_kv, cfg.num_kv_heads, cfg.head_dim), kv_dt,
                   (None, "batch", "seq", None, hd_ax))
    out["v"] = sds((L, B, S_kv, cfg.num_kv_heads, cfg.head_dim), kv_dt,
                   (None, "batch", "seq", None, hd_ax))
    if cfg.family == "audio":
        # cross-attention K/V over stub encoder states (computed at prefill)
        out["xk"] = sds((L, B, cfg.encoder_len, cfg.num_kv_heads, cfg.head_dim),
                        kv_dt, (None, "batch", "seq", "heads", None))
        out["xv"] = sds((L, B, cfg.encoder_len, cfg.num_kv_heads, cfg.head_dim),
                        kv_dt, (None, "batch", "seq", "heads", None))
    return out


def per_rank_cache(cfg: ModelConfig, tp: int) -> tuple:
    """The decode cache entries that hold this rank's heads or channels
    only on a 'model' axis of ``tp`` ranks: those that ``cache_specs``
    place by ``"heads"`` on a dim that ``tp`` divides (where
    ``parallel.sharding.input_sharding_factory`` puts 'model'), but
    Mamba2's conv state, whose packed ``[x | B | C]`` channels shard no
    rank's own heads: it stays whole on every rank.  A layer writes and
    reads these at its own shard and every other entry whole; the dry-run
    keeps exactly these at their 'model' shard."""
    if tp <= 1:
        return ()

    def sds(shape, dtype, axes):
        return shape, axes
    return tuple(
        k for k, (shape, axes) in cache_specs(cfg, 1, 1, sds).items()
        if not (cfg.family == "hybrid" and k == "conv_state")
        and any(a == "heads" and n % tp == 0 for n, a in zip(shape, axes)))
