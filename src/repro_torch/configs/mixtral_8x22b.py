"""mixtral-8x22b  [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA window 4096.  SWA bounds the decode KV
cache, so this arch runs the long_500k cell.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32_768,
    mlp_type="silu", sliding_window=4096,
    num_experts=8, top_k=2, moe_d_ff=16384,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        num_experts=4, top_k=2, moe_d_ff=128,
                        sliding_window=16,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
