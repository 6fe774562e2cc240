"""llama3.2-3b  [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-3B; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128_256,
    mlp_type="silu", rope_theta=500_000.0, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
