"""zamba2-7b  [hybrid] 81L d_model=3584, Mamba2 (ssm_state=64, headdim=64,
d_inner=7168) + ONE shared attention+MLP block (32H, d_ff=14336) applied after
every 6th mamba layer, vocab=32000.  [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32_000,
    mlp_type="silu",
    ssm_state=64, d_inner=7168, mamba_headdim=64, conv_kernel=4,
    mamba_version=2, shared_block_period=6,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=5, shared_block_period=2, d_model=64,
                        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                        d_inner=128, mamba_headdim=16, ssm_state=8,
                        vocab_size=512,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
