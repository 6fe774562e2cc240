"""internvl2-1b  [vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
InternViT frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, num_patches, d) that occupy the first token slots.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151_655,
    mlp_type="silu", rope_theta=1_000_000.0, tie_embeddings=True,
    num_patches=256,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, num_patches=8,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
