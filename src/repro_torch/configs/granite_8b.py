"""granite-8b  [dense] 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152
llama-arch, code model.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49_152,
    mlp_type="silu",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
