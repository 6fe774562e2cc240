"""nemotron-4-340b  [dense] 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — squared-ReLU MLP, head_dim=192.  [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256_000,
    mlp_type="relu2",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
                        head_dim=24, d_ff=256, vocab_size=512,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
