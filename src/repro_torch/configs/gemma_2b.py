"""gemma-2b  [dense] 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
GeGLU, head_dim=256, embedding scaling.  [arXiv:2403.08295; hf]
(The int8 LM lowering reads the shape only.)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256_000,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
                        head_dim=16, d_ff=128, vocab_size=512)
