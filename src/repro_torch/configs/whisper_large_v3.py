"""whisper-large-v3  [audio] enc-dec, 32L each, d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, encoder_len, d).  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, encoder_layers=32, d_model=1280, num_heads=20,
    num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51_866,
    mlp_type="silu", norm_type="layernorm", use_rope=False,
    encoder_len=1500,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, encoder_layers=2, d_model=64,
                        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                        vocab_size=512, encoder_len=32,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
