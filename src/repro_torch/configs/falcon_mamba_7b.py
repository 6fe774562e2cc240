"""falcon-mamba-7b  [ssm] 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16 (mamba1: d_inner=8192, dt_rank=256, conv k=4).
[arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, d_ff=0, vocab_size=65_024,
    attn_type="none", use_rope=False,
    ssm_state=16, d_inner=8192, dt_rank=256, conv_kernel=4, mamba_version=1,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=64, d_inner=128, dt_rank=8,
                        ssm_state=4, vocab_size=512,
                        dtype="float32", param_dtype="float32", loss_chunk=16)
