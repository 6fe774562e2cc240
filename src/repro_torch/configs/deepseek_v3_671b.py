"""deepseek-v3-671b  [moe] 61L d_model=7168 128H, MLA (q_lora 1536, kv_lora
512, nope 128, rope 64, v 128), MoE: 1 shared + 256 routed top-8 (expert
d_ff=2048), first 3 layers dense (d_ff=18432), MTP depth 1, vocab=129280.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=18432, vocab_size=129_280,
    mlp_type="silu", attn_type="mla",
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    num_experts=256, num_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, mtp_depth=1,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(num_layers=3, first_dense_layers=1, d_model=64,
                        num_heads=4, num_kv_heads=4,
                        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                        qk_rope_dim=8, v_head_dim=16, head_dim=16,
                        d_ff=128, moe_d_ff=32, num_experts=8, top_k=2,
                        vocab_size=512, mtp_depth=1,
                        dtype="float32", param_dtype="float32",
                        attn_chunk=0, loss_chunk=16)
