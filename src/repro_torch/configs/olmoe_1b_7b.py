"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H(kv16) MoE 64e top-8,
per-expert d_ff=1024, vocab 50304, QK-norm, RMSNorm, swiglu."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    num_experts=64, top_k=8, moe_d_ff=1024, moe_every=1,
    qk_norm=True, rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=96, moe_d_ff=96, vocab_size=256, num_experts=4,
        top_k=2)
