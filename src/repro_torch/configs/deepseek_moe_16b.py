"""DeepSeekMoE-16B [arXiv:2401.06066; hf]: 28L d2048 16H(kv16), fine-grained
MoE 64 routed top-6 + 2 shared experts (d_ff=1408 each), first layer dense
(d_ff=10944), vocab 102400."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    moe_every=1, first_k_dense=1, dense_d_ff=10944,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=96, moe_d_ff=96, vocab_size=256, num_experts=4,
        num_shared_experts=2, top_k=2, first_k_dense=1, dense_d_ff=160)
