"""Jamba-v0.1-52B [arXiv:2403.19887; hf]: 32L d4096, Mamba:attention 7:1
interleave (attn at sub-layer 4 of each period-8 block), MoE 16e top-2 on
odd sub-layers (d_ff=14336 per expert), 32H(kv8), vocab 65536; runs
long_500k (hybrid sub-quadratic decode)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    num_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
    ssm_kind="mamba", attn_every=8, attn_offset=4,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, moe_d_ff=96, vocab_size=256, num_experts=4,
        top_k=2, attn_every=4, attn_offset=2, moe_every=2, moe_offset=1,
        ssm_state=8, ssm_conv=4)
