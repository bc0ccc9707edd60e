"""RWKV6-7B "Finch" [arXiv:2404.05892; hf]: 32L d4096, attention-free
data-dependent-decay linear recurrence, d_ff=14336 channel mix,
vocab 65536, head size 64; runs long_500k (O(1) decode state)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    ssm_kind="rwkv6", attn_every=0, rwkv_head_dim=64,
    norm_kind="layernorm",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
        head_dim=64, rwkv_head_dim=32, d_ff=128, vocab_size=256)
