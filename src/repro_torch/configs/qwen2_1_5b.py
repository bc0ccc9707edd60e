"""Qwen2-1.5B [arXiv:2407.10671; hf]: 28L d1536 12H(kv2) d_ff=8960
vocab 151936, QKV bias, RMSNorm + swiglu, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256)
