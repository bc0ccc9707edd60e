"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]: llama-arch, 62L d7168
56H(kv8) d_ff=19200 vocab 32256, RMSNorm + swiglu + rope."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, head_dim=128,
    rope_theta=100000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256)
