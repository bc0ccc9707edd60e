"""SeamlessM4T-medium [arXiv:2308.11596; hf]: enc-dec, 12L enc + 12L dec,
d1024 16H(kv16) d_ff=4096 vocab 256206; audio frontend STUB (input_specs
provides frame embeddings), LayerNorm + gelu FFN, learned positions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    encoder_layers=12, cross_attention=True, frontend="audio",
    norm_kind="layernorm", mlp_kind="gelu", src_ratio=4,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
