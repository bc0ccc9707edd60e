"""Command R+ 104B [hf:CohereForAI; unverified]: 64L d12288 96H(kv8)
d_ff=33792 vocab 256000; cohere-style parallel attn+FFN block, LayerNorm
(no bias handled via layernorm specs), tied embeddings, no qkv bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    parallel_block=True, norm_kind="layernorm", tie_embeddings=True,
    rope_theta=75000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256)
