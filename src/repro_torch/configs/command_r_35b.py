"""Command R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified]: 40L d8192
64H(kv8) d_ff=22528 vocab 256000; parallel block, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    parallel_block=True, norm_kind="layernorm", tie_embeddings=True,
    rope_theta=8000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256)
