"""InternVL2-2B [arXiv:2404.16821; hf]: InternLM2-1.8B backbone 24L d2048
16H(kv8) d_ff=8192 vocab 92553 + InternViT frontend (STUB: input_specs
provides 256 patch embeddings prepended to the text sequence)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    frontend="vision", num_prefix_embeds=256, rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, num_prefix_embeds=8)
