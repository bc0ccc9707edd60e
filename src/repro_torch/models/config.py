"""Unified model configuration for the assigned architecture pool, copied
from ``repro.models.config`` (the port keeps its own copy: it imports
nothing of the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False             # RMSNorm on q/k heads (olmoe)
    parallel_block: bool = False      # cohere-style: attn and ffn in parallel
    rope_theta: float = 10000.0
    attn_impl: str = "reference"      # reference | flash (Pallas)

    # norms / ffn
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    mlp_kind: str = "swiglu"          # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    moe_every: int = 1                # MoE ffn on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    first_k_dense: int = 0            # leading dense layers (deepseek-moe)
    dense_d_ff: int = 0               # d_ff for those leading dense layers
    capacity_factor: float = 1.25     # capacity path only (moe_dropless=False)
    # Dropless (exact) MoE is the reference semantic: forward ≡ decode and
    # per-token results don't depend on batch composition.  The capacity-
    # clipped sort dispatch is the at-scale training approximation; the
    # launch dry-run opts into it explicitly (see moe.py docstring).
    moe_dropless: bool = True

    # hybrid / ssm
    attn_every: int = 1               # attention on layers where i % attn_every == attn_offset
    attn_offset: int = 0
    ssm_kind: str = ""                # "" | rwkv6 | mamba
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64

    # encoder-decoder
    encoder_layers: int = 0           # >0 => enc-dec (audio family)
    cross_attention: bool = False

    # modality frontends (STUB: precomputed embeddings via input_specs)
    frontend: str = ""                # "" | vision | audio
    num_prefix_embeds: int = 0        # vision patches prepended to the sequence
    src_ratio: int = 4                # enc-dec: src_len = seq_len // src_ratio

    # training-time knobs
    remat: str = "block"              # none | block | full
    scan_layers: bool = True

    # perf knobs (EXPERIMENTS.md §Perf)
    vocab_pad_to: int = 0             # pad vocab so it shards (hillclimb)
    kv_cache_dtype: str = "bf16"      # bf16 | int8 (quant_cast pages)
    shard_ctx_train: bool = False     # shard k/v sequence in training attn
    # §Perf MoE iteration: constraining the dispatch buffers (EXPERT→model,
    # CAPACITY→data) makes SPMD lower the expert scatter 8× worse than
    # propagation-placed dispatch — measured in EXPERIMENTS.md §Perf; the
    # constrained variant remains available for A/B via this knob.
    moe_cap_shard: bool = False

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to and self.vocab_size % self.vocab_pad_to:
            return self.vocab_size + (
                self.vocab_pad_to - self.vocab_size % self.vocab_pad_to)
        return self.vocab_size

    def __post_init__(self):
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.num_experts:
            assert self.top_k > 0 and self.moe_d_ff > 0, self.name

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.ssm_kind != "" and self.attn_every == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid archs only (DESIGN.md §4)."""
        return self.ssm_kind != ""

    @property
    def decoder_layers(self) -> int:
        return self.num_layers

    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """Returns ((mixer_kind, ffn_kind), ...) for one scan period.

        mixer: 'attn' | 'rwkv6' | 'mamba';  ffn: 'dense' | 'moe' | 'rwkv_cm'.
        Period = number of distinct sub-layer slots in the repeating pattern.
        """
        if self.ssm_kind == "rwkv6":
            return (("rwkv6", "rwkv_cm"),)
        period = 1
        if self.ssm_kind:                 # hybrid (jamba)
            period = max(period, self.attn_every)
        if self.is_moe:
            period = _lcm(period, self.moe_every)
        plan = []
        for i in range(period):
            if self.ssm_kind and not (
                    self.attn_every and i % self.attn_every == self.attn_offset):
                mixer = self.ssm_kind
            else:
                mixer = "attn"
            if self.is_moe and i % self.moe_every == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append((mixer, ffn))
        return tuple(plan)

    def scan_period(self) -> int:
        return len(self.layer_plan())

    def num_scanned(self) -> int:
        body = self.num_layers - self.first_k_dense
        period = self.scan_period()
        assert body % period == 0, (self.name, body, period)
        return body // period


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)
