"""Architecture registry, ported from ``repro.models.registry``: maps arch
ids to configs and provides the uniform batch-dict model API of the
serve path and the ml island.

Batch dicts:
  forward: {tokens (B,S_text) int32 [, prefix_embeds (B,P,D) f32]}
  prefill: {tokens (B,S)} (+ prefix_embeds) + cache tree
  decode:  {tokens (B,1)} + cache tree + pos

Every decoder-only arch of the pool runs (the dense, moe, ssm, hybrid and
vlm families).  Encoder-decoder archs (seamless-m4t-medium) come with the
encoder-decoder slice, and ``loss_fn``/``make_train_batch`` with the
training slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str, *, reduced: bool = False, **overrides
               ) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    cfg = mod.reduced() if reduced else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def _decoder_only(cfg: ModelConfig) -> None:
    if is_encdec(cfg):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder archs are not ported yet "
            f"(ROADMAP.md §1, the encoder-decoder slice)")


def param_specs(cfg: ModelConfig):
    _decoder_only(cfg)
    return lm.param_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    _decoder_only(cfg)
    return lm.cache_specs(cfg, batch, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    _decoder_only(cfg)
    return lm.init_cache(cfg, batch, cache_len, device)


def forward(params, batch: Dict[str, Any], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _decoder_only(cfg)
    return lm.forward(params, batch["tokens"], cfg,
                      prefix_embeds=batch.get("prefix_embeds"))


def prefill(params, batch: Dict[str, Any], cache, cfg: ModelConfig):
    """Returns (last-token logits, cache, extras-dict)."""
    _decoder_only(cfg)
    logits, new_cache = lm.prefill(params, batch["tokens"], cache, cfg,
                                   prefix_embeds=batch.get("prefix_embeds"))
    return logits, new_cache, {}


def decode_step(params, batch: Dict[str, Any], cache, pos: int,
                cfg: ModelConfig):
    _decoder_only(cfg)
    return lm.decode_step(params, batch["tokens"], cache, pos, cfg)

