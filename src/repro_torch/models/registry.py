"""Architecture registry, ported from ``repro.models.registry``: maps arch
ids to configs and provides the uniform batch-dict model API of the
serve path and the ml island.

Batch dicts:
  forward: {tokens (B,S_text) int32 [, prefix_embeds (B,P,D) f32]
            [, frame_embeds (B,S_src,D) f32]}
  prefill: {tokens (B,S)} (+ prefix_embeds / frame_embeds) + cache tree
  decode:  {tokens (B,1)} + cache tree + pos
            (+ memory (B,S_src,D) for enc-dec)

Every arch of the pool runs: the decoder-only families (dense, moe, ssm,
hybrid, vlm) through ``lm`` and the encoder-decoder one
(seamless-m4t-medium) through ``encdec``.  ``loss_fn`` and
``make_train_batch`` come with the training slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import encdec, lm
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


def param_specs(cfg: ModelConfig):
    return encdec.param_specs(cfg) if is_encdec(cfg) else lm.param_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    if is_encdec(cfg):
        return encdec.cache_specs(cfg, batch, cache_len)
    return lm.cache_specs(cfg, batch, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    if is_encdec(cfg):
        return encdec.init_cache(cfg, batch, cache_len, device)
    return lm.init_cache(cfg, batch, cache_len, device)


def forward(params, batch: Dict[str, Any], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_encdec(cfg):
        return encdec.forward(params, batch["tokens"],
                              batch["frame_embeds"], cfg)
    return lm.forward(params, batch["tokens"], cfg,
                      prefix_embeds=batch.get("prefix_embeds"))


def prefill(params, batch: Dict[str, Any], cache, cfg: ModelConfig):
    """Returns (last-token logits, cache, extras-dict); an enc-dec arch's
    extras hold the encoder ``memory`` that every decode step reads."""
    if is_encdec(cfg):
        logits, cache, memory = encdec.prefill(
            params, batch["tokens"], batch["frame_embeds"], cache, cfg)
        return logits, cache, {"memory": memory}
    logits, new_cache = lm.prefill(params, batch["tokens"], cache, cfg,
                                   prefix_embeds=batch.get("prefix_embeds"))
    return logits, new_cache, {}


def decode_step(params, batch: Dict[str, Any], cache, pos: int,
                cfg: ModelConfig):
    if is_encdec(cfg):
        return encdec.decode_step(params, batch["tokens"], batch["memory"],
                                  cache, pos, cfg)
    return lm.decode_step(params, batch["tokens"], cache, pos, cfg)
