"""Architecture registry, ported from ``repro.models.registry``: maps arch
ids to configs and provides the uniform batch-dict model API of the
serve path and the ml island.

Batch dicts:
  forward: {tokens (B,S_text) int32 [, prefix_embeds (B,P,D) f32]
            [, frame_embeds (B,S_src,D) f32]}
  prefill: {tokens (B,S)} (+ prefix_embeds / frame_embeds) + cache tree
  decode:  {tokens (B,1)} + cache tree + pos
            (+ memory (B,S_src,D) for enc-dec)
  train:   the forward batch + labels (B,S_text) int32

Every arch of the pool runs: the decoder-only families (dense, moe, ssm,
hybrid, vlm) through ``lm`` and the encoder-decoder one
(seamless-m4t-medium) through ``encdec``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import _device
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L

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


def forward(params, batch: Dict[str, Any], cfg: ModelConfig, rules=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_encdec(cfg):
        return encdec.forward(params, batch["tokens"],
                              batch["frame_embeds"], cfg, rules)
    return lm.forward(params, batch["tokens"], cfg, rules,
                      prefix_embeds=batch.get("prefix_embeds"))


def prefill(params, batch: Dict[str, Any], cache, cfg: ModelConfig,
            rules=None):
    """Returns (last-token logits, cache, extras-dict); an enc-dec arch's
    extras hold the encoder ``memory`` that every decode step reads."""
    if is_encdec(cfg):
        logits, cache, memory = encdec.prefill(
            params, batch["tokens"], batch["frame_embeds"], cache, cfg,
            rules)
        return logits, cache, {"memory": memory}
    logits, new_cache = lm.prefill(params, batch["tokens"], cache, cfg,
                                   rules,
                                   prefix_embeds=batch.get("prefix_embeds"))
    return logits, new_cache, {}


def decode_step(params, batch: Dict[str, Any], cache, pos: int,
                cfg: ModelConfig, rules=None):
    if is_encdec(cfg):
        return encdec.decode_step(params, batch["tokens"], batch["memory"],
                                  cache, pos, cfg, rules)
    return lm.decode_step(params, batch["tokens"], cache, pos, cfg, rules)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, aux: torch.Tensor,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token CE over the last S_text positions (+ MoE aux loss), the
    log-softmax in float32.  Logits sharded over the vocab (a DTensor)
    take the log-sum-exp and the labels' logits shard by shard
    (``_sharded_nll``)."""
    s_text = labels.shape[1]
    logits = logits[:, -s_text:]
    if L.is_dtensor(logits):
        nll = _sharded_nll(logits.to(torch.float32), labels)
    else:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return nll.mean() + aux_weight * aux


def _sharded_nll(x, labels):
    """-log softmax(x)[label] for DTensor logits ``x`` (B, S, V), whose
    vocab may be sharded: the log-sum-exp reduces over the shards, and
    each rank takes the labels' logits that fall in its shard (zeros for
    the others) into a partial sum, so that no rank holds the whole
    vocab's logits or their gradient."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    m = x.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(-1)) + m[..., 0]
    mesh = x.device_mesh
    vocab = [d for d, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == 2]
    lab_pl = [Replicate() if d in vocab else p
              for d, p in enumerate(x.placements)]
    lab = L.replicated_like(labels, x).redistribute(mesh, lab_pl)
    lab = lab.to_local().long()
    local = x.to_local()
    off, n = L.shard_span(x, 2)
    held = (lab >= off) & (lab < off + n)
    picked = torch.gather(local, -1, torch.where(held, lab - off, 0)[
        ..., None])[..., 0] * held
    target = L.partial_sum(picked, mesh, [Partial() if d in vocab else p
                                          for d, p in enumerate(lab_pl)])
    return lse - target


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions for a cell's total sequence length."""
    if cfg.frontend == "vision":
        return seq_len - cfg.num_prefix_embeds
    return seq_len


def make_train_batch(cfg: ModelConfig, seq_len: int, batch: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Dict[str, Any]:
    """Materialized random batch on ``device`` (the GPU unless the caller
    names one), drawn from ``generator`` (seed 0 when None).  The draws
    are torch's: parity tests build their batches with numpy and feed the
    same arrays to both packages."""
    device = _device.resolve(device, "make_train_batch")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    st = text_len(cfg, seq_len)

    def ints():
        return torch.randint(0, cfg.vocab_size, (batch, st),
                             generator=generator, device=generator.device,
                             dtype=torch.int32).to(device)

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device,
                           dtype=torch.float32).to(device)

    out = {"tokens": ints(), "labels": ints()}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model))
    if cfg.frontend == "audio":
        out["frame_embeds"] = normal(
            (batch, max(1, seq_len // cfg.src_ratio), cfg.d_model))
    return out
