"""Sharding plans for every (arch x shape) cell, ported from
``repro.launch.specs``: meta-tensor stand-ins for every model input
(``torch.empty(..., device="meta")``: shaped and typed, nothing
allocated) and the matching trees of partitions
(``sharding.logical.PartitionSpec``, one entry per tensor dim), with the
reference's keys.  ``sharding.logical.placements`` turns a partition into
DTensor placements on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import P


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def pick_rules(cfg: ModelConfig, mesh, *,
               seq_parallel: Optional[bool] = None,
               shard_kv_seq: Optional[bool] = None) -> L.AxisRules:
    """Arch-aware rule selection: KV-cache sharding axis is heads when they
    divide the model axis, else cache-sequence; SP on for big d_model."""
    model_size = L.mesh_shape(mesh)["model"]
    if shard_kv_seq is None:
        shard_kv_seq = (cfg.num_kv_heads == 0
                        or cfg.num_kv_heads % model_size != 0)
    if seq_parallel is None:
        seq_parallel = cfg.d_model * cfg.num_layers >= 4096 * 28
    return L.default_rules(mesh, shard_kv_seq=shard_kv_seq,
                           seq_parallel=seq_parallel)


def _batch_axes(mesh, batch_dim: Optional[int] = None):
    sizes = L.mesh_shape(mesh)
    axes = ("pod", "data") if "pod" in sizes else ("data",)
    if batch_dim is not None:
        size = 1
        for a in axes:
            size *= sizes[a]
        if batch_dim % size != 0:
            # long_500k-style tiny batches: fall back to replication
            return None
    return axes if len(axes) > 1 else axes[0]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(structs, partitions) for a training batch dict."""
    b = shape.global_batch
    st = registry.text_len(cfg, shape.seq_len)
    ba = _batch_axes(mesh, b)
    structs: Dict[str, Any] = {
        "tokens": _meta((b, st), torch.int32),
        "labels": _meta((b, st), torch.int32),
    }
    shards: Dict[str, Any] = {"tokens": P(ba, None), "labels": P(ba, None)}
    if cfg.frontend == "vision":
        structs["prefix_embeds"] = _meta(
            (b, cfg.num_prefix_embeds, cfg.d_model), torch.float32)
        shards["prefix_embeds"] = P(ba, None, None)
    if cfg.frontend == "audio":
        structs["frame_embeds"] = _meta(
            (b, max(1, shape.seq_len // cfg.src_ratio), cfg.d_model),
            torch.float32)
        shards["frame_embeds"] = P(ba, None, None)
    return structs, shards


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    b = shape.global_batch
    ba = _batch_axes(mesh, b)
    structs: Dict[str, Any] = {"tokens": _meta((b, 1), torch.int32)}
    shards: Dict[str, Any] = {"tokens": P(ba, None)}
    if registry.is_encdec(cfg):
        src = max(1, shape.seq_len // cfg.src_ratio)
        structs["memory"] = _meta((b, src, cfg.d_model), torch.bfloat16)
        shards["memory"] = P(ba, None, None)
    return structs, shards


def param_structs_and_shardings(cfg: ModelConfig, mesh,
                                rules: L.AxisRules, *, dtype=None):
    specs = registry.param_specs(cfg)
    if dtype is not None:
        specs = _tree.tree_map(
            lambda s: dataclasses.replace(s, dtype=dtype), specs)
    structs = L.spec_tree_structs(specs)
    shardings = L.spec_tree_shardings(specs, mesh, rules)
    return specs, structs, shardings


def train_state_specs(cfg: ModelConfig, mesh, rules: L.AxisRules):
    """(structs, partitions) for the {"params", "opt"} train state."""
    specs, p_structs, p_shards = param_structs_and_shardings(
        cfg, mesh, rules)
    m_structs = _tree.tree_map(lambda s: _meta(s.shape, torch.float32),
                               p_structs)
    structs = {
        "params": p_structs,
        "opt": {"m": m_structs, "v": m_structs,
                "step": _meta((), torch.int32)},
    }
    shardings = {
        "params": p_shards,
        "opt": {"m": p_shards, "v": p_shards, "step": P()},
    }
    return structs, shardings


def cache_structs_and_shardings(cfg: ModelConfig, shape: ShapeConfig,
                                mesh, rules: L.AxisRules):
    specs = registry.cache_specs(cfg, shape.global_batch, shape.seq_len)
    return (L.spec_tree_structs(specs),
            L.spec_tree_shardings(specs, mesh, rules))
