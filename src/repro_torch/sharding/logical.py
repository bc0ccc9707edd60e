"""Logical axis names and declarative parameter specs, ported from
``repro.sharding.logical``: every parameter is labelled with logical axis
names, so that the parameter trees of the two packages carry the same
description leaf for leaf.

The port runs on one device, so there is no mesh, no rules table and no
``constrain``: a ``torch.distributed`` placement planner is ROADMAP.md
item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import _tree

# ---------------------------------------------------------------------------
# Canonical logical axis names used throughout the model zoo.
# ---------------------------------------------------------------------------
BATCH = "batch"            # global batch
SEQ = "seq"                # sequence (activations)
RESID = "resid_seq"        # block-boundary residual
KV_SEQ = "kv_seq"          # KV-cache sequence
EMBED = "embed"            # d_model (PARAMS)
ACT_EMBED = "act_embed"    # d_model (ACTIVATIONS)
HEADS = "heads"            # q heads
KV_HEADS = "kv_heads"      # kv heads
HEAD_DIM = "head_dim"      # per-head dim
MLP = "mlp"                # ffn hidden
VOCAB = "vocab"            # vocab rows
EXPERT = "expert"          # MoE experts
CAPACITY = "capacity"      # MoE per-expert capacity
LAYER = "layer"            # stacked layer axis
STATE = "state"            # SSM state dim
CONV = "conv"              # conv kernel width


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape, dtype, logical axes and initializer of one parameter."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"      # normal | zeros | ones | embed_normal
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")

    def num_params(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def count_params(spec_tree) -> int:
    return sum(leaf.num_params() for leaf in _tree.tree_leaves(spec_tree))


def _init_one(generator: torch.Generator, spec: ParamSpec,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.init_scale / max(1.0, float(fan_in)) ** 0.5
    elif spec.init == "embed_normal":
        scale = spec.init_scale * 0.02
    else:
        raise ValueError(f"unknown init {spec.init}")
    z = torch.randn(spec.shape, generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (scale * z).to(device=device, dtype=spec.dtype)


def init_params(generator: torch.Generator, spec_tree, device) -> Any:
    """Materialize a ParamSpec tree into tensors on ``device``, drawing
    each leaf in turn (``jax.tree`` order) from ``generator``.  The
    draws are torch's, not ``jax.random``'s: the same seed gives other
    numbers than the JAX package, so parity tests carry the JAX
    package's parameters across (``models.convert``)."""
    leaves, treedef = _tree.tree_flatten(spec_tree)
    return _tree.tree_unflatten(
        treedef, [_init_one(generator, s, device) for s in leaves])
