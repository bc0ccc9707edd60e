"""AdamW with mixed precision and optional int8-compressed moments,
ported from ``repro.optim.adamw``.

The arithmetic is the reference's, in float32 and in its order: the step
is cast to float32 and ``beta ** step`` is a float32 power; the schedule's
Python constants are rounded to float32 as jax's weakly typed constants
are; decay applies to leaves with ``ndim > 1`` only (with stacked layers
that includes norm scales and biases, as in the reference); the global
norm adds each leaf's float32 sum of squares in ``jax.tree`` order.

The second-moment compression reuses the quant_cast codec: a CUDA state
launches the kernel once per ``v`` leaf, a CPU state goes through its
plain version (``kernels.quant_cast.ops``).  Functional API: the state is
a tree aligned with the params, ``{"m", "v", "step"}``, ``step`` an int32
0-d tensor.  DTensor params on a mesh get moments placed as they are and
a replicated ``step``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch._tree import (tree_flatten, tree_flatten_up_to, tree_leaves,
                               tree_map, tree_unflatten)
from repro_torch.sharding import logical as L

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # cosine | constant


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor) as a float32 0-d
    tensor: linear warmup, then cosine down to a tenth."""
    step = torch.as_tensor(step).to(_F32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.learning_rate * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def init_state(params) -> dict:
    first = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=_F32)
    step = torch.zeros((), dtype=torch.int32, device=L.local_device(first))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": L.replicated_like(step, first)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the Python sum, over the leaves in tree order, of each
    leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(_F32)))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    # a true division (a Python number over a tensor would multiply by
    # the tensor's reciprocal)
    scale = torch.clamp(torch.div(torch.tensor(max_norm, dtype=_F32,
                                               device=norm.device),
                                  norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def apply_updates(cfg: AdamWConfig, params, grads, state
                  ) -> Tuple[Any, dict]:
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.to(_F32)
    # 1 - beta ** step, a float32 power of the float32-rounded beta
    dev = L.local_device(step)
    bc1 = 1 - torch.pow(L.replicated_like(
        torch.tensor(b1, dtype=_F32, device=dev), step), step_f)
    bc2 = 1 - torch.pow(L.replicated_like(
        torch.tensor(b2, dtype=_F32, device=dev), step), step_f)

    def upd(p, g, m, v):
        g = g.to(_F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(_F32)
        if p.dim() > 1:
            delta = delta + cfg.weight_decay * p32
        new_p = p32 - lr * delta
        return new_p.to(p.dtype), m, v

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten_up_to(treedef, grads)
    flat_m = tree_flatten_up_to(treedef, state["m"])
    flat_v = tree_flatten_up_to(treedef, state["v"])
    out = [upd(p, g, m, v)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_params = tree_unflatten(treedef, [o[0] for o in out])
    new_state = {"m": tree_unflatten(treedef, [o[1] for o in out]),
                 "v": tree_unflatten(treedef, [o[2] for o in out]),
                 "step": step}
    return new_params, new_state


def compress_moments_int8(state: dict) -> dict:
    """int8-quantize the second moment (gradient-statistics compression
    for checkpoint traffic): each ``v`` leaf becomes a page
    ``{"q", "scale", "shape"}``; the inverse is
    ``decompress_moments_int8``."""
    from repro_torch.kernels.quant_cast import ops as qops

    def q(leaf):
        qv, sc = qops.quantize(leaf)
        return {"q": qv, "scale": sc, "shape": tuple(leaf.shape)}

    return {**state, "v": tree_map(q, state["v"])}


def decompress_moments_int8(state: dict) -> dict:
    from repro_torch.kernels.quant_cast import ops as qops
    return {**state, "v": _map_pages(
        lambda d: qops.dequantize(d["q"], d["scale"], d["shape"]),
        state["v"])}


def _map_pages(fn, tree):
    """``fn`` of each page ``{"q", "scale", "shape"}`` of a compressed
    moment tree, in tree order, the tree's structure kept."""
    if isinstance(tree, dict) and "q" in tree:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_pages(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_pages(fn, x) for x in tree)
    raise TypeError(f"not a compressed moment tree: {type(tree)}")
