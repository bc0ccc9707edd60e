"""Shared building blocks for the model zoo, ported from
``repro.models.layers``: norms, embeddings, rotary, feed-forward
variants.  Plain functions over dicts of tensors described by
``ParamSpec`` (sharding/logical.py).

Every weight is cast to the activations' dtype where it is used
(``.to(dt)``), as the reference casts it; a weight already in that dtype
passes through, which is what lets ``serve.engine.ServeSession`` cast
once when it is built.  Norm scales are read in float32.

Elementwise math in bfloat16 follows XLA's rounding: every HLO op of the
reference (``jax.nn.silu`` is ``x * 1/(1 + exp(-x))``, five ops) rounds
its result to bfloat16, and a Python constant is rounded to the array's
dtype first (``weak``), where a fused torch op would round once and keep
the constant in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch import _tree
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import ParamSpec


def weak(c: float, dtype: torch.dtype) -> float:
    """A Python constant as jax's weak typing sees it next to an array of
    ``dtype``: rounded to that dtype."""
    return float(torch.tensor(c, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``, which XLA expands in the
    array's dtype), op by op: neg, exp, add, divide."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, op by op: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation), op by op."""
    dt = x.dtype
    inner = x + weak(0.044715, dt) * (x * (x * x))
    cdf = 0.5 * (1.0 + torch.tanh(weak((2 / math.pi) ** 0.5, dt) * inner))
    return x * cdf


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------
def norm_specs(d_model: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d_model,), (L.EMBED,), init="ones")}
    if kind == "layernorm":
        return {"scale": ParamSpec((d_model,), (L.EMBED,), init="ones"),
                "bias": ParamSpec((d_model,), (L.EMBED,), init="zeros")}
    raise ValueError(kind)


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        var = x.square().mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + eps)
        out = x * params["scale"].float()
    elif kind == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        x = (x - mean) * torch.rsqrt(var + eps)
        out = x * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_specs(vocab: int, d_model: int, tie: bool) -> dict:
    specs = {"embedding": ParamSpec((vocab, d_model), (L.VOCAB, L.EMBED),
                                    init="embed_normal")}
    if not tie:
        specs["unembed"] = ParamSpec((d_model, vocab), (L.EMBED, L.VOCAB),
                                     init="normal")
    return specs


def embed_tokens(params: dict, tokens: torch.Tensor,
                 compute_dtype: torch.dtype, rules=None) -> torch.Tensor:
    # gathering rows, then casting them, gives the bits of casting the
    # whole table first (as the reference does) at a fraction of the work
    table = params["embedding"]
    if L.is_dtensor(table):
        x = _sharded_rows(table, tokens)
    else:
        x = table[tokens.long()]
    return L.constrain(x.to(compute_dtype), rules,
                       (L.BATCH, L.SEQ, L.ACT_EMBED))


def _sharded_rows(table, tokens):
    """``table[tokens]`` for a DTensor table whose rows (the vocab) may be
    sharded: the table is gathered along its other dims, and each rank
    takes the rows it holds, zeros for the others, into a partial sum
    over the vocab's mesh dims (one rank adds each row, the rest add
    zeros)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [m for m, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    tokens = L.replicated_like(tokens, table)
    tok_pl = [Replicate() if m in vocab else p
              for m, p in enumerate(tokens.placements)]
    # the rows a rank takes are its own tokens': along a mesh dim that
    # splits the tokens, the table's gradient is a partial sum
    local = table.redistribute(
        mesh, [Shard(0) if m in vocab else Replicate()
               for m in range(mesh.ndim)]).to_local(grad_placements=[
                   Shard(0) if m in vocab else
                   Partial() if isinstance(tok_pl[m], Shard) else Replicate()
                   for m in range(mesh.ndim)])
    tk = tokens.redistribute(mesh, tok_pl).to_local().long()
    off, n = L.shard_span(table, 0)
    held = (tk >= off) & (tk < off + n)
    rows = local[torch.where(held, tk - off, 0)] * held[..., None]
    return L.partial_sum(rows, mesh, [Partial() if m in vocab else p
                                      for m, p in enumerate(tok_pl)])


def logits_out(params: dict, x: torch.Tensor, softcap: float = 0.0,
               rules=None) -> torch.Tensor:
    if "unembed" in params:
        logits = x @ params["unembed"].to(x.dtype)
    else:
        logits = x @ params["embedding"].to(x.dtype).t()
    logits = logits.float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return L.constrain(logits, rules, (L.BATCH, L.SEQ, L.VOCAB))


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)          # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = L.replicated_like(rope_frequencies(head_dim, theta, x.device),
                              x)                          # (Dh/2,)
    angles = positions[..., None].float() * freqs         # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense feed-forward variants
# ---------------------------------------------------------------------------
def ffn_specs(d_model: int, d_ff: int, kind: str) -> dict:
    if kind == "swiglu":
        return {
            "wi_gate": ParamSpec((d_model, d_ff), (L.EMBED, L.MLP)),
            "wi_up": ParamSpec((d_model, d_ff), (L.EMBED, L.MLP)),
            "wo": ParamSpec((d_ff, d_model), (L.MLP, L.EMBED)),
        }
    if kind == "gelu":
        return {
            "wi": ParamSpec((d_model, d_ff), (L.EMBED, L.MLP)),
            "bi": ParamSpec((d_ff,), (L.MLP,), init="zeros"),
            "wo": ParamSpec((d_ff, d_model), (L.MLP, L.EMBED)),
            "bo": ParamSpec((d_model,), (L.EMBED,), init="zeros"),
        }
    raise ValueError(kind)


def apply_ffn(params: dict, x: torch.Tensor, kind: str,
              rules=None) -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        gate = x @ params["wi_gate"].to(dt)
        up = x @ params["wi_up"].to(dt)
        h = L.constrain(silu(gate) * up, rules, (L.BATCH, L.SEQ, L.MLP))
        out = h @ params["wo"].to(dt)
    elif kind == "gelu":
        h = x @ params["wi"].to(dt)
        h = gelu_tanh(h + params["bi"].to(dt))
        h = L.constrain(h, rules, (L.BATCH, L.SEQ, L.MLP))
        out = h @ params["wo"].to(dt) + params["bo"].to(dt)
    else:
        raise ValueError(kind)
    return L.constrain(out, rules, (L.BATCH, L.SEQ, L.ACT_EMBED))


# ---------------------------------------------------------------------------
# Tree utilities for stacked layers
# ---------------------------------------------------------------------------
def stack_specs(spec_tree, n: int):
    """Prepend a LAYER axis of size n to every ParamSpec in a tree."""
    def _stack(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + s.shape, (L.LAYER,) + s.axes, dtype=s.dtype,
                         init=s.init, init_scale=s.init_scale)
    return _tree.tree_map(_stack, spec_tree)
