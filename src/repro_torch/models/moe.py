"""Mixture-of-Experts FFN, ported from ``repro.models.moe``: the dropless
reference path (the default, ``cfg.moe_dropless``) and the sort-based
capacity dispatch.

* Dropless: every routed token-slot contributes, so a token's output
  depends only on its own row (forward ≡ prefill + decode, and the result
  does not depend on what else shares the batch).  The experts run one
  after another over all tokens, where the reference forms (T, E, F)
  intermediates in one einsum: each expert's products are the same, and
  the gate-weighted sum over experts is taken in float32 and rounded
  once, as the reference's bf16 einsum takes it.
* Capacity: token-slots sorted by expert (a stable argsort), clipped to
  ``capacity`` slots an expert, the experts batched over an (E, C, D)
  buffer, and a gate-weighted scatter-add back to the tokens.  Slots past
  an expert's capacity are dropped, as the reference's ``mode="drop"``
  scatter drops them: they are written to a dump row past the buffer's
  end that is sliced off, so every shape is static (the dry run traces
  this path on fake tensors).
* Shared experts (deepseek-moe) are one fused dense swiglu of hidden
  ``num_shared_experts * moe_d_ff``, added to the routed output.

``route`` breaks ties between equal router probabilities toward the lower
expert id, as ``jax.lax.top_k`` does (a stable descending sort;
``torch.topk`` promises no order among ties).

On a mesh (DTensor activations) the routing and the capacity path's
dispatch and combine, index work on the token slots, run whole on every
rank (``sharding.logical.local_call`` with replicated arguments): the
counterpart of the reference's unconstrained dispatch, which it leaves
to SPMD propagation.  The expert GEMMs run on the sharded buffer,
expert-parallel, and with ``moe_cap_shard`` the buffer is pinned
(EXPERT, CAPACITY, ACT_EMBED) as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    specs = {
        "router": ParamSpec((d, e), (L.EMBED, L.EXPERT)),
        "wi_gate": ParamSpec((e, d, f), (L.EXPERT, L.EMBED, None)),
        "wi_up": ParamSpec((e, d, f), (L.EXPERT, L.EMBED, None)),
        "wo": ParamSpec((e, f, d), (L.EXPERT, None, L.EMBED)),
    }
    if cfg.num_shared_experts:
        specs["shared"] = layers.ffn_specs(
            d, cfg.num_shared_experts * f, "swiglu")
    return specs


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)     # round up to 8, as the reference does


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(params: dict, xt: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gate_weights (T,K), expert_ids (T,K), aux_loss scalar)."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_ids = top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Load-balancing aux loss (Switch-style): E * sum(frac_tokens * frac_prob)
    e = cfg.num_experts
    onehot = torch.nn.functional.one_hot(expert_ids[:, 0], e).float()
    frac_tokens = onehot.mean(0)
    frac_probs = probs.mean(0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return gate, expert_ids, aux


def _swiglu_expert(params: dict, xt: torch.Tensor, i, rules=None,
                   cap_ax=None) -> torch.Tensor:
    """Expert ``i``'s swiglu on (..., D) rows (``i`` indexes the stacked
    expert axis: an int, or a slice for the batched capacity buffer,
    whose hidden activations ``rules`` pin)."""
    dt = xt.dtype
    gate_h = xt @ params["wi_gate"][i].to(dt)
    up_h = xt @ params["wi_up"][i].to(dt)
    h = layers.silu(gate_h) * up_h
    if rules is not None:
        h = L.constrain(h, rules, (L.EXPERT, cap_ax, None))
    return h @ params["wo"][i].to(dt)


def _combine_weights(router: torch.Tensor, xt: torch.Tensor,
                     cfg: ModelConfig):
    """(T, E) gate mass each token sends to each expert, and the aux loss
    (top-k ids are distinct, so the scatter-add never collides per row)."""
    gate, expert_ids, aux = route({"router": router}, xt, cfg)
    w = torch.zeros((xt.shape[0], cfg.num_experts), dtype=xt.dtype,
                    device=xt.device)
    w.scatter_add_(1, expert_ids, gate.to(xt.dtype))
    return w, aux


def _apply_moe_dropless(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dropless MoE: dense per-expert compute, gate-masked combine."""
    b, s, d = x.shape
    t = b * s
    dt = x.dtype

    xt = L.constrain(x.reshape(t, d), rules, (L.BATCH, L.ACT_EMBED))
    w, aux = L.local_call(
        lambda r, xs: _combine_weights(r, xs, cfg),
        [(params["router"], None), (xt, None)], [None, None], rules)

    y = L.replicated_like(torch.zeros((t, d), dtype=torch.float32,
                                      device=L.local_device(x)), x)
    for i in range(cfg.num_experts):
        y += _swiglu_expert(params, xt, i).float() * w[:, i, None].float()

    y = L.constrain(y.to(dt), rules, (L.BATCH, L.ACT_EMBED))
    out = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        out = out + layers.apply_ffn(params["shared"], x, "swiglu", rules)
    return L.constrain(out, rules, (L.BATCH, L.SEQ, L.ACT_EMBED)), aux


def _dispatch(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """Route the token slots, sort them by expert and clip each expert to
    its capacity -> (the (E, C, D) buffer, aux loss, and the combine's
    indices: kept, destination row, token, and gate of each sorted
    slot).  Static shapes: an over-capacity slot is written to a dump
    row past the buffer's end, which is sliced off."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(t, cfg)
    dt = xt.dtype
    gate, expert_ids, aux = route({"router": router}, xt, cfg)

    flat_e = expert_ids.reshape(t * k)
    flat_gate = gate.reshape(t * k).to(dt)

    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.zeros(e, dtype=flat_e.dtype, device=xt.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, 0) - counts         # (E,)
    pos_in_expert = torch.arange(t * k, device=xt.device) - seg_start[sorted_e]
    keep = pos_in_expert < c
    token_idx = sort_idx // k                            # sorted-slot -> token
    dest = torch.where(keep, sorted_e * c + pos_in_expert, e * c)

    buf = torch.zeros((e * c + 1, d), dtype=dt, device=xt.device)
    buf[dest] = xt[token_idx]                # over-capacity: the dump row
    return (buf[:e * c].reshape(e, c, d), aux, keep, dest, token_idx,
            flat_gate[sort_idx])


def _combine(out_e: torch.Tensor, keep, dest, token_idx, slot_gate,
             t: int) -> torch.Tensor:
    """Gather the experts' rows back to the token slots, weight them by
    their gates and scatter-add them onto the tokens; dropped slots add
    zero."""
    e, c, d = out_e.shape
    gathered = torch.where(keep[:, None],
                           out_e.reshape(e * c, d)[dest.clamp(max=e * c - 1)],
                           torch.zeros((), dtype=out_e.dtype,
                                       device=out_e.device))
    contrib = gathered * slot_gate[:, None]
    y = torch.zeros((t, d), dtype=out_e.dtype, device=out_e.device)
    y.index_add_(0, token_idx, contrib)
    return y


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, rules=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss)."""
    if cfg.moe_dropless:
        return _apply_moe_dropless(params, x, cfg, rules)
    b, s, d = x.shape
    t = b * s
    if not cfg.moe_cap_shard:
        # unconstrained dispatch, as the reference's default (v1) path
        rules = None

    xt = L.constrain(x.reshape(t, d), rules, (L.BATCH, L.ACT_EMBED))
    # --- dispatch: sort token-slots by expert, clip to capacity ------------
    buf, aux, keep, dest, token_idx, slot_gate = L.local_call(
        lambda r, xs: _dispatch(r, xs, cfg),
        [(params["router"], None), (xt, None)], [None] * 6, rules)
    cap_ax = L.CAPACITY if cfg.moe_cap_shard else None
    buf = L.constrain(buf, rules, (L.EXPERT, cap_ax, L.ACT_EMBED))

    # --- expert FFN (batched swiglu over the expert axis) ------------------
    out_e = _swiglu_expert(params, buf, slice(None), rules, cap_ax)
    out_e = L.constrain(out_e, rules, (L.EXPERT, cap_ax, L.ACT_EMBED))

    # --- combine: gather back to token slots, weight, scatter-add ----------
    y = L.local_call(
        lambda *a: _combine(*a, t),
        [(out_e, None), (keep, None), (dest, None), (token_idx, None),
         (slot_gate, None)], [None], rules)
    y = L.constrain(y, rules, (L.BATCH, L.ACT_EMBED))

    out = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        out = out + layers.apply_ffn(params["shared"], x, "swiglu", rules)
    return L.constrain(out, rules, (L.BATCH, L.SEQ, L.ACT_EMBED)), aux
