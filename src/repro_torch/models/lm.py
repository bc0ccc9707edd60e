"""Unified decoder-only language model, ported from ``repro.models.lm``:
the dense, moe, ssm (RWKV6), hybrid (Jamba: Mamba + attention, MoE) and
vlm families, with the parallel block, the leading dense layers
(``first_k_dense``), QK-norm, the logit softcap and the vision stub's
``prefix_embeds``.

Parameters keep the reference's stacked layout (``blocks`` holds every
scanned period's leaves with a leading LAYER axis), so the parameter
trees of the two packages flatten alike; the reference's ``lax.scan``
over that axis is a Python loop here.  ``forward`` returns the MoE
auxiliary loss summed over the layers in the reference's order (zero for
the families without MoE).

Three entry points:
  forward(...)       — full-sequence forward -> (logits, aux)
  prefill(...)       — full-sequence forward that also fills the caches
  decode_step(...)   — one-token step against the caches (serve path)

Caches are written in place (see ``attention``, ``rwkv6`` and ``mamba``).

Every entry point takes ``rules`` (``sharding.logical.AxisRules``): with
DTensor parameters and inputs on a mesh, the activations are pinned at
the reference's constraint sites; with plain tensors, or ``rules`` None,
nothing changes.  Block remat: with ``cfg.remat`` "block" or "full" and
gradients on, each stacked period runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the reference
wraps its scan body in ``jax.checkpoint``; the gradients are the same
bits.  ``cfg.scan_layers`` changes nothing here: the layers are a loop
either way.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch.models import attention, layers, mamba, moe, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L

COMPUTE_DTYPE = torch.bfloat16          # activations; params stay f32
# the parameter subtrees the model reads in float32; every other leaf is
# cast to COMPUTE_DTYPE where it is used, so a caller may cast those once
# ahead of time (``serve.engine.place_params``).  A mixer or FFN that
# reads another leaf in float32 names it here.
FLOAT32_LEAVES = frozenset({
    "ln1", "ln2", "final_norm",                    # norm scales and biases
    "ln_x", "enc_norm",                            # (enc-dec's own norms)
    "q_norm", "k_norm",                            # QK-norm (attention)
    "w0", "w_lora_a", "w_lora_b", "u",             # RWKV6 decay and bonus
    "ln_scale", "ln_bias",                         # RWKV6 group norm
    "a_log", "dt_norm", "b_norm", "c_norm",        # Mamba decay, dt/B/C norms
    "router",                                      # MoE routing logits
})


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _mixer_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "attn":
        return attention.attn_specs(cfg)
    if kind == "rwkv6":
        return rwkv6.time_mix_specs(cfg)
    if kind == "mamba":
        return mamba.mamba_specs(cfg)
    raise ValueError(kind)


def _ffn_specs(cfg: ModelConfig, kind: str, *, dense_ff: int = 0) -> dict:
    if kind == "dense":
        return layers.ffn_specs(cfg.d_model, dense_ff or cfg.d_ff,
                                cfg.mlp_kind)
    if kind == "moe":
        return moe.moe_specs(cfg)
    if kind == "rwkv_cm":
        return rwkv6.channel_mix_specs(cfg)
    raise ValueError(kind)


def _sub_specs(cfg: ModelConfig, mixer_kind: str, ffn_kind: str,
               dense_ff: int = 0) -> dict:
    sub = {
        "mixer": _mixer_specs(cfg, mixer_kind),
        "ffn": _ffn_specs(cfg, ffn_kind, dense_ff=dense_ff),
        "ln1": layers.norm_specs(cfg.d_model, cfg.norm_kind),
    }
    if not cfg.parallel_block:
        sub["ln2"] = layers.norm_specs(cfg.d_model, cfg.norm_kind)
    return sub


def param_specs(cfg: ModelConfig) -> dict:
    plan = cfg.layer_plan()
    specs: Dict[str, Any] = {
        "embed": layers.embed_specs(cfg.padded_vocab, cfg.d_model,
                                    cfg.tie_embeddings),
        "final_norm": layers.norm_specs(cfg.d_model, cfg.norm_kind),
    }
    # prologue: leading dense layers outside the stack (deepseek-moe)
    for j in range(cfg.first_k_dense):
        specs[f"prologue{j}"] = _sub_specs(cfg, "attn", "dense",
                                           dense_ff=cfg.dense_d_ff)
    block = {f"sub{i}": _sub_specs(cfg, mk, fk)
             for i, (mk, fk) in enumerate(plan)}
    specs["blocks"] = layers.stack_specs(block, cfg.num_scanned())
    return specs


# ---------------------------------------------------------------------------
# Cache specs (serve path)
# ---------------------------------------------------------------------------
def _sub_cache_specs(cfg: ModelConfig, mixer_kind: str, ffn_kind: str,
                     batch: int, cache_len: int) -> dict:
    out: Dict[str, Any] = {}
    if mixer_kind == "attn":
        out["kv"] = attention.kv_cache_specs(cfg, batch, cache_len)
    elif mixer_kind == "rwkv6":
        out["time"] = rwkv6.init_time_state(cfg, batch)
    elif mixer_kind == "mamba":
        out["ssm"] = mamba.init_mamba_state(cfg, batch)
    if ffn_kind == "rwkv_cm":
        out["channel"] = rwkv6.init_channel_state(cfg, batch)
    return out


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    plan = cfg.layer_plan()
    specs: Dict[str, Any] = {}
    for j in range(cfg.first_k_dense):
        specs[f"prologue{j}"] = _sub_cache_specs(cfg, "attn", "dense",
                                                 batch, cache_len)
    block = {f"sub{i}": _sub_cache_specs(cfg, mk, fk, batch, cache_len)
             for i, (mk, fk) in enumerate(plan)}
    specs["blocks"] = layers.stack_specs(block, cfg.num_scanned())
    return specs


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    return _tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_specs(cfg, batch, cache_len))


# ---------------------------------------------------------------------------
# Sub-layer application (caches are written in place, so nothing returns
# them but the entry points)
# ---------------------------------------------------------------------------
def _apply_mixer(params, x, kind, cfg, rules, *, cache=None, pos=None,
                 mode="train"):
    """The mixer's output; ``cache`` is the sub-layer's state dict or
    None (train mode reads and writes no state)."""
    if kind == "rwkv6":
        state = cache["time"] if mode != "train" else None
        return rwkv6.apply_time_mix(params, x, cfg, state, rules)[0]
    if kind == "mamba":
        state = cache["ssm"] if mode != "train" else None
        return mamba.apply_mamba(params, x, cfg, state, rules)[0]
    if kind != "attn":
        raise ValueError(kind)
    if mode == "train":
        return attention.self_attention(params, x, cfg, rules=rules)
    if mode == "prefill":
        s = x.shape[1]
        out = attention.self_attention(params, x, cfg, rules=rules)
        # fill the cache with this sequence's k/v (codec-aware); k and v
        # are projected a second time, as the reference does
        positions = L.replicated_like(
            torch.arange(s, device=L.local_device(x))[None, :], x)
        _, k, v = attention.project_qkv(params, x, cfg, positions,
                                        rules=rules)
        attention.write_kv(cache["kv"], k, v, 0, cfg)
        return out
    return attention.decode_attention(params, x, cache["kv"], pos, cfg,
                                      rules)[0]


def _apply_ffn(params, x, kind, cfg, rules, *, cache=None, mode="train"):
    """(the FFN's output, its auxiliary loss: a 0-d tensor or 0.0)."""
    if kind == "dense":
        return layers.apply_ffn(params, x, cfg.mlp_kind, rules), 0.0
    if kind == "moe":
        return moe.apply_moe(params, x, cfg, rules)
    if kind == "rwkv_cm":
        state = cache["channel"] if mode != "train" else None
        return rwkv6.apply_channel_mix(params, x, cfg, state, rules)[0], 0.0
    raise ValueError(kind)


def _apply_sub(sub_params, x, mixer_kind, ffn_kind, cfg, rules, *,
               cache=None, pos=None, mode="train"):
    """One (mixer + ffn) sub-layer with residuals -> (x, aux)."""
    h = layers.apply_norm(sub_params["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    attn_out = _apply_mixer(sub_params["mixer"], h, mixer_kind, cfg, rules,
                            cache=cache, pos=pos, mode=mode)
    if cfg.parallel_block:
        ffn_out, aux = _apply_ffn(sub_params["ffn"], h, ffn_kind, cfg, rules,
                                  cache=cache, mode=mode)
        return x + attn_out + ffn_out, aux
    x = x + attn_out
    h = layers.apply_norm(sub_params["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    ffn_out, aux = _apply_ffn(sub_params["ffn"], h, ffn_kind, cfg, rules,
                              cache=cache, mode=mode)
    return x + ffn_out, aux


# ---------------------------------------------------------------------------
# Full model passes
# ---------------------------------------------------------------------------
def _embed_inputs(params, tokens, rules=None, prefix_embeds=None):
    x = layers.embed_tokens(params["embed"], tokens, COMPUTE_DTYPE, rules)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(COMPUTE_DTYPE), x], dim=1)
        x = L.constrain(x, rules, (L.BATCH, L.SEQ, L.ACT_EMBED))
    return x


def remat_on(cfg: ModelConfig) -> bool:
    """Whether a period (a layer, for enc-dec) is recomputed in the
    backward pass: ``cfg.remat`` asks for it and gradients are on."""
    return cfg.remat in ("block", "full") and torch.is_grad_enabled()


def _run_period(block_p, block_c, x, plan, cfg, rules, pos, mode):
    """One stacked period (every sub-layer of the plan) -> (x, aux)."""
    aux_sum = L.replicated_like(
        torch.zeros((), dtype=torch.float32, device=L.local_device(x)), x)
    for n, (mixer_kind, ffn_kind) in enumerate(plan):
        x, aux = _apply_sub(block_p[f"sub{n}"], x, mixer_kind, ffn_kind,
                            cfg, rules,
                            cache=block_c[f"sub{n}"] if block_c else None,
                            pos=pos, mode=mode)
        # sequence-parallel residual: the saved carries are seq-sharded
        if mode == "train":
            x = L.constrain(x, rules, (L.BATCH, L.RESID, L.ACT_EMBED))
        aux_sum = aux_sum + aux
    return x, aux_sum


def _run_stack(params, x, cfg, rules=None, *, cache=None, pos=None,
               mode="train"):
    """Prologue layers then the stacked layers, in order; the cache's
    (stacked) tensors are written in place.  Returns (x, aux): the
    auxiliary losses summed a period at a time, then over the periods,
    as the reference's scan carries them."""
    plan = cfg.layer_plan()
    aux_total = L.replicated_like(
        torch.zeros((), dtype=torch.float32, device=L.local_device(x)), x)
    for j in range(cfg.first_k_dense):
        x, aux = _apply_sub(params[f"prologue{j}"], x, "attn", "dense", cfg,
                            rules,
                            cache=cache[f"prologue{j}"] if cache else None,
                            pos=pos, mode=mode)
        aux_total = aux_total + aux
    # each stacked parameter split once into its layers' views, so that
    # autograd stacks their gradients in one step rather than scattering
    # every layer's into a zero-filled copy of the whole stack
    flat_p, block_def = _tree.tree_flatten(params["blocks"])
    per_layer = [p.unbind(0) for p in flat_p]
    for i in range(cfg.num_scanned()):
        block_p = _tree.tree_unflatten(block_def, [u[i] for u in per_layer])
        # views of layer i: writes into a cache view land in the stack
        block_c = (_tree.tree_map(lambda c: c[i], cache["blocks"])
                   if cache else None)
        if remat_on(cfg):
            x, aux_sum = checkpoint(_run_period, block_p, block_c, x, plan,
                                    cfg, rules, pos, mode,
                                    use_reentrant=False)
        else:
            x, aux_sum = _run_period(block_p, block_c, x, plan, cfg, rules,
                                     pos, mode)
        aux_total = aux_total + aux_sum
    return x, aux_total


def forward(params, tokens, cfg: ModelConfig, rules=None,
            prefix_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: tokens (B,S_text) -> (logits (B,S,V) f32, aux_loss)."""
    x = _embed_inputs(params, tokens, rules, prefix_embeds)
    x, aux = _run_stack(params, x, cfg, rules, mode="train")
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind,
                          cfg.norm_eps)
    logits = layers.logits_out(params["embed"], x, cfg.logit_softcap, rules)
    return logits, aux


def prefill(params, tokens, cache, cfg: ModelConfig, rules=None,
            prefix_embeds=None):
    """Fill caches for positions [0, S), in place. Returns (last-token
    logits, cache)."""
    x = _embed_inputs(params, tokens, rules, prefix_embeds)
    x, _ = _run_stack(params, x, cfg, rules, cache=cache, mode="prefill")
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm_kind,
                          cfg.norm_eps)
    logits = layers.logits_out(params["embed"], x, cfg.logit_softcap, rules)
    return logits, cache


def decode_step(params, tokens, cache, pos: int, cfg: ModelConfig,
                rules=None):
    """One-token decode. tokens: (B,1); pos: cache write position (the
    cache is written in place)."""
    x = _embed_inputs(params, tokens, rules)
    x, _ = _run_stack(params, x, cfg, rules, cache=cache, pos=pos,
                      mode="decode")
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind,
                          cfg.norm_eps)
    logits = layers.logits_out(params["embed"], x, cfg.logit_softcap, rules)
    return logits, cache
