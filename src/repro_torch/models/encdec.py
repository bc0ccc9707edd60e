"""Encoder-decoder transformer (seamless-m4t family, arXiv:2308.11596),
ported from ``repro.models.encdec``.

The speech frontend is a stub: the caller supplies precomputed frame
embeddings (B, S_src, D), and this module runs the transformer backbone
(an encoder, a causal decoder with cross-attention over the encoder's
memory).  Learned absolute positions are added in the activations' dtype,
as the reference adds them.

Parameters keep the reference's stacked layout (``enc_blocks`` and
``dec_blocks`` hold every layer's leaves with a leading LAYER axis), so
the two packages' trees flatten alike; the reference's ``lax.scan`` over
that axis is a Python loop here, and ``cfg.remat``/``cfg.scan_layers``
change nothing.  Only the decoder's causal self-attention reaches the
flash kernel (``attn_impl="flash"``); the encoder's full self-attention
and the cross-attention take the plain path, as in the reference.  The
decoder's KV cache is written in place (``attention.write_kv``,
``decode_attention``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import _tree
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import COMPUTE_DTYPE
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import ParamSpec

MAX_POSITIONS = 32768


def _enc_block_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.norm_specs(cfg.d_model, cfg.norm_kind),
        "attn": attention.attn_specs(cfg),
        "ln2": layers.norm_specs(cfg.d_model, cfg.norm_kind),
        "ffn": layers.ffn_specs(cfg.d_model, cfg.d_ff, cfg.mlp_kind),
    }


def _dec_block_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.norm_specs(cfg.d_model, cfg.norm_kind),
        "self_attn": attention.attn_specs(cfg),
        "ln_x": layers.norm_specs(cfg.d_model, cfg.norm_kind),
        "cross_attn": attention.attn_specs(cfg, cross=True),
        "ln2": layers.norm_specs(cfg.d_model, cfg.norm_kind),
        "ffn": layers.ffn_specs(cfg.d_model, cfg.d_ff, cfg.mlp_kind),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embed_specs(cfg.padded_vocab, cfg.d_model,
                                    cfg.tie_embeddings),
        "pos_embed": ParamSpec((MAX_POSITIONS, cfg.d_model),
                               (None, L.EMBED), init="embed_normal"),
        "enc_blocks": layers.stack_specs(_enc_block_specs(cfg),
                                         cfg.encoder_layers),
        "enc_norm": layers.norm_specs(cfg.d_model, cfg.norm_kind),
        "dec_blocks": layers.stack_specs(_dec_block_specs(cfg),
                                         cfg.num_layers),
        "final_norm": layers.norm_specs(cfg.d_model, cfg.norm_kind),
    }


def _add_positions(params, x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` plus the learned positions [offset, offset + S), cast to
    ``x``'s dtype first; the start is clamped so the span fits, as
    ``dynamic_slice`` clamps it."""
    s = x.shape[1]
    table = params["pos_embed"]
    start = min(max(int(offset), 0), table.shape[0] - s)
    return x + table[start:start + s][None].to(x.dtype)


def _layer(stacked, i: int):
    """Views of layer ``i`` of a stacked tree."""
    return _tree.tree_map(lambda p: p[i], stacked)


def encode(params, frame_embeds: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frame_embeds: (B, S_src, D) stub frontend output -> encoder
    memory (B, S_src, D) in the compute dtype."""
    x = _add_positions(params, frame_embeds.to(COMPUTE_DTYPE), 0)
    for i in range(cfg.encoder_layers):
        block = _layer(params["enc_blocks"], i)
        h = layers.apply_norm(block["ln1"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + attention.self_attention(block["attn"], h, cfg,
                                         causal=False)
        h = layers.apply_norm(block["ln2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + layers.apply_ffn(block["ffn"], h, cfg.mlp_kind)
    return layers.apply_norm(params["enc_norm"], x, cfg.norm_kind,
                             cfg.norm_eps)


def _dec_block(block, x, memory, cfg, *, cache=None, pos=None,
               mode="train"):
    """One decoder layer: causal self-attention (``mode`` "train",
    "prefill" (which also fills ``cache``) or "decode" (one token at
    ``pos``)), cross-attention over ``memory``, the FFN."""
    h = layers.apply_norm(block["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    if mode == "train":
        x = x + attention.self_attention(block["self_attn"], h, cfg)
    elif mode == "prefill":
        x = x + attention.self_attention(block["self_attn"], h, cfg)
        # k and v are projected a second time for the cache, as the
        # reference does
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        _, k, v = attention.project_qkv(block["self_attn"], h, cfg,
                                        positions)
        attention.write_kv(cache, k, v, 0, cfg)
    else:
        x = x + attention.decode_attention(block["self_attn"], h, cache,
                                           pos, cfg)[0]
    h = layers.apply_norm(block["ln_x"], x, cfg.norm_kind, cfg.norm_eps)
    x = x + attention.cross_attention(block["cross_attn"], h, memory, cfg)
    h = layers.apply_norm(block["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    return x + layers.apply_ffn(block["ffn"], h, cfg.mlp_kind)


def _run_decoder(params, x, memory, cfg, *, cache=None, pos=None,
                 mode="train"):
    """Every decoder layer in order; the cache's stacked tensors are
    written in place through their per-layer views."""
    for i in range(cfg.num_layers):
        kv = _layer(cache, i) if cache is not None else None
        x = _dec_block(_layer(params["dec_blocks"], i), x, memory, cfg,
                       cache=kv, pos=pos, mode=mode)
    return x


def _decoder_inputs(params, tokens, offset: int) -> torch.Tensor:
    x = layers.embed_tokens(params["embed"], tokens, COMPUTE_DTYPE)
    return _add_positions(params, x, offset)


def forward(params, tokens, frame_embeds, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training: (tokens (B,S_tgt), frames (B,S_src,D)) -> (logits
    (B,S_tgt,V) f32, aux = 0)."""
    memory = encode(params, frame_embeds, cfg)
    x = _run_decoder(params, _decoder_inputs(params, tokens, 0), memory,
                     cfg, mode="train")
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind,
                          cfg.norm_eps)
    logits = layers.logits_out(params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    kv = attention.kv_cache_specs(cfg, batch, cache_len)
    return layers.stack_specs(kv, cfg.num_layers)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    return _tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_specs(cfg, batch, cache_len))


def prefill(params, tokens, frame_embeds, cache, cfg: ModelConfig):
    """Encode the frames, fill the decoder's cache for positions [0, S)
    in place.  Returns (last-token logits, cache, encoder memory)."""
    memory = encode(params, frame_embeds, cfg)
    x = _run_decoder(params, _decoder_inputs(params, tokens, 0), memory,
                     cfg, cache=cache, mode="prefill")
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm_kind,
                          cfg.norm_eps)
    return layers.logits_out(params["embed"], x), cache, memory


def decode_step(params, tokens, memory, cache, pos: int, cfg: ModelConfig):
    """tokens (B,1) at ``pos``; memory (B,S_src,D) the fixed encoder
    output; the cache is written in place."""
    x = _run_decoder(params, _decoder_inputs(params, tokens, pos), memory,
                     cfg, cache=cache, pos=pos, mode="decode")
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind,
                          cfg.norm_eps)
    return layers.logits_out(params["embed"], x), cache
