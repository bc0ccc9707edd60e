"""GQA attention, ported from ``repro.models.attention``: the plain einsum
path, the dispatch point of the flash kernel (``cfg.attn_impl ==
"flash"``), and the KV-cache decode path with its optional int8 codec.

Departure from the reference, whose arrays are immutable: ``write_kv``
and ``decode_attention`` write the new k/v **in place** into the cache
tensors they are given (and return a dict holding those same tensors),
which saves a copy of the whole cache at every step.  A caller that
needs the old cache keeps a clone.  Only causal self-attention goes to
the flash kernel, as in the reference: the encoder's full self-attention
and the decoder's ``cross_attention`` take the plain path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.quant_cast.ref import INV127
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import ParamSpec

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    """The projections' specs; ``cross`` (the decoder's attention over
    the encoder memory) takes the same ones."""
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, hq, dh), (L.EMBED, L.HEADS, L.HEAD_DIM)),
        "wk": ParamSpec((d, hkv, dh), (L.EMBED, L.KV_HEADS, L.HEAD_DIM)),
        "wv": ParamSpec((d, hkv, dh), (L.EMBED, L.KV_HEADS, L.HEAD_DIM)),
        "wo": ParamSpec((hq, dh, d), (L.HEADS, L.HEAD_DIM, L.EMBED)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((hq, dh), (L.HEADS, L.HEAD_DIM), init="zeros")
        specs["bk"] = ParamSpec((hkv, dh), (L.KV_HEADS, L.HEAD_DIM),
                                init="zeros")
        specs["bv"] = ParamSpec((hkv, dh), (L.KV_HEADS, L.HEAD_DIM),
                                init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), (L.HEAD_DIM,), init="ones")
        specs["k_norm"] = ParamSpec((dh,), (L.HEAD_DIM,), init="ones")
    return specs


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    b, s, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).view(b, s, *w.shape[1:])


def project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor], *, use_rope: bool = True,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = x.dtype
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = _rms(q, params["q_norm"], cfg.norm_eps)
        k = _rms(k, params["k_norm"], cfg.norm_eps)
    if use_rope and positions is not None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,S,Hq,Dh); k,v: (B,T,Hkv,Dh); mask broadcastable to
    (B,1,1,S,T).  Scores in the activations' dtype, softmax in float32,
    probabilities back in the activations' dtype, as the reference."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, s, hkv, groups, dh)
    scale = layers.weak(dh ** -0.5, q.dtype)
    scores = torch.einsum("bsngd,btnd->bngst", qg, k) * scale
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(b, s, hq, dh)


def causal_mask(s: int, t: int, device=None) -> torch.Tensor:
    """(1,1,1,S,T) boolean mask: query i attends to keys j <= i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi)[None, None, None]


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ wo.to(out.dtype).reshape(-1, wo.shape[-1])


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence self attention (training / prefill)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(params, x, cfg, positions)
    if cfg.attn_impl == "flash" and causal:
        out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
    else:
        mask = causal_mask(s, s, device=x.device) if causal else None
        out = gqa_attend(q, k, v, mask)
    return _out_proj(out, params["wo"])


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder->encoder attention (enc-dec archs): q from ``x``, k and v
    from the encoder ``memory``; no mask, no rope, no bias."""
    q = _project(x, params["wq"])
    k = _project(memory, params["wk"])
    v = _project(memory, params["wv"])
    return _out_proj(gqa_attend(q, k, v, None), params["wo"])


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------
def kv_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    kv_axes = (L.BATCH, L.KV_SEQ, L.KV_HEADS, L.HEAD_DIM)
    if cfg.kv_cache_dtype == "int8":
        # quant_cast pages: 1B/elem + one f32 scale per (token, head)
        sc_axes = (L.BATCH, L.KV_SEQ, L.KV_HEADS, None)
        return {
            "k": ParamSpec((batch, cache_len, hkv, dh), kv_axes,
                           dtype=torch.int8, init="zeros"),
            "v": ParamSpec((batch, cache_len, hkv, dh), kv_axes,
                           dtype=torch.int8, init="zeros"),
            "k_scale": ParamSpec((batch, cache_len, hkv, 1), sc_axes,
                                 dtype=torch.float32, init="zeros"),
            "v_scale": ParamSpec((batch, cache_len, hkv, 1), sc_axes,
                                 dtype=torch.float32, init="zeros"),
        }
    return {
        "k": ParamSpec((batch, cache_len, hkv, dh), kv_axes,
                       dtype=torch.bfloat16, init="zeros"),
        "v": ParamSpec((batch, cache_len, hkv, dh), kv_axes,
                       dtype=torch.bfloat16, init="zeros"),
    }


def _quant_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) int8 quantization of (B,S,H,Dh) k/v tensors.

    The scale is ``absmax * INV127``, as the reference's compiled
    prefill and decode compute ``absmax / 127.0`` (XLA multiplies by the
    float32 reciprocal; an eager jnp division can differ in the last
    bit); ``x / scale`` stays a true division."""
    xf = x.float()
    absmax = xf.abs().amax(-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * INV127, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequant_heads(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _write(cache: dict, writes, pos: int) -> None:
    """Write each (name, value) span at ``pos`` along the sequence axis, in
    place; the start is clamped so the span fits, as
    ``dynamic_update_slice`` clamps it."""
    for name, val in writes:
        buf = cache[name]
        n = val.shape[1]
        if n > buf.shape[1]:
            raise ValueError(f"{n} positions do not fit a cache of "
                             f"{buf.shape[1]}")
        start = min(max(int(pos), 0), buf.shape[1] - n)
        buf[:, start:start + n] = val.to(buf.dtype)


def _codec_writes(cfg: ModelConfig, k_new: torch.Tensor,
                  v_new: torch.Tensor):
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quant_heads(k_new)
        vq, vs = _quant_heads(v_new)
        return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    return (("k", k_new), ("v", v_new))


def write_kv(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, pos,
             cfg: ModelConfig) -> dict:
    """Write a [pos, pos+S) span of k/v into the cache (codec-aware), in
    place; returns a dict of the same tensors."""
    _write(cache, _codec_writes(cfg, k_new, v_new), pos)
    return dict(cache)


def decode_attention(params: dict, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One-token decode: write (k,v) at ``pos`` (in place), attend over
    the whole cache under a mask of positions <= pos.

    x: (B, 1, D); pos: int (same position for the whole batch — the
    serve scheduler aligns slots); cache k/v: (B, T, Hkv, Dh).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = project_qkv(params, x, cfg, positions)
    _write(cache, _codec_writes(cfg, k_new, v_new), pos)
    if cfg.kv_cache_dtype == "int8":
        k_att = _dequant_heads(cache["k"], cache["k_scale"], q.dtype)
        v_att = _dequant_heads(cache["v"], cache["v_scale"], q.dtype)
    else:
        k_att = cache["k"].to(q.dtype)
        v_att = cache["v"].to(q.dtype)
    t = k_att.shape[1]
    mask = torch.arange(t, device=x.device)[None, None, None, None, :] <= pos
    out = gqa_attend(q, k_att, v_att, mask)
    return _out_proj(out, params["wo"]), dict(cache)
