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

On a mesh (DTensor activations and ``rules``) the activations are pinned
at the reference's constraint sites; a cache sharded along its sequence
is written by each rank into its own shard (``_write_shard``).
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
    return L.split_dim(x @ L.merge_dims(w.to(x.dtype), 1, -1), -1,
                       w.shape[1:])


def project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor], *, use_rope: bool = True,
                rules=None,
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
    q = L.constrain(q, rules, (L.BATCH, L.SEQ, L.HEADS, L.HEAD_DIM))
    k = L.constrain(k, rules, (L.BATCH, L.SEQ, L.KV_HEADS, L.HEAD_DIM))
    v = L.constrain(v, rules, (L.BATCH, L.SEQ, L.KV_HEADS, L.HEAD_DIM))
    return q, k, v


_HEAD_AXES = (L.BATCH, L.SEQ, L.HEADS, L.HEAD_DIM)
_KV_AXES = (L.BATCH, L.KV_SEQ, L.KV_HEADS, L.HEAD_DIM)


def _heads_local(q, k) -> bool:
    """Whether each rank can attend on its own shards: q's and k's heads
    sharded over the same mesh dims (so each rank's q heads use its own
    kv heads) and k's sequence whole."""
    from torch.distributed.tensor import Shard

    def dims(x, d):
        return [m for m, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == d]
    return bool(dims(q, 2)) and dims(q, 2) == dims(k, 2) and not dims(k, 1)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], rules=None,
               ctx_sharded: bool = False) -> torch.Tensor:
    """q: (B,S,Hq,Dh); k,v: (B,T,Hkv,Dh); mask broadcastable to
    (B,1,1,S,T).  Scores in the activations' dtype, softmax in float32,
    probabilities back in the activations' dtype, as the reference.

    ``ctx_sharded`` pins the score and probability matrices KV_SEQ-
    sharded (context parallelism), where the reference found that the
    placement must sit on the scores themselves.  On a mesh whose ranks
    hold whole sequences of their own q and kv heads, each rank attends
    on its shards (``sharding.logical.local_call``); otherwise the
    DTensor ops place the work (a sharded sequence gathers the softmax's
    rows)."""
    if (rules is not None and not ctx_sharded and L.is_dtensor(q)
            and L.is_dtensor(k) and _heads_local(q, k)):
        return L.local_call(_attend, [(q, _HEAD_AXES), (k, _KV_AXES),
                                      (v, _KV_AXES), (mask, None)],
                            [_HEAD_AXES], rules)
    return _attend(q, k, v, mask, rules, ctx_sharded)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor], rules=None,
            ctx_sharded: bool = False) -> torch.Tensor:
    hq, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    qg = L.split_dim(q, 2, (hkv, hq // hkv))
    scale = layers.weak(dh ** -0.5, q.dtype)
    scores = torch.einsum("bsngd,btnd->bngst", qg, k) * scale
    scores = scores.float()
    score_axes = (L.BATCH, L.KV_HEADS, None, L.SEQ, L.KV_SEQ)
    if ctx_sharded:
        scores = L.constrain(scores, rules, score_axes)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if ctx_sharded:
        probs = L.constrain(probs, rules, score_axes)
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    out = L.merge_dims(out, 2, 3)
    return L.constrain(out, rules, (L.BATCH, L.SEQ, L.HEADS, L.HEAD_DIM))


def causal_mask(s: int, t: int, device=None) -> torch.Tensor:
    """(1,1,1,S,T) boolean mask: query i attends to keys j <= i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi)[None, None, None]


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    return L.merge_dims(out, 2, 3) @ L.merge_dims(wo.to(out.dtype), 0, 1)


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor] = None,
                   causal: bool = True, rules=None) -> torch.Tensor:
    """Full-sequence self attention (training / prefill)."""
    s = x.shape[1]
    dev = L.local_device(x)
    if positions is None:
        positions = L.replicated_like(torch.arange(s, device=dev)[None, :],
                                      x)
    q, k, v = project_qkv(params, x, cfg, positions, rules=rules)
    if cfg.shard_ctx_train:
        # context-parallel attention: k/v sharded along the sequence over
        # the model axis, even where head counts don't divide it
        k = L.constrain(k, rules, (L.BATCH, L.KV_SEQ, L.KV_HEADS,
                                   L.HEAD_DIM))
        v = L.constrain(v, rules, (L.BATCH, L.KV_SEQ, L.KV_HEADS,
                                   L.HEAD_DIM))
    if cfg.attn_impl == "flash" and causal:
        out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
    else:
        mask = (L.replicated_like(causal_mask(s, s, device=dev), x)
                if causal else None)
        out = gqa_attend(q, k, v, mask, rules,
                         ctx_sharded=cfg.shard_ctx_train)
    return L.constrain(_out_proj(out, params["wo"]), rules,
                       (L.BATCH, L.SEQ, L.ACT_EMBED))


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Decoder->encoder attention (enc-dec archs): q from ``x``, k and v
    from the encoder ``memory``; no mask, no rope, no bias."""
    q = _project(x, params["wq"])
    k = _project(memory, params["wk"])
    v = _project(memory, params["wv"])
    out = _out_proj(gqa_attend(q, k, v, None, rules), params["wo"])
    return L.constrain(out, rules, (L.BATCH, L.SEQ, L.ACT_EMBED))


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
    ``dynamic_update_slice`` clamps it.  A sharded cache is written by
    each rank into its own shard (``_write_shard``)."""
    for name, val in writes:
        buf = cache[name]
        n = val.shape[1]
        if n > buf.shape[1]:
            raise ValueError(f"{n} positions do not fit a cache of "
                             f"{buf.shape[1]}")
        start = min(max(int(pos), 0), buf.shape[1] - n)
        if L.is_dtensor(buf):
            _write_shard(buf, val, start)
        else:
            buf[:, start:start + n] = val.to(buf.dtype)


def _write_shard(buf, val, start: int) -> None:
    """The span [start, start+n) of ``val`` into a DTensor cache ``buf``,
    whose sequence axis (dim 1) may be sharded: ``val`` is placed as
    ``buf`` but whole along the sequence, and each rank copies the part
    of the span that falls in its own shard (none, when it falls
    elsewhere).  No collective but the placing of ``val``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    seq_dims = [m for m, p in enumerate(buf.placements)
                if isinstance(p, Shard) and p.dim == 1]
    val_pl = [Replicate() if m in seq_dims else p
              for m, p in enumerate(buf.placements)]
    v = val.to(buf.dtype).redistribute(mesh, val_pl).to_local()
    local = buf.to_local()
    off, size = L.shard_span(buf, 1)
    lo, hi = max(start, off), min(start + v.shape[1], off + size)
    if lo < hi:
        local[:, lo - off:hi - off] = v[:, lo - start:hi - start]


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
                     cfg: ModelConfig, rules=None
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: write (k,v) at ``pos`` (in place), attend over
    the whole cache under a mask of positions <= pos.

    x: (B, 1, D); pos: int (same position for the whole batch — the
    serve scheduler aligns slots); cache k/v: (B, T, Hkv, Dh).
    """
    b = x.shape[0]
    dev = L.local_device(x)
    positions = L.replicated_like(
        torch.full((b, 1), int(pos), dtype=torch.int32, device=dev), x)
    q, k_new, v_new = project_qkv(params, x, cfg, positions, rules=rules)
    _write(cache, _codec_writes(cfg, k_new, v_new), pos)
    if cfg.kv_cache_dtype == "int8":
        k_att = _dequant_heads(cache["k"], cache["k_scale"], q.dtype)
        v_att = _dequant_heads(cache["v"], cache["v_scale"], q.dtype)
    else:
        k_att = cache["k"].to(q.dtype)
        v_att = cache["v"].to(q.dtype)
    t = k_att.shape[1]
    mask = L.replicated_like(
        torch.arange(t, device=dev)[None, None, None, None, :] <= pos, x)
    out = gqa_attend(q, k_att, v_att, mask, rules)
    out = L.constrain(_out_proj(out, params["wo"]), rules,
                      (L.BATCH, L.SEQ, L.ACT_EMBED))
    return out, dict(cache)
