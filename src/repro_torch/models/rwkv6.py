"""RWKV6 ("Finch") token-mix and channel-mix layers, ported from
``repro.models.rwkv6``: a data-dependent-decay linear recurrence
(arXiv:2404.05892), attention-free.

The time mix runs the WKV recurrence through the hand-written kernel
(``kernels.rwkv6_scan.ops.wkv6``) when ``cfg.attn_impl == "flash"``, the
knob that routes attention to its kernel, and through the plain
recurrence (``wkv_scan``) otherwise; the two compute the same function.
The reference's own model runs its ``lax.scan`` either way (ROADMAP.md
§3).  Decode is one state update, O(1) a token.

Departure from the reference, whose arrays are immutable: with a
``state`` (the serve path's cache entries), ``apply_time_mix`` and
``apply_channel_mix`` write the new state into its tensors **in place**
and return that same dict.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import ParamSpec

LORA_RANK = 32
DECAY_LORA_RANK = 64


def num_rwkv_heads(cfg: ModelConfig) -> int:
    assert cfg.d_model % cfg.rwkv_head_dim == 0
    return cfg.d_model // cfg.rwkv_head_dim


def time_mix_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = num_rwkv_heads(cfg)
    dh = cfg.rwkv_head_dim
    return {
        # token-shift interpolation: base mus + data-dependent lora (ddlerp)
        "mu_base": ParamSpec((5, d), (None, L.EMBED), init="zeros"),
        "mu_w1": ParamSpec((d, 5 * LORA_RANK), (L.EMBED, None)),
        "mu_w2": ParamSpec((5, LORA_RANK, d), (None, None, L.EMBED)),
        # projections
        "wr": ParamSpec((d, d), (L.EMBED, L.MLP)),
        "wk": ParamSpec((d, d), (L.EMBED, L.MLP)),
        "wv": ParamSpec((d, d), (L.EMBED, L.MLP)),
        "wg": ParamSpec((d, d), (L.EMBED, L.MLP)),
        "wo": ParamSpec((d, d), (L.MLP, L.EMBED)),
        # data-dependent decay
        "w0": ParamSpec((d,), (L.EMBED,), init="zeros"),
        "w_lora_a": ParamSpec((d, DECAY_LORA_RANK), (L.EMBED, None)),
        "w_lora_b": ParamSpec((DECAY_LORA_RANK, d), (None, L.EMBED)),
        # bonus (per-head u) and per-head group-norm
        "u": ParamSpec((h, dh), (L.HEADS, L.HEAD_DIM), init="zeros"),
        "ln_scale": ParamSpec((d,), (L.EMBED,), init="ones"),
        "ln_bias": ParamSpec((d,), (L.EMBED,), init="zeros"),
    }


def channel_mix_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), (L.EMBED,), init="zeros"),
        "mu_r": ParamSpec((d,), (L.EMBED,), init="zeros"),
        "wk": ParamSpec((d, f), (L.EMBED, L.MLP)),
        "wv": ParamSpec((f, d), (L.MLP, L.EMBED)),
        "wr": ParamSpec((d, d), (L.EMBED, None)),
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 takes ``prev`` (decode carry) or 0."""
    first = prev if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(params: dict, x: torch.Tensor,
            xx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """RWKV6 data-dependent lerp producing the 5 mixed inputs (r,w,k,v,g)."""
    dt = x.dtype
    dx = xx - x
    # low-rank data-dependent offsets
    mu_base = params["mu_base"].to(dt)
    base = x + dx * mu_base[0]
    z = L.split_dim(torch.tanh(base @ params["mu_w1"].to(dt)), -1,
                    (5, LORA_RANK))
    offs = torch.einsum("bstr,trd->bstd", z, params["mu_w2"].to(dt))
    return tuple(x + dx * (mu_base[i] + offs[:, :, i]) for i in range(5))


def _decay(params: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel per-token decay w in (0,1): exp(-exp(w0 + lora(xw))).
    The reference's einsums of bf16 ``xw`` with the float32 lora weights
    promote to float32; torch does not promote, so the casts are
    spelled out."""
    lora = (torch.tanh(xw.float() @ params["w_lora_a"].float())
            @ params["w_lora_b"].float())
    return torch.exp(-torch.exp(params["w0"].float() + lora))


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                num_heads: int, eps: float = 64e-5) -> torch.Tensor:
    b, s, d = x.shape
    xh = x.reshape(b, s, num_heads, d // num_heads).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return xh.reshape(b, s, d) * scale.float() + bias.float()


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference WKV6 recurrence (the kernel's plain version).

    r,k,v,w: (B, S, H, Dh) fp32; u: (H, Dh); state: (B, H, Dh, Dh).
      S_t = diag(w_t) S_{t-1} + k_t^T v_t
      y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    Returns y (B, S, H, Dh) and the final state.
    """
    return wkv_ref.wkv6(r, k, v, w, u, state)


def init_time_state(cfg: ModelConfig, batch: int) -> dict:
    h, dh = num_rwkv_heads(cfg), cfg.rwkv_head_dim
    return {
        "wkv": ParamSpec((batch, h, dh, dh),
                         (L.BATCH, L.HEADS, None, None),
                         dtype=torch.float32, init="zeros"),
        "shift": ParamSpec((batch, 1, cfg.d_model),
                           (L.BATCH, None, None),
                           dtype=torch.bfloat16, init="zeros"),
    }


_HEAD_AXES = (L.BATCH, L.SEQ, L.HEADS, L.HEAD_DIM)
_WKV_STATE_AXES = (L.BATCH, L.HEADS, None, None)


def _plain_scan(rh, kh, vh, wh, u, s0):
    if s0 is None:
        b, _, h, dh = rh.shape
        s0 = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=rh.device)
    return wkv_scan(rh, kh, vh, wh, u, s0)


def apply_time_mix(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[dict] = None, rules=None
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Sequence mode (``state`` None: a zero state) or streaming (the
    carried ``state``, updated in place).  On a mesh the plain
    recurrence runs on each rank's batch rows and heads (it is
    independent along both)."""
    b, s, d = x.shape
    h, dh = num_rwkv_heads(cfg), cfg.rwkv_head_dim
    dt = x.dtype

    prev = state["shift"].to(dt) if state is not None else None
    xx = _token_shift(x, prev)
    xr, xw, xk, xv, xg = _ddlerp(params, x, xx)

    r = xr @ params["wr"].to(dt)
    k = xk @ params["wk"].to(dt)
    v = xv @ params["wv"].to(dt)
    g = xg @ params["wg"].to(dt)
    w = _decay(params, xw)                                 # fp32 (B,S,D)

    rh, kh, vh = (L.split_dim(t, -1, (h, dh)).float() for t in (r, k, v))
    wh = L.split_dim(w, -1, (h, dh))
    rh = L.constrain(rh, rules, _HEAD_AXES)
    u = params["u"].float()
    s0 = state["wkv"] if state is not None else None
    if cfg.attn_impl == "flash":
        y, s_final = wkv_ops.wkv6(rh, kh, vh, wh, u, s0)
    else:
        y, s_final = L.local_call(
            _plain_scan,
            [(rh, _HEAD_AXES), (kh, _HEAD_AXES), (vh, _HEAD_AXES),
             (wh, _HEAD_AXES), (u, (L.HEADS, L.HEAD_DIM)),
             (s0, _WKV_STATE_AXES)],
            [_HEAD_AXES, _WKV_STATE_AXES], rules)

    y = _group_norm(y.reshape(b, s, d), params["ln_scale"],
                    params["ln_bias"], h)
    out = y.to(dt) * layers.silu(g)
    out = L.constrain(out @ params["wo"].to(dt), rules,
                      (L.BATCH, L.SEQ, L.ACT_EMBED))

    if state is not None:
        state["wkv"].copy_(s_final)
        state["shift"].copy_(x[:, -1:])
    return out, state


def init_channel_state(cfg: ModelConfig, batch: int) -> dict:
    return {"shift": ParamSpec((batch, 1, cfg.d_model),
                               (L.BATCH, None, None),
                               dtype=torch.bfloat16, init="zeros")}


def apply_channel_mix(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[dict] = None, rules=None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    dt = x.dtype
    prev = state["shift"].to(dt) if state is not None else None
    xx = _token_shift(x, prev)
    dx = xx - x
    xk = x + dx * params["mu_k"].to(dt)
    xr = x + dx * params["mu_r"].to(dt)
    k = torch.relu(xk @ params["wk"].to(dt)).square()
    k = L.constrain(k, rules, (L.BATCH, L.SEQ, L.MLP))
    vv = k @ params["wv"].to(dt)
    r = layers.sigmoid(xr @ params["wr"].to(dt))
    out = L.constrain(r * vv, rules, (L.BATCH, L.SEQ, L.ACT_EMBED))
    if state is not None:
        state["shift"].copy_(x[:, -1:])
    return out, state
