"""Mamba (selective SSM) mixer as used in Jamba (arXiv:2403.19887), ported
from ``repro.models.mamba``.

The selective scan runs through the hand-written kernel
(``kernels.mamba_scan.ops.selective_scan``) when ``cfg.attn_impl ==
"flash"`` and through the plain scan (``selective_scan``) otherwise; the
two compute the same function.  The reference's own model runs its
``lax.scan`` either way (ROADMAP.md §3).  Decode is an O(1) state
update.

Departure from the reference, whose arrays are immutable: with a
``state`` (the serve path's cache entries), ``apply_mamba`` writes the
new state into its tensors **in place** and returns that same dict.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical as L
from repro_torch.sharding.logical import ParamSpec


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def mamba_specs(cfg: ModelConfig) -> dict:
    d, di, n, r, cw = (cfg.d_model, d_inner(cfg), cfg.ssm_state,
                       dt_rank(cfg), cfg.ssm_conv)
    return {
        "in_proj": ParamSpec((d, 2 * di), (L.EMBED, L.MLP)),
        "conv_w": ParamSpec((cw, di), (L.CONV, L.MLP), init="normal"),
        "conv_b": ParamSpec((di,), (L.MLP,), init="zeros"),
        "x_proj": ParamSpec((di, r + 2 * n), (L.MLP, None)),
        "dt_proj": ParamSpec((r, di), (None, L.MLP)),
        "dt_bias": ParamSpec((di,), (L.MLP,), init="zeros"),
        "a_log": ParamSpec((di, n), (L.MLP, L.STATE), init="zeros"),
        "d_skip": ParamSpec((di,), (L.MLP,), init="ones"),
        "out_proj": ParamSpec((di, d), (L.MLP, L.EMBED)),
        # Jamba stabilizes dt/B/C with RMSNorm scales
        "dt_norm": ParamSpec((r,), (None,), init="ones"),
        "b_norm": ParamSpec((n,), (L.STATE,), init="ones"),
        "c_norm": ParamSpec((n,), (L.STATE,), init="ones"),
    }


def init_mamba_state(cfg: ModelConfig, batch: int) -> dict:
    di, n, cw = d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    return {
        "h": ParamSpec((batch, di, n), (L.BATCH, L.MLP, L.STATE),
                       dtype=torch.float32, init="zeros"),
        "conv": ParamSpec((batch, cw - 1, di), (L.BATCH, L.CONV, L.MLP),
                          dtype=torch.bfloat16, init="zeros"),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``jnp.logaddexp(x, 0)``), op by op:
    ``max(x, 0) + log1p(exp(-|x|))``, each op rounded to x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B,S,Di); w: (CW,Di); prev: (B,CW-1,Di).
    The taps are summed in order, each sum rounded, as the reference's
    Python ``sum`` adds them."""
    cw, s = w.shape[0], x.shape[1]
    if prev is None:
        prev = L.replicated_like(
            torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                        device=L.local_device(x)), x)
    xp = torch.cat([prev, x], dim=1)                  # (B, S+CW-1, Di)
    out = xp[:, :s] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u,dt: (B,S,Di); a: (Di,N); b,c: (B,S,N); h0: (B,Di,N) fp32 (the
    kernel's plain version).

      h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t u_t) ⊗ B_t;  y_t = h_t · C_t
    """
    return scan_ref.selective_scan(u, dt, a, b, c, h0)


_SEQ_MLP = (L.BATCH, L.SEQ, L.MLP)
_SEQ_STATE = (L.BATCH, L.SEQ, L.STATE)
_H_AXES = (L.BATCH, L.MLP, L.STATE)


def _plain_scan(u, dt, a, b, c, h0):
    if h0 is None:
        h0 = torch.zeros((u.shape[0], u.shape[2], a.shape[1]),
                         dtype=torch.float32, device=u.device)
    return selective_scan(u, dt, a, b, c, h0)


def apply_mamba(params: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None, rules=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """On a mesh the plain scan runs on each rank's batch rows and
    channels (it is independent along both)."""
    bsz, s, d = x.shape
    di, n, r = d_inner(cfg), cfg.ssm_state, dt_rank(cfg)
    dt_ = x.dtype

    xz = L.constrain(x @ params["in_proj"].to(dt_), rules, _SEQ_MLP)
    xin, z = xz.split(di, dim=-1)

    prev_conv = state["conv"].to(dt_) if state is not None else None
    xc = _causal_conv(xin, params["conv_w"].to(dt_),
                      params["conv_b"].to(dt_), prev_conv)
    xc = L.constrain(layers.silu(xc), rules, _SEQ_MLP)

    proj = xc @ params["x_proj"].to(dt_)
    dt_low, b_in, c_in = proj.split([r, n, n], dim=-1)
    dt_low = _rms(dt_low, params["dt_norm"], cfg.norm_eps)
    b_in = _rms(b_in, params["b_norm"], cfg.norm_eps)
    c_in = _rms(c_in, params["c_norm"], cfg.norm_eps)
    dt_full = softplus(dt_low @ params["dt_proj"].to(dt_)
                       + params["dt_bias"].to(dt_))

    a = -torch.exp(params["a_log"].float())
    h0 = state["h"] if state is not None else None
    if cfg.attn_impl == "flash":
        y, h_final = scan_ops.selective_scan(
            xc.contiguous(), dt_full.contiguous(), a, b_in.contiguous(),
            c_in.contiguous(), h0)
    else:
        y, h_final = L.local_call(
            _plain_scan,
            [(xc, _SEQ_MLP), (dt_full, _SEQ_MLP), (a, (L.MLP, L.STATE)),
             (b_in, _SEQ_STATE), (c_in, _SEQ_STATE), (h0, _H_AXES)],
            [_SEQ_MLP, _H_AXES], rules)
    y = y.to(dt_) + xc * params["d_skip"].to(dt_)

    out = y * layers.silu(z)
    out = L.constrain(out @ params["out_proj"].to(dt_), rules,
                      (L.BATCH, L.SEQ, L.ACT_EMBED))

    if state is not None:
        tail = torch.cat([prev_conv, xin], dim=1)[:, -(cfg.ssm_conv - 1):]
        state["conv"].copy_(tail)
        state["h"].copy_(h_final)
    return out, state
