"""RWKV-6 "Finch" blocks (arXiv:2404.05892) on one card: attention-free
time mixing with data-dependent decay, and the channel-mix FFN.

The port of the JAX package's ``repro/models/rwkv.py``, with its rounding
points: the token-shift mixes are in the model's dtype; the decay LoRA
runs in float32, ``w = exp(-exp(clip(logw, -20, 10)))``; r, k, v and g
come out of their products in the model's dtype; the WKV output y stays
float32 through the per-head group norm and ``silu(g)`` and is cast back
for ``wo``.  ``w0``, ``wA``, ``wB``, ``u`` and ``ln_x`` are float32 even
in a bfloat16 model.  The WKV recurrence goes through
:mod:`repro_torch.kernels.wkv6` in the model layout (B, S, H, n), so no
transposed copy is made.

State for decode, per block: the time mix's ``{"s": (B, H, n, n),
"tm": (B, d)}`` and the channel mix's ``{"cm": (B, d)}``, all float32.
Decode updates a given state in place (the WKV kernel writes the final
state over the state it read) and returns the same dicts; prefill
returns new ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
from .layers import dense_init, group_norm_heads, param_dtype

Params = dict


def init_rwkv_time_mix(cfg: ModelConfig, gen: torch.Generator,
                       device) -> Params:
    d = cfg.d_model
    H, n = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    L = cfg.rwkv_decay_lora
    dt, f32 = param_dtype(cfg), torch.float32
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),  # r,k,v,g,w
        "w0": torch.zeros((d,), dtype=f32, device=device),
        "wA": dense_init(gen, (d, L), d, f32, device),
        "wB": dense_init(gen, (L, d), L, f32, device),
        "wr": dense_init(gen, (d, H, n), d, dt, device),
        "wk": dense_init(gen, (d, H, n), d, dt, device),
        "wv": dense_init(gen, (d, H, n), d, dt, device),
        "wg": dense_init(gen, (d, H, n), d, dt, device),
        "u": dense_init(gen, (H, n), n, f32, device),
        "ln_x": torch.ones((H, n), dtype=f32, device=device),
        "wo": dense_init(gen, (H, n, d), H * n, dt, device),
    }


def init_rwkv_channel_mix(cfg: ModelConfig, gen: torch.Generator,
                          device) -> Params:
    d = cfg.d_model
    ff = cfg.d_ff_rwkv or cfg.d_ff
    dt = param_dtype(cfg)
    return {
        "mu": torch.full((2, d), 0.5, dtype=dt, device=device),  # k, r
        "wk": dense_init(gen, (d, ff), d, dt, device),
        "wv": dense_init(gen, (ff, d), ff, dt, device),
        "wr": dense_init(gen, (d, d), d, dt, device),
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along time; ``prev`` (B, d) carries across calls (decode)."""
    B, S, d = x.shape
    if S == 1:
        if prev is None:
            return torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
        return prev[:, None].to(x.dtype)
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted[:, 0] = prev.to(x.dtype)
    return shifted


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, n) -> (B, S, H, n)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])


def apply_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), state {"s", "tm"}).  With ``state``
    (decode) the state is read and updated in place."""
    B, S, d = x.shape
    H, n = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    prev = state["tm"] if state is not None else None
    xs = _token_shift(x, prev)
    mu = p["mu"]
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))

    logw = p["w0"] + torch.tanh(xw.float() @ p["wA"]) @ p["wB"]
    w = torch.exp(-torch.exp(torch.clamp(logw, -20.0, 10.0)))
    w = w.reshape(B, S, H, n)

    r, k, v, g = (_heads(t, p[name]) for t, name in
                  ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    s0 = state["s"] if state is not None else None
    y, s_final = wkv_ops.wkv6(r, k, v, w, p["u"], s0, state_out=s0)
    y = group_norm_heads(y, p["ln_x"])
    y = y * F.silu(g.float())
    out = y.to(x.dtype).reshape(B, S, H * n) @ p["wo"].reshape(H * n, d)
    if state is not None:
        state["tm"].copy_(x[:, -1])
        return out, state
    return out, {"s": s_final, "tm": x[:, -1].float()}


def apply_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      state: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), state {"cm"}).  With ``state``
    (decode) the state is read and updated in place."""
    prev = state["cm"] if state is not None else None
    xs = _token_shift(x, prev)
    mu = p["mu"]
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu((xk @ p["wk"]).float())).to(x.dtype)
    v = k @ p["wv"]
    rgate = torch.sigmoid((xr @ p["wr"]).float())
    out = (rgate * v.float()).to(x.dtype)
    if state is not None:
        state["cm"].copy_(x[:, -1])
        return out, state
    return out, {"cm": x[:, -1].float()}


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> dict:
    """Zero decode state of one block: {"s", "tm", "cm"}, float32."""
    H, n = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    f32 = torch.float32
    return {"s": torch.zeros((batch, H, n, n), dtype=f32, device=device),
            "tm": torch.zeros((batch, cfg.d_model), dtype=f32, device=device),
            "cm": torch.zeros((batch, cfg.d_model), dtype=f32, device=device)}


__all__ = ["apply_channel_mix", "apply_time_mix", "init_rwkv_channel_mix",
           "init_rwkv_state", "init_rwkv_time_mix"]
