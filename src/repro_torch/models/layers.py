"""Core layer primitives: RMSNorm, the per-head group norm, RoPE, the
SwiGLU MLP and the parameter builders of the attention and MLP blocks.

The port of the JAX package's ``repro/models/layers.py`` on one card:
parameters are plain dicts of tensors with the reference's shapes
(attention projections 3-D, ``(d_model, heads, head_dim)``), so a
reference parameter tree converts leaf for leaf
(:func:`repro_torch.interop.lm_params_from_numpy`).  Initialisation
draws from an explicit ``torch.Generator``; the numbers differ from
``jax.random``'s, the scales do not.  There is no sharding spec: tensor
parallelism waits for the ROADMAP item that maps ``meshenv`` to a
``DeviceMesh``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

Params = dict


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/in_dim) weights, drawn in float32 on the generator's
    device, then cast and moved."""
    scale = 1.0 / math.sqrt(max(in_dim, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·(1+weight)``, float32 statistics: the CUDA
    kernel on the card, the plain version on the CPU."""
    return rmsnorm_ops.rmsnorm(x, weight, eps)


def group_norm_heads(x: torch.Tensor, weight: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm of RWKV-6: x (..., H, hd), weight (H, hd).
    Mean and (biased) variance over hd in float32, the result cast back
    to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)              # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) or (S,) integers.  Halves are
    split (not interleaved) and angles are float32, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    if angles.dim() == 2:                          # (S, hd/2) -> batch 1
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]         # (B, S, 1, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dt = param_dtype(cfg)
    return {"wg": dense_init(gen, (d, ff), d, dt, device),
            "wu": dense_init(gen, (d, ff), d, dt, device),
            "wd": dense_init(gen, (ff, d), ff, dt, device)}


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu in float32, cast to x's dtype, times the up branch."""
    g = x @ p["wg"]
    u = x @ p["wu"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["wd"]


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device) -> Params:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    p = {"wq": dense_init(gen, (d, hq, hd), d, dt, device),
         "wk": dense_init(gen, (d, hkv, hd), d, dt, device),
         "wv": dense_init(gen, (d, hkv, hd), d, dt, device),
         "wo": dense_init(gen, (hq, hd, d), hq * hd, dt, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=device)
    return p


def init_norm(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=param_dtype(cfg), device=device)


__all__ = ["Params", "apply_mlp", "apply_rope", "dense_init",
           "group_norm_heads", "init_attention", "init_mlp", "init_norm",
           "param_dtype", "rms_norm", "rope_freqs"]
