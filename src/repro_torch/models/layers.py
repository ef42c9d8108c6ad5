"""Core layer primitives: RMSNorm, the per-head group norm, RoPE, the
SwiGLU MLP and the parameter builders of the attention and MLP blocks.

The port of the JAX package's ``repro/models/layers.py`` on one card:
parameters are plain dicts of tensors with the reference's shapes
(attention projections 3-D, ``(d_model, heads, head_dim)``), so a
reference parameter tree converts leaf for leaf
(:func:`repro_torch.interop.lm_params_from_numpy`).  Initialisation
draws from an explicit ``torch.Generator``; the numbers differ from
``jax.random``'s, the scales do not.

Sharding: :func:`attention_specs` and :func:`mlp_specs` give the
reference's ``PartitionSpec``s for a ``MeshEnv``, the rules of its
``init_attention`` / ``init_mlp``:

* attention projections are 3-D ``(d_model, heads, head_dim)`` sharded
  on the heads dim; q heads are padded (:func:`padded_heads`) so that
  they divide TP, the padded heads with zero ``wo`` rows;
* k/v heads shard only when ``num_kv_heads % tp == 0``, else they are
  replicated;
* ``wg``/``wu`` are column-parallel and ``wd`` row-parallel.

:func:`apply_mlp` with a tensor-parallel env runs on the local columns
and ends in an all-reduce over the model axis.  The attention specs
serve every family's attention blocks, an encoder-decoder's encoder and
cross attention among them (``cross``: no qk-norm weights).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv, P

Params = dict


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/in_dim) weights, drawn in float32 on the generator's
    device, then cast and moved.  On the ``meta`` device nothing is
    drawn or allocated: the shape and dtype alone (abstract parameters,
    ``launch/steps.py``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def mlp_specs(cfg: ModelConfig, env: MeshEnv) -> dict:
    """The reference's MLP specs: ``wg``/``wu`` column-parallel, ``wd``
    row-parallel."""
    return {"wg": P(None, "model"), "wu": P(None, "model"),
            "wd": P("model", None)}


def apply_mlp(p: Params, x: torch.Tensor, *,
              env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """SwiGLU: silu in float32, cast to x's dtype, times the up branch.
    With ``env.tp > 1``, ``p`` holds this rank's d_ff columns of ``wg``
    and ``wu`` and rows of ``wd``, and the output is summed over the
    model axis."""
    if env.tp > 1:
        x = env.psum_grad(x, env.model_axis)
    g = x @ p["wg"]
    u = x @ p["wu"]
    h = F.silu(g.float()).to(x.dtype) * u
    out = h @ p["wd"]
    return env.psum(out, env.model_axis) if env.tp > 1 else out


def padded_heads(hq: int, hkv: int, tp: int) -> int:
    """Query-head count padded so that the heads divide TP and the GQA
    repeat factor stays integral (the reference's rule: yi-34b 56 -> 64,
    starcoder2 24 -> 32 at tp 16; divisible counts are unchanged)."""
    if tp <= 1 or hq % tp == 0:
        return hq
    unit = tp
    while unit % hkv and hkv % unit:
        unit += tp                       # keep hq_pad a multiple of hkv too
    pad = -(-hq // unit) * unit
    while pad % hkv:
        pad += tp
    return pad


def attention_heads_sharded(env: MeshEnv) -> bool:
    """True when attention's q heads shard over the model axis (tp > 1
    without context-parallel attention, under which the attention
    weights replicate and the sequence shards instead)."""
    return env.tp > 1 and not env.context_parallel_attn


def kv_sharded(cfg: ModelConfig, env: MeshEnv) -> bool:
    """True when k/v heads shard over the model axis (they divide TP)."""
    return (attention_heads_sharded(env)
            and cfg.num_kv_heads % env.tp == 0)


def attention_specs(cfg: ModelConfig, env: MeshEnv,
                    cross: bool = False) -> dict:
    """The reference's attention specs for ``env``: q heads over the
    model axis, k/v heads only when they divide TP, qk-norm weights
    replicated."""
    q_axis = "model" if attention_heads_sharded(env) else None
    kv_axis = "model" if kv_sharded(cfg, env) else None
    specs = {"wq": P(None, q_axis, None), "wk": P(None, kv_axis, None),
             "wv": P(None, kv_axis, None), "wo": P(q_axis, None, None)}
    if cfg.qk_norm and not cross:
        specs["q_norm"] = P(None)
        specs["k_norm"] = P(None)
    return specs


def init_attention(cfg: ModelConfig, gen: torch.Generator, device,
                   cross: bool = False, env: MeshEnv = CPU_ENV) -> Params:
    """{wq, wk, wv, wo}, with qk-norm weights when ``cfg.qk_norm`` unless
    this is a cross-attention block (``cross``), which has none.  The q
    heads are padded for ``env.tp`` (:func:`padded_heads`), the padded
    heads' ``wo`` rows zero: an exact no-op on the output."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    hq_pad = padded_heads(hq, hkv, env.tp)
    p = {"wq": dense_init(gen, (d, hq_pad, hd), d, dt, device),
         "wk": dense_init(gen, (d, hkv, hd), d, dt, device),
         "wv": dense_init(gen, (d, hkv, hd), d, dt, device),
         "wo": dense_init(gen, (hq_pad, hd, d), hq * hd, dt, device)}
    if hq_pad != hq:
        p["wo"][hq:] = 0
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=device)
    return p


def init_norm(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=param_dtype(cfg), device=device)


__all__ = ["Params", "apply_mlp", "apply_rope", "attention_heads_sharded",
           "attention_specs", "dense_init", "group_norm_heads",
           "init_attention", "init_mlp",
           "init_norm", "kv_sharded", "mlp_specs", "padded_heads",
           "param_dtype", "rms_norm", "rope_freqs"]
