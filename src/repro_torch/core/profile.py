"""Layer-profile extraction: per-layer FLOPs and activation sizes — the
paper's f_l^i, f_e^i, w_s tables that the MCSA planner consumes as a
:class:`LayerProfile` — for the paper's chain CNNs and for the
transformer architectures (one entry per block, the natural split
granularity).

Same closed-form counts as the JAX package's ``repro/core/profile.py``
(the differential tests hold the two equal, bit for bit).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.configs.chain_cnns import ChainCNNConfig
from .costs import LayerProfile

BITS_PER_ACT = 16                 # activations ship as bf16


def profile_chain_cnn(cfg: ChainCNNConfig, batch: int = 1) -> LayerProfile:
    h = w = cfg.in_hw
    c = cfg.in_ch
    flat: Optional[int] = None
    flops, out_bits = [], []
    for layer in cfg.layers:
        if layer.kind == "conv":
            h = -(-h // layer.stride)
            w = -(-w // layer.stride)
            # 2·K²·Cin·Cout·H·W MACs→FLOPs + relu
            f = 2.0 * layer.kernel ** 2 * c * layer.out_ch * h * w
            f += h * w * layer.out_ch
            c = layer.out_ch
            flops.append(f * batch)
            out_bits.append(h * w * c * BITS_PER_ACT * batch)
        elif layer.kind == "pool":
            f = float(layer.kernel ** 2 * h * w * c)
            h = max(1, h // layer.stride)
            w = max(1, w // layer.stride)
            flops.append(f * batch)
            out_bits.append(h * w * c * BITS_PER_ACT * batch)
        else:                                   # fc
            if flat is None:
                flat = h * w * c
            f = 2.0 * flat * layer.out_features
            flat = layer.out_features
            flops.append(f * batch)
            out_bits.append(flat * BITS_PER_ACT * batch)
    return LayerProfile(
        name=cfg.name,
        flops=np.asarray(flops, np.float64),
        out_bits=np.asarray(out_bits, np.float64),
        in_bits=cfg.in_hw ** 2 * cfg.in_ch * 8.0 * batch,   # uint8 image
        result_bits=cfg.num_classes * 32.0 * batch,
    )


def _block_flops(cfg: ModelConfig, layer_type: str, seq: int,
                 mode: str) -> float:
    """FLOPs of ONE block processing ``seq`` tokens (prefill/train fwd) or
    one token against a ``seq``-token context (decode)."""
    d, ff = cfg.d_model, cfg.d_ff
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tokens = 1 if mode == "decode" else seq
    f = 0.0
    if layer_type in (ATTN_GLOBAL, ATTN_LOCAL):
        f += 2.0 * tokens * d * (Hq + 2 * Hkv) * hd          # qkv proj
        f += 2.0 * tokens * Hq * hd * d                      # out proj
        ctx = seq if layer_type == ATTN_GLOBAL else min(
            seq, cfg.window_size)
        if mode == "decode":
            f += 2.0 * 2.0 * Hq * hd * ctx                   # qk + pv
        else:
            avg_ctx = ctx / 2 if layer_type == ATTN_GLOBAL else ctx
            f += 2.0 * 2.0 * tokens * Hq * hd * avg_ctx
    elif layer_type == RGLRU:
        r = cfg.d_rnn
        f += 2.0 * tokens * d * r * 3                        # wx, wy, wo
        f += 2.0 * tokens * cfg.conv_width * r               # conv
        f += 2.0 * tokens * (r // cfg.num_heads) * r * 2     # block-diag gates
        f += 8.0 * tokens * r                                # recurrence
    elif layer_type == RWKV6:
        H, n = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        f += 2.0 * tokens * d * d * 5                        # r,k,v,g,o
        f += 2.0 * tokens * d * cfg.rwkv_decay_lora * 2      # decay lora
        f += 4.0 * 2.0 * tokens * H * n * n                  # wkv state update
        ffr = cfg.d_ff_rwkv or ff
        f += 2.0 * tokens * (d * ffr + ffr * d + d * d)      # channel mix
        return f
    # FFN (dense or MoE active)
    if cfg.num_experts:
        f += 2.0 * tokens * d * cfg.num_experts              # router
        f += 2.0 * 3.0 * tokens * d * ff * cfg.experts_per_token
    else:
        f += 2.0 * 3.0 * tokens * d * ff
    return f


def profile_transformer(cfg: ModelConfig, *, seq: int, batch: int = 1,
                        mode: str = "prefill") -> LayerProfile:
    """Profile with one entry per transformer block.

    ``w_s`` (shipped activation at a split) is the residual stream:
    (batch, tokens, d_model) bf16.  The unembedding's FLOPs are folded
    into the last block; the embedding lookup counts none."""
    types = cfg.layer_types()
    tokens = 1 if mode == "decode" else seq
    flops = np.array([_block_flops(cfg, lt, seq, mode) * batch
                      for lt in types], np.float64)
    act_bits = float(batch * tokens * cfg.d_model * BITS_PER_ACT)
    out_bits = np.full(len(types), act_bits, np.float64)
    flops[-1] += 2.0 * tokens * batch * cfg.d_model * cfg.vocab_size
    in_bits = float(batch * tokens * 32)       # token ids
    result_bits = float(batch * 32)            # one token id per sequence
    return LayerProfile(name=f"{cfg.name}:{mode}:{seq}",
                        flops=flops, out_bits=out_bits,
                        in_bits=in_bits, result_bits=result_bits)


def profile_of(cfg, **kw) -> LayerProfile:
    if isinstance(cfg, ChainCNNConfig):
        return profile_chain_cnn(cfg, batch=kw.get("batch", 1))
    return profile_transformer(cfg, **kw)
