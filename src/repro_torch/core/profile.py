"""Layer-profile extraction for chain CNNs: per-layer FLOPs and
activation sizes — the paper's f_l^i, f_e^i, w_s tables that the MCSA
planner consumes as a :class:`LayerProfile`.

Same closed-form counts as the JAX package's ``repro/core/profile.py``
(the differential tests hold the two equal).  Transformer profiles wait
for the serving slice (ROADMAP, queue 1, item 2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

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


def profile_of(cfg, **kw) -> LayerProfile:
    if isinstance(cfg, ChainCNNConfig):
        return profile_chain_cnn(cfg, batch=kw.get("batch", 1))
    raise NotImplementedError(
        f"profile_of({type(cfg).__name__}): transformer profiles are not "
        "ported yet (ROADMAP, queue 1, item 2: the serving slice)")
