"""Learning-rate schedules as step -> scale (multiplied onto
``AdamWConfig.lr``): the JAX package's ``repro.optim.schedules``,
in float32."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``min_frac`` at ``total``; returns a () float32 tensor."""
    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                * prog))
        return warm * cos
    return sched


def constant():
    return lambda step: 1.0
