"""The train step: loss, backward, AdamW.

The port of the JAX package's ``repro/runtime/train.py`` on one card.
``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` with ``metrics`` holding ``loss``,
``aux``, ``total`` and ``grad_norm`` (() tensors on the device), as the
reference's does.  Gradients come from ``torch.autograd.grad`` through
:func:`repro_torch.models.transformer.loss_fn` (on the card: the
attention and RMSNorm backward kernels, ``remat`` recomputing each
block), and :func:`repro_torch.optim.adamw.update` applies them in
place, so the returned trees are the ones passed in.

The reference's mesh-only fields (``zero1``, ``bf16_collectives``,
``context_parallel_attention``, ``triangular_attention``,
``kv_quant_serving``) wait for ROADMAP item 8: one card has no data
axis to shard the moments over and no collective to pin.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch._tree import leaves, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    remat: bool = True
    capacity_factor: float = 1.25


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                    lr_schedule: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the learning rate is ``tcfg.adamw.lr`` times
    ``lr_schedule(opt_state.step)`` (default 1)."""
    sched = lr_schedule or (lambda s: 1.0)

    def train_step(params, opt_state: AdamWState, batch: dict):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        total, metrics = loss_fn(cfg, params, batch, remat=tcfg.remat,
                                 capacity_factor=tcfg.capacity_factor)
        grads = unflatten(params, torch.autograd.grad(total, flat))
        params, opt_state, opt_metrics = adamw.update(
            tcfg.adamw, grads, opt_state, params,
            lr_scale=sched(opt_state.step))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, total=total.detach(),
                                       **opt_metrics)

    return train_step
