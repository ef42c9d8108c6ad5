"""AdamW over the port's parameter trees (no torch.optim).

The port of the JAX package's ``repro.optim.adamw``: the same
defaults, the same global-norm clip, bias-corrected moments and
decoupled weight decay on the float32 parameter, cast back to the
parameter's dtype.  The moments ``m`` and ``v`` are float32 whatever
the parameter dtype, in trees that mirror the parameters.

:func:`update` works **in place**: it writes the new moments into
``state.m`` / ``state.v`` and the new parameters into the parameter
tensors, and returns the same trees (JAX returns new ones).  At full
width that is what fits: starcoder2-3b's float32 moments alone take
34.5 GB, and a second copy would not fit the card beside the weights.
The step counter is a host-side int32 tensor, so the bias corrections
and the learning rate cost no device synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch._tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the host
    m: Any
    v: Any


def init(params) -> AdamWState:
    """Zero float32 moments beside each parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in order."""
    total = 0.0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           lr_scale=1.0, grad_norm=None):
    """One AdamW step, in place (module docstring).  ``grads`` mirrors
    ``params``; ``lr_scale`` (a float or a () tensor) multiplies
    ``cfg.lr``.  ``grad_norm``, when given, is the norm the clip uses in
    place of ``global_norm(grads)``: a mesh's, whose ``grads`` are one
    rank's slices.  Returns (params, new state, {"grad_norm"})."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    b1c = 1.0 - torch.pow(_f32(cfg.b1), step.float())
    b2c = 1.0 - torch.pow(_f32(cfg.b2), step.float())
    lr = _f32(cfg.lr) * _f32(lr_scale)
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        # each product and sum rounded on its own, as the reference's
        # XLA ops round them (no fused multiply-add)
        g32 = g.float() * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        del g32
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm}
