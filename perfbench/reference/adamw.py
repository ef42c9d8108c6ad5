"""AdamW in float32, as the configuration states it: the gradient
clipped to a global norm, bias-corrected moments, weight decay decoupled
and applied to the parameter."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    @torch.no_grad()
    def step(self, params: list, grads: list, m: list, v: list,
             t: int) -> list:
        """Step ``t`` (from 1) in place over lists of tensors; returns the
        norm of each clipped gradient the moments took."""
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        clip = min(1.0, self.grad_clip / max(float(norm), 1e-9))
        b1c = 1.0 - self.b1 ** t
        b2c = 1.0 - self.b2 ** t
        taken = []
        for p, g, mi, vi in zip(params, grads, m, v):
            g = g * clip
            mi.mul_(self.b1).add_(g, alpha=1 - self.b1)
            vi.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * ((mi / b1c) / (torch.sqrt(vi / b2c) + self.eps)
                              + self.weight_decay * p))
            taken.append(float(torch.linalg.vector_norm(g)))
        return taken
