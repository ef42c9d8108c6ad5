"""Public RMSNorm: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel (:func:`.kernel.rmsnorm_cuda`)
or raises; a CPU tensor goes to the plain PyTorch version (:mod:`.ref`).
There is no other route and no fallback."""
from __future__ import annotations

import torch

from .kernel import rmsnorm_cuda
from .ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), w (d,) -> same shape and dtype as x."""
    if x.device.type == "cuda":
        d = x.shape[-1]
        y = rmsnorm_cuda(x.reshape(-1, d).contiguous(),
                         w.contiguous(), eps)
        return y.reshape(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")
