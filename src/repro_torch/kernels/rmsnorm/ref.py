"""Plain PyTorch RMSNorm: the CPU path of :mod:`.ops` and what the CUDA
kernel is held against on the card.  The JAX package's
``models/layers.py::rms_norm``, op for op."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), w (d,): ``x·rsqrt(mean(x²)+eps)·(1+w)`` with float32
    statistics, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
