"""Plain PyTorch RMSNorm and its backward: the CPU path of :mod:`.ops`
and what the CUDA kernels are held against on the card.  The forward is
the JAX package's ``models/layers.py::rms_norm``, op for op; the
backward is that function's gradient written out, which is what the
reference's train step gets from XLA's autodiff of it."""
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


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6) -> tuple:
    """x and g (..., d), w (d,) -> (dx in x's dtype, dw in w's dtype), the
    gradients of :func:`rmsnorm_ref` for the output gradient ``g``, in
    float32: with ``inv = rsqrt(mean(x²)+eps)``, ``x̂ = x·inv`` and
    ``gy = g·(1+w)``, ``dx = inv·(gy − x̂·mean(gy·x̂))`` and ``dw = Σ g·x̂``
    over every row."""
    x32, g32 = x.float(), g.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * inv
    gy = g32 * (1.0 + w.float())
    dx = inv * (gy - xhat * torch.mean(gy * xhat, dim=-1, keepdim=True))
    dw = (g32 * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
