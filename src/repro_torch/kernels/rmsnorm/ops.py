"""Public RMSNorm: dispatch on the tensor's device, with a gradient.

A CUDA tensor goes to the hand-written kernels (:func:`.kernel.rmsnorm_cuda`
forward, :func:`.backward.rmsnorm_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`).  There is no
other route and no fallback.

:class:`RMSNormFunction` is the ``torch.autograd.Function`` that a
gradient flows through.  :func:`rmsnorm` takes it only when autograd is
recording and an input requires a gradient; otherwise (serving, under
``no_grad`` or with plain tensors) it calls the forward directly, so the
inference path launches exactly what it did before the backward existed,
with no autograd bookkeeping on the host."""
from __future__ import annotations

import torch

from .backward import rmsnorm_bwd_cuda
from .kernel import rmsnorm_cuda
from .ref import rmsnorm_bwd_ref, rmsnorm_ref


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cuda":
        d = x.shape[-1]
        y = rmsnorm_cuda(x.reshape(-1, d).contiguous(), w.contiguous(), eps)
        return y.reshape(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


def _backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              eps: float) -> tuple:
    if x.device.type == "cuda":
        d = x.shape[-1]
        dx, dw = rmsnorm_bwd_cuda(x.reshape(-1, d).contiguous(),
                                  w.contiguous(),
                                  g.reshape(-1, d).contiguous(), eps)
        return dx.reshape(x.shape), dw
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, g, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with the backward kernel (CUDA) or its plain version
    (CPU); saves x and w, recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _backward(x, w, g.to(x.dtype), ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), w (d,) -> same shape and dtype as x."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFunction.apply(x, w, eps)
    return _forward(x, w, eps)
