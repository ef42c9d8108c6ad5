"""Public fused expert SwiGLU: dispatch on the tensor's device, with a
gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.moe_swiglu_cuda` forward,
:func:`.backward.moe_swiglu_bwd_cuda` backward) or raises; a CPU tensor
goes to the plain PyTorch versions (:mod:`.ref`).  There is no other
route and no fallback.

:class:`MoESwiGLUFunction` is the ``torch.autograd.Function`` that a
gradient flows through.  :func:`moe_swiglu` takes it only when autograd
is recording and an input requires a gradient; otherwise (serving) it
calls the forward directly, so the inference path launches exactly what
it did before the backward existed."""
from __future__ import annotations

import torch

from .backward import moe_swiglu_bwd_cuda
from .kernel import check_shapes, moe_swiglu_cuda
from .ref import moe_swiglu_bwd_ref, moe_swiglu_ref


def _forward(x, wg, wu, wd):
    if x.device.type == "cuda":
        return moe_swiglu_cuda(x, wg, wu, wd)
    if x.device.type == "cpu":
        check_shapes(x, wg, wu, wd)
        return moe_swiglu_ref(x, wg, wu, wd)
    raise ValueError(f"moe_swiglu: unsupported device {x.device}")


def _backward(x, wg, wu, wd, dy) -> tuple:
    if x.device.type == "cuda":
        return moe_swiglu_bwd_cuda(x, wg, wu, wd, dy)
    if x.device.type == "cpu":
        return moe_swiglu_bwd_ref(x, wg, wu, wd, dy)
    raise ValueError(f"moe_swiglu: unsupported device {x.device}")


class MoESwiGLUFunction(torch.autograd.Function):
    """The fused expert SwiGLU with the backward kernel (CUDA) or its
    plain version (CPU); saves the inputs, and the backward recomputes
    x·Wg and x·Wu, so the forward launches what serving does."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd):
        ctx.save_for_backward(x, wg, wu, wd)
        return _forward(x, wg, wu, wd)

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wd = ctx.saved_tensors
        return _backward(x, wg, wu, wd, dy.to(x.dtype).contiguous())


def moe_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, ff); wd (E, ff, d) -> (E, C, d)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, wg, wu, wd)):
        return MoESwiGLUFunction.apply(x, wg, wu, wd)
    return _forward(x, wg, wu, wd)
