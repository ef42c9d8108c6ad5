"""Public RG-LRU scan: dispatch on the tensor's device, with a gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.rglru_scan_cuda` forward,
:func:`.backward.rglru_scan_bwd_cuda` backward) or raises; a CPU tensor
goes to the plain PyTorch versions (:mod:`.ref`).  There is no other
route and no fallback.

:class:`RGLRUScanFunction` is the ``torch.autograd.Function`` that a
gradient flows through.  :func:`rglru_scan` takes it only when autograd
is recording and an input requires a gradient; otherwise (serving) it
calls the forward directly, so the inference path launches exactly what
it did before the backward existed."""
from __future__ import annotations

import torch

from .backward import rglru_scan_bwd_cuda
from .kernel import check_shapes, rglru_scan_cuda
from .ref import rglru_scan_bwd_ref, rglru_scan_ref


def _forward(a, b):
    if a.device.type == "cuda":
        return rglru_scan_cuda(a, b)
    if a.device.type == "cpu":
        check_shapes(a, b)
        return rglru_scan_ref(a, b)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")


def _backward(a, h, dh) -> tuple:
    if a.device.type == "cuda":
        return rglru_scan_bwd_cuda(a, h, dh)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")


class RGLRUScanFunction(torch.autograd.Function):
    """The scan with the backward kernel (CUDA) or its plain version
    (CPU); saves a and the output h."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return _backward(a, h, dh.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, C) float32 -> h (B, S, C) float32, h_t = a_t h_{t-1}
    + b_t from h = 0."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScanFunction.apply(a, b)
    return _forward(a, b)
