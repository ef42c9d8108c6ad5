"""Public RMSNorm: dispatch on the tensor's device, with a gradient.

A CUDA tensor goes to the hand-written kernels (:func:`.kernel.rmsnorm_cuda`
forward, :func:`.backward.rmsnorm_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`); a ``meta``
tensor (the dry run) to the same checks as the CUDA route and empty
outputs of its shapes, nothing computed.  There is no other route and
no fallback.  Under a count (``launch/costs.py``) each call reports the
CUDA route's work (:func:`_cost_forward`, :func:`_cost_backward`)
through :func:`repro_torch.kernels._cost.run`.

:class:`RMSNormFunction` is the ``torch.autograd.Function`` that a
gradient flows through.  :func:`rmsnorm` takes it only when autograd is
recording and an input requires a gradient; otherwise (serving, under
``no_grad`` or with plain tensors) it calls the forward directly, so the
inference path launches exactly what it did before the backward existed,
with no autograd bookkeeping on the host."""
from __future__ import annotations

import torch

from repro_torch.kernels import _cost
from .backward import launch_shape, rmsnorm_bwd_cuda
from .kernel import check_args, rmsnorm_cuda
from .ref import rmsnorm_bwd_ref, rmsnorm_ref


def _rows(x: torch.Tensor) -> tuple:
    d = x.shape[-1]
    return (x.numel() // d if d else 0), d


def _cost_forward(x: torch.Tensor) -> tuple:
    """(flops, bytes, workspace) of the forward kernel: x², the row sum,
    the scale and (1 + w) an element; x read, y written, w read once
    (PERF.md §6's bound)."""
    R, d = _rows(x)
    return 4.0 * R * d, (2 * R * d + d) * x.element_size(), 0


def _cost_backward(x: torch.Tensor) -> tuple:
    """(flops, bytes, workspace) of the backward kernels: about eight
    operations an element; x and g read, dx written, w read and dw
    written once (PERF.md §6's bound); the stage-1 partial sums of dw,
    float32 (blocks, d)."""
    R, d = _rows(x)
    blocks = launch_shape(R, d, x.element_size())[2] if R and d else 0
    return (8.0 * R * d, (3 * R * d + 2 * d) * x.element_size(),
            4 * blocks * d)


def _run_forward(x, w, eps):
    if x.device.type == "cuda":
        d = x.shape[-1]
        y = rmsnorm_cuda(x.reshape(-1, d).contiguous(), w.contiguous(), eps)
        return y.reshape(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type == "meta":
        check_args(x.reshape(-1, x.shape[-1]), w)
        return torch.empty_like(x)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


def _run_backward(x, w, g, eps):
    if x.device.type == "cuda":
        d = x.shape[-1]
        dx, dw = rmsnorm_bwd_cuda(x.reshape(-1, d).contiguous(),
                                  w.contiguous(),
                                  g.reshape(-1, d).contiguous(), eps)
        return dx.reshape(x.shape), dw
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, g, eps)
    if x.device.type == "meta":
        check_args(x.reshape(-1, x.shape[-1]), w)
        if g.shape != x.shape or g.dtype != x.dtype:
            raise ValueError(f"rmsnorm backward: g {tuple(g.shape)} "
                             f"{g.dtype}, expected x's {tuple(x.shape)} "
                             f"{x.dtype}")
        launch_shape(*_rows(x), x.element_size())
        return torch.empty_like(x), torch.empty_like(w)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _cost.run("rmsnorm", lambda: _cost_forward(x),
                     lambda: _run_forward(x, w, eps), (x, w))


def _backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              eps: float) -> tuple:
    return _cost.run("rmsnorm_bwd", lambda: _cost_backward(x),
                     lambda: _run_backward(x, w, g, eps), (x, w, g))


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
