"""Public RG-LRU scan: dispatch on the tensor's device, with a gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.rglru_scan_cuda` forward,
:func:`.backward.rglru_scan_bwd_cuda` backward) or raises; a CPU tensor
goes to the plain PyTorch versions (:mod:`.ref`); a ``meta`` tensor
(the dry run) to the CUDA route's checks and empty outputs of its
shapes, nothing computed (the plain version loops over time in Python,
so it never runs there).  There is no other route and no fallback.
Under a count (``launch/costs.py``) each call reports the CUDA route's
work (:func:`_cost_forward`, :func:`_cost_backward`) through
:func:`repro_torch.kernels._cost.run`.

:class:`RGLRUScanFunction` is the ``torch.autograd.Function`` that a
gradient flows through.  :func:`rglru_scan` takes it only when autograd
is recording and an input requires a gradient; otherwise (serving) it
calls the forward directly, so the inference path launches exactly what
it did before the backward existed."""
from __future__ import annotations

import torch

from repro_torch.kernels import _cost
from .backward import check_args as bwd_check_args
from .backward import rglru_scan_bwd_cuda, workspace_bytes
from .kernel import check_args, check_shapes, rglru_scan_cuda
from .ref import rglru_scan_bwd_ref, rglru_scan_ref


def _cost_forward(a) -> tuple:
    """(flops, bytes, workspace) of the forward kernel: a multiply-add an
    element; a and b read, h written, float32 (PERF.md §6's 12 bytes an
    element)."""
    n = a.numel()
    return 2.0 * n, 12 * n, 0


def _cost_backward(a) -> tuple:
    """(flops, bytes, workspace) of the backward kernel: about four
    operations an element; a, h and dh read, da and db written (PERF.md
    §6's 20 bytes an element); the chained carries and their flags
    (:func:`.backward.workspace_bytes`)."""
    n = a.numel()
    return 4.0 * n, 20 * n, workspace_bytes(*a.shape) if n else 0


def _run_forward(a, b):
    if a.device.type == "cuda":
        return rglru_scan_cuda(a, b)
    if a.device.type == "cpu":
        check_shapes(a, b)
        return rglru_scan_ref(a, b)
    if a.device.type == "meta":
        check_args(a, b)
        return torch.empty_like(a)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")


def _run_backward(a, h, dh):
    if a.device.type == "cuda":
        return rglru_scan_bwd_cuda(a, h, dh)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh)
    if a.device.type == "meta":
        bwd_check_args(a, h, dh)
        return torch.empty_like(a), torch.empty_like(a)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")


def _forward(a, b):
    return _cost.run("rglru_scan", lambda: _cost_forward(a),
                     lambda: _run_forward(a, b), (a, b))


def _backward(a, h, dh) -> tuple:
    return _cost.run("rglru_scan_bwd", lambda: _cost_backward(a),
                     lambda: _run_backward(a, h, dh), (a, h, dh))


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
