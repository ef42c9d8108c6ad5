"""Public fused expert SwiGLU: dispatch on the tensor's device, with a
gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.moe_swiglu_cuda` forward,
:func:`.backward.moe_swiglu_bwd_cuda` backward) or raises; a CPU tensor
goes to the plain PyTorch versions (:mod:`.ref`); a ``meta`` tensor
(the dry run) to the CUDA route's checks and empty outputs of its
shapes, nothing computed.  There is no other route and no fallback.
Under a count (``launch/costs.py``) each call reports the CUDA route's
work (:func:`_cost_forward`, :func:`_cost_backward`) through
:func:`repro_torch.kernels._cost.run`.

:class:`MoESwiGLUFunction` is the ``torch.autograd.Function`` that a
gradient flows through.  :func:`moe_swiglu` takes it only when autograd
is recording and an input requires a gradient; otherwise (serving) it
calls the forward directly, so the inference path launches exactly what
it did before the backward existed."""
from __future__ import annotations

import torch

from repro_torch.kernels import _cost
from .backward import check_args as bwd_check_args
from .backward import moe_swiglu_bwd_cuda
from .kernel import body_for, check_args, check_shapes, moe_swiglu_cuda
from .ref import moe_swiglu_bwd_ref, moe_swiglu_ref


#: the H100's streaming multiprocessors, for the mma body's ff slices
#: (``csrc/moe_swiglu.cu``'s ``tc::slices`` with the card's count)
SMS = 132
#: the mma body's capacity rows a block and ff columns a step
MMA_BM, MMA_BF = 16, 64


def mma_slices(E: int, C: int, ff: int) -> int:
    """The ff slices the mma body's plan gives (``tc::slices``): about
    two blocks an SM, each slice a whole number of steps."""
    blocks = E * -(-C // MMA_BM)
    steps = -(-ff // MMA_BF)
    fs = min(max(-(-2 * SMS // blocks), 1), steps)
    per = -(-steps // fs)
    return -(-steps // per)


def _cost_forward(x, wg) -> tuple:
    """(flops, bytes, workspace) of the forward kernel: 6·E·C·d·ff (three
    products); x read, y written, the three weights read once (PERF.md
    §6's bound); the body's workspace: h as bf16 hi + lo (wgmma), the
    float32 partial outputs of the ff slices (mma, more than one)."""
    E, C, d = x.shape
    ff = wg.shape[2]
    es = x.element_size()
    body = body_for(x.dtype, C, d, ff)
    ws = 0
    if body == "wgmma":
        ws = 2 * E * C * ff * es
    elif body == "mma":
        fs = mma_slices(E, C, ff)
        ws = 4 * fs * E * C * d if fs > 1 else 0
    return 6.0 * E * C * d * ff, (2 * x.numel() + 3 * wg.numel()) * es, ws


def _cost_backward(x, wg) -> tuple:
    """(flops, bytes, workspace) of the backward kernels: 12·E·C·d·ff;
    x, dy and the weights read, their gradients written (PERF.md §6's
    bound); h, dG and dU (E, C, ff) in x's dtype."""
    E, C, d = x.shape
    ff = wg.shape[2]
    es = x.element_size()
    return (12.0 * E * C * d * ff, 2 * (2 * x.numel() + 3 * wg.numel()) * es,
            3 * E * C * ff * es)


def _run_forward(x, wg, wu, wd):
    if x.device.type == "cuda":
        return moe_swiglu_cuda(x, wg, wu, wd)
    if x.device.type == "cpu":
        check_shapes(x, wg, wu, wd)
        return moe_swiglu_ref(x, wg, wu, wd)
    if x.device.type == "meta":
        check_args(x, wg, wu, wd)
        return torch.empty_like(x)
    raise ValueError(f"moe_swiglu: unsupported device {x.device}")


def _run_backward(x, wg, wu, wd, dy):
    if x.device.type == "cuda":
        return moe_swiglu_bwd_cuda(x, wg, wu, wd, dy)
    if x.device.type == "cpu":
        return moe_swiglu_bwd_ref(x, wg, wu, wd, dy)
    if x.device.type == "meta":
        bwd_check_args(x, wg, wu, wd, dy)
        return tuple(torch.empty_like(t) for t in (x, wg, wu, wd))
    raise ValueError(f"moe_swiglu: unsupported device {x.device}")


def _forward(x, wg, wu, wd):
    return _cost.run("moe_swiglu", lambda: _cost_forward(x, wg),
                     lambda: _run_forward(x, wg, wu, wd), (x, wg, wu, wd))


def _backward(x, wg, wu, wd, dy) -> tuple:
    return _cost.run("moe_swiglu_bwd", lambda: _cost_backward(x, wg),
                     lambda: _run_backward(x, wg, wu, wd, dy),
                     (x, wg, wu, wd, dy))


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
