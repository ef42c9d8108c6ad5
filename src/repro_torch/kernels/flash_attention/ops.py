"""Public flash attention in the model layout: dispatch on the tensor's
device, with a gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.flash_attention_cuda` forward,
:func:`.backward.flash_attention_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`).  There is no
other route and no fallback.  Both refuse causal attention with
Sq != Skv.

:class:`FlashAttentionFunction` is the ``torch.autograd.Function`` that
a gradient flows through.  :func:`flash_attention` takes it only when
autograd is recording and an input requires a gradient; otherwise
(serving) it calls the forward directly, so the inference path launches
exactly what it did before the backward existed."""
from __future__ import annotations

import torch

from .backward import flash_attention_bwd_cuda
from .kernel import check_shapes, flash_attention_cuda
from .ref import attention_bwd_ref, attention_ref


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        check_shapes(q, k, v, causal, window)
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _backward(q, k, v, out, dout, causal: bool, window: int) -> tuple:
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, out, dout, causal=causal,
                                        window=window)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                 window=window)
    raise ValueError(f"flash attention: unsupported device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the backward kernel (CUDA) or its plain version
    (CPU); saves q, k, v and the output, and recomputes the softmax
    statistics in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out,
                               dout.to(out.dtype).contiguous(), ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
