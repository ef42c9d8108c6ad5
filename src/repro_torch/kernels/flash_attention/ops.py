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


def _forward(q, k, v, causal: bool, window: int, stats: bool = False):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    stats=stats)
    if q.device.type == "cpu":
        check_shapes(q, k, v, causal, window)
        return attention_ref(q, k, v, causal=causal, window=window,
                             stats=stats)
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _backward(q, k, v, out, dout, causal: bool, window: int, lse,
              out_lo) -> tuple:
    kw = dict(causal=causal, window=window, lse=lse, out_lo=out_lo)
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, out, dout, **kw)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, dout, **kw)
    raise ValueError(f"flash attention: unsupported device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the backward kernel (CUDA) or its plain version
    (CPU); saves q, k, v and the output.  In bfloat16 the forward also
    returns, and saves, each row's log-sum-exp and the output's rounding
    residual (the tensor-core backward's LSE and float32 D); in float32
    the backward recomputes the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.dtype == torch.bfloat16:
            out, lse, out_lo = _forward(q, k, v, causal, window, stats=True)
        else:
            out, lse, out_lo = _forward(q, k, v, causal, window), None, None
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out,
                               dout.to(out.dtype).contiguous(), ctx.causal,
                               ctx.window, lse, out_lo)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False, window: int = 0) -> tuple:
    """The forward with each row's log-sum-exp (no gradient; serving):
    (out (B, Sq, Hq, hd), lse (B, Hq, Sq) float32 in base 2, out_lo: the
    output's bfloat16 rounding residual, or None in float32)."""
    out, lse, out_lo = _forward(q, k, v, causal, window, stats=True)
    return out, lse, out_lo if q.dtype == torch.bfloat16 else None
