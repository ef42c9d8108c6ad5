"""Public flash attention in the model layout: dispatch on the tensor's
device, with a gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.flash_attention_cuda` forward,
:func:`.backward.flash_attention_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`); a ``meta``
tensor (the dry run) to the CUDA route's checks and empty outputs of
its shapes and dtypes (the LSE and rounding residual where it returns
them), nothing computed.  There is no other route and no fallback.  All
refuse causal attention with Sq != Skv.  Under a count
(``launch/costs.py``) each call reports the CUDA route's work
(:func:`_cost_forward`, :func:`_cost_backward`) through
:func:`repro_torch.kernels._cost.run`.

:class:`FlashAttentionFunction` is the ``torch.autograd.Function`` that
a gradient flows through.  :func:`flash_attention` takes it only when
autograd is recording and an input requires a gradient; otherwise
(serving) it calls the forward directly, so the inference path launches
exactly what it did before the backward existed."""
from __future__ import annotations

import torch

from repro_torch.kernels import _cost
from . import backward as bwd
from .backward import flash_attention_bwd_cuda
from .kernel import check_args, check_shapes, flash_attention_cuda
from .ref import attention_bwd_ref, attention_ref


def pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the masks leave: the useful
    work, PERF.md §6's bound, not the kernels' block-granular work (they
    skip the blocks the masks empty, and compute the diagonal blocks
    whole): causal (Sq == Skv), keys 0..i, the last ``window`` of them;
    non-causal, keys past i - window."""
    if causal:
        w = window if 0 < window < Sq else Sq
        return w * (w + 1) // 2 + (Sq - w) * w
    m = max(Sq - window, 0) if window else 0      # rows that lose keys
    c = min(m, Skv)
    return Sq * Skv - (c * (c + 1) // 2 + (m - c) * Skv)


def _cost_forward(q, k, causal: bool, window: int, stats: bool) -> tuple:
    """(flops, bytes, workspace) of the forward kernel: 4·hd a (query,
    key) pair a query head; q, k, v read and out written once (PERF.md
    §6's bound), with ``stats`` the float32 LSE and, in bfloat16, the
    rounding residual written too."""
    B, Sq, Hq, hd = q.shape
    es = q.element_size()
    moved = (2 * q.numel() + 2 * k.numel()) * es
    if stats:
        moved += 4 * B * Hq * Sq + (q.numel() * es
                                    if q.dtype == torch.bfloat16 else 0)
    return 4.0 * B * Hq * hd * pairs(Sq, k.shape[1], causal, window), moved, 0


def _cost_backward(q, k, causal: bool, window: int) -> tuple:
    """(flops, bytes, workspace) of the backward kernels: 2.5 times the
    forward's operations; q, k, v, out, dout read, dq, dk, dv written
    (PERF.md §6's bound), in bfloat16 the LSE and residual read too; the
    float32 scratch (row statistics; the tensor-core body's per-group
    dK/dV partials when :func:`.backward.group_split` splits)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    es = q.element_size()
    moved = 4 * (q.numel() + k.numel()) * es
    if q.dtype == torch.bfloat16:
        moved += 4 * B * Hq * Sq + q.numel() * es
        n = bwd.group_split(B, Sq, Skv, Hq, Hkv, causal, window, hd)
        ws = 4 * B * Hq * -(-Sq // bwd.TILE) * bwd.TILE * 2
        if n > 1:
            ws += 4 * 2 * n * B * Skv * Hkv * hd
    else:
        ws = 4 * 2 * B * Hq * Sq
    flops = 2.5 * 4.0 * B * Hq * hd * pairs(Sq, Skv, causal, window)
    return flops, moved, ws


def _run_forward(q, k, v, causal, window, stats):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    stats=stats)
    if q.device.type == "cpu":
        check_shapes(q, k, v, causal, window)
        out = attention_ref(q, k, v, causal=causal, window=window,
                            stats=stats)
        if stats and q.dtype != torch.bfloat16:
            out = (out[0], out[1], None)      # the CUDA route's outputs
        return out
    if q.device.type == "meta":
        body = check_args(q, k, v, causal, window)
        out = torch.empty_like(q)
        if not stats:
            return out
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        return out, lse, (torch.empty_like(q) if body == "tensor_cores"
                          else None)
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _run_backward(q, k, v, out, dout, causal, window, lse, out_lo):
    kw = dict(causal=causal, window=window, lse=lse, out_lo=out_lo)
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, out, dout, **kw)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, dout, **kw)
    if q.device.type == "meta":
        bwd.check_args(q, k, v, out, dout, **kw)
        return tuple(torch.empty_like(t) for t in (q, k, v))
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _forward(q, k, v, causal: bool, window: int, stats: bool = False):
    return _cost.run(
        "flash_attention",
        lambda: _cost_forward(q, k, causal, window, stats),
        lambda: _run_forward(q, k, v, causal, window, stats), (q, k, v))


def _backward(q, k, v, out, dout, causal: bool, window: int, lse,
              out_lo) -> tuple:
    return _cost.run(
        "flash_attention_bwd", lambda: _cost_backward(q, k, causal, window),
        lambda: _run_backward(q, k, v, out, dout, causal, window, lse,
                              out_lo), (q, k, v, out, dout))


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
