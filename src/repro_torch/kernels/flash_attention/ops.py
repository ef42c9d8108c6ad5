"""Public flash attention in the model layout: dispatch on the tensor's
device, with a gradient.

A CUDA tensor goes to the hand-written kernels
(:func:`.kernel.flash_attention_cuda` forward,
:func:`.backward.flash_attention_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`); a ``meta``
tensor (the dry run) to the CUDA route's checks and empty outputs of
its shapes and dtypes (the LSE and rounding residual where it returns
them), nothing computed.  There is no other route and no fallback.  All
take ``q_offset`` (query row i at key position ``q_offset + i``: a
rank's sequence shard of q against the gathered keys, context-parallel
attention) and, without one, refuse causal attention with Sq != Skv.
Under a count
(``launch/costs.py``) each call reports the CUDA route's work
(:func:`_cost_forward`, :func:`_cost_backward`) through
:func:`repro_torch.kernels._cost.run`.

:class:`FlashAttentionFunction` is the ``torch.autograd.Function`` that
a gradient flows through.  :func:`flash_attention` takes it only when
autograd is recording and an input requires a gradient; otherwise
(serving) it calls the forward directly, so the inference path launches
exactly what it did before the backward existed."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cost
from . import backward as bwd
from .backward import flash_attention_bwd_cuda
from .kernel import check_args, check_shapes, flash_attention_cuda
from .ref import attention_bwd_ref, attention_ref


def pairs(Sq: int, Skv: int, causal: bool, window: int,
          q_offset: int = 0) -> int:
    """(query, key) pairs of one head that the masks leave: the useful
    work, PERF.md §6's bound, not the kernels' block-granular work (they
    skip the blocks the masks empty, and compute the diagonal blocks
    whole).  Query row i sits at key position p = q_offset + i: causal,
    keys 0..p, the last ``window`` of them; non-causal, keys past
    p - window."""
    off = int(q_offset or 0)

    def below(n: int) -> int:                 # rows at positions 0..n-1
        if causal:                            # min(p + 1, window) keys
            w = window if window > 0 else n
            w = min(w, n)
            return w * (w + 1) // 2 + (n - w) * w
        if not window:
            return n * Skv
        m = max(n - window, 0)                # rows that lose keys
        c = min(m, Skv)
        return n * Skv - (c * (c + 1) // 2 + (m - c) * Skv)

    return below(off + Sq) - below(off)


def _cost_forward(q, k, causal: bool, window: int, stats: bool,
                  q_offset: Optional[int] = None) -> tuple:
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
    return (4.0 * B * Hq * hd * pairs(Sq, k.shape[1], causal, window,
                                      q_offset or 0), moved, 0)


def _cost_backward(q, k, causal: bool, window: int,
                   q_offset: Optional[int] = None) -> tuple:
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
        n = bwd.group_split(B, Sq, Skv, Hq, Hkv, causal, window, hd,
                            q_offset or 0)
        ws = 4 * B * Hq * -(-Sq // bwd.TILE) * bwd.TILE * 2
        if n > 1:
            ws += 4 * 2 * n * B * Skv * Hkv * hd
    else:
        ws = 4 * 2 * B * Hq * Sq
    flops = 2.5 * 4.0 * B * Hq * hd * pairs(Sq, Skv, causal, window,
                                            q_offset or 0)
    return flops, moved, ws


def _run_forward(q, k, v, causal, window, stats, q_offset):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    stats=stats, q_offset=q_offset)
    if q.device.type == "cpu":
        off = check_shapes(q, k, v, causal, window, q_offset)
        out = attention_ref(q, k, v, causal=causal, window=window,
                            stats=stats, q_offset=off)
        if stats and q.dtype != torch.bfloat16:
            out = (out[0], out[1], None)      # the CUDA route's outputs
        return out
    if q.device.type == "meta":
        body = check_args(q, k, v, causal, window, q_offset)
        out = torch.empty_like(q)
        if not stats:
            return out
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        return out, lse, (torch.empty_like(q) if body == "tensor_cores"
                          else None)
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _run_backward(q, k, v, out, dout, causal, window, lse, out_lo,
                  q_offset):
    kw = dict(causal=causal, window=window, lse=lse, out_lo=out_lo)
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, out, dout, q_offset=q_offset,
                                        **kw)
    if q.device.type == "cpu":
        off = check_shapes(q, k, v, causal, window, q_offset)
        return attention_bwd_ref(q, k, v, out, dout, q_offset=off, **kw)
    if q.device.type == "meta":
        bwd.check_args(q, k, v, out, dout, q_offset=q_offset, **kw)
        return tuple(torch.empty_like(t) for t in (q, k, v))
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _forward(q, k, v, causal: bool, window: int, stats: bool = False,
             q_offset: Optional[int] = None):
    return _cost.run(
        "flash_attention",
        lambda: _cost_forward(q, k, causal, window, stats, q_offset),
        lambda: _run_forward(q, k, v, causal, window, stats, q_offset),
        (q, k, v))


def _backward(q, k, v, out, dout, causal: bool, window: int, lse,
              out_lo, q_offset: Optional[int] = None) -> tuple:
    return _cost.run(
        "flash_attention_bwd",
        lambda: _cost_backward(q, k, causal, window, q_offset),
        lambda: _run_backward(q, k, v, out, dout, causal, window, lse,
                              out_lo, q_offset), (q, k, v, out, dout))


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the backward kernel (CUDA) or its plain version
    (CPU); saves q, k, v and the output.  In bfloat16 the forward also
    returns, and saves, each row's log-sum-exp and the output's rounding
    residual (the tensor-core backward's LSE and float32 D); in float32
    the backward recomputes the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=None):
        if q.dtype == torch.bfloat16:
            out, lse, out_lo = _forward(q, k, v, causal, window, stats=True,
                                        q_offset=q_offset)
        else:
            out, lse, out_lo = _forward(q, k, v, causal, window,
                                        q_offset=q_offset), None, None
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out,
                               dout.to(out.dtype).contiguous(), ctx.causal,
                               ctx.window, lse, out_lo, ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd); query
    row i at key position ``q_offset + i`` (given, 0 <= q_offset <= Skv
    - Sq; not given, causal takes Sq == Skv only)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window,
                                            q_offset)
    return _forward(q, k, v, causal, window, q_offset=q_offset)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False, window: int = 0,
                        q_offset: Optional[int] = None) -> tuple:
    """The forward with each row's log-sum-exp (no gradient; serving):
    (out (B, Sq, Hq, hd), lse (B, Hq, Sq) float32 in base 2, out_lo: the
    output's bfloat16 rounding residual, or None in float32); query row
    i at key position ``q_offset + i`` as in :func:`flash_attention`."""
    out, lse, out_lo = _forward(q, k, v, causal, window, stats=True,
                                q_offset=q_offset)
    return out, lse, out_lo if q.dtype == torch.bfloat16 else None
