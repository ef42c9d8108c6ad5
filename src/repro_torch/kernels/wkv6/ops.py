"""Public WKV6 recurrence in the model layout: dispatch on the tensor's
device, with a gradient.

A CUDA tensor goes to the hand-written kernels (:func:`.kernel.wkv6_cuda`
forward, :func:`.backward.wkv6_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`).  There is no
other route and no fallback.

:class:`WKV6Function` is the ``torch.autograd.Function`` that a gradient
flows through.  :func:`wkv6` takes it only when autograd is recording
and an input requires a gradient; otherwise (serving, decode's in-place
state among it) it calls the forward directly, so the inference path
launches exactly what it did before the backward existed."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .backward import wkv6_bwd_cuda
from .kernel import check_shapes, wkv6_cuda
from .ref import wkv6_bwd_ref, wkv6_ref


def _forward(r, k, v, w, u, s0=None, state_out=None):
    if r.device.type == "cuda":
        return wkv6_cuda(r, k, v, w, u, s0, state_out)
    if r.device.type == "cpu":
        check_shapes(r, k, v, w, u, s0, state_out)
        y, s = wkv6_ref(r, k, v, w, u, s0)
        if state_out is not None:
            s = state_out.copy_(s)
        return y, s
    raise ValueError(f"wkv6: unsupported device {r.device}")


def _backward(r, k, v, w, u, s0, dy, ds) -> tuple:
    if r.device.type == "cuda":
        return wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds)
    raise ValueError(f"wkv6: unsupported device {r.device}")


class WKV6Function(torch.autograd.Function):
    """WKV6 with the backward kernel (CUDA) or its plain version (CPU);
    saves the inputs, and the backward re-runs the recurrence for the
    states it needs (the forward keeps none)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s = _forward(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        # autograd passes zeros for an output that took no gradient
        r, k, v, w, u, s0 = ctx.saved_tensors
        return _backward(r, k, v, w, u, s0, dy.float().contiguous(),
                         ds.float().contiguous())


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, n); u (H, n); s0 (B, H, n, n) or None ->
    (y (B, S, H, n) float32, final state (B, H, n, n) float32).  With
    ``state_out`` (which may be ``s0``) the final state is written there,
    in place, and returned; that in-place form takes no gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        if state_out is not None:
            raise ValueError("wkv6: state_out writes in place, which "
                             "autograd cannot record; pass None")
        return WKV6Function.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0, state_out)
