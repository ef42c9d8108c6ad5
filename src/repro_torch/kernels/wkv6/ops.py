"""Public WKV6 recurrence in the model layout: dispatch on the tensor's
device, with a gradient.

A CUDA tensor goes to the hand-written kernels (:func:`.kernel.wkv6_cuda`
forward, :func:`.backward.wkv6_bwd_cuda` backward) or raises; a CPU
tensor goes to the plain PyTorch versions (:mod:`.ref`); a ``meta``
tensor (the dry run) to the CUDA route's checks and empty outputs of
its shapes and dtypes, nothing computed (the plain versions loop over
time in Python, so they never run there).  There is no other route and
no fallback.  Under a count (``launch/costs.py``) each call reports the
CUDA route's work (:func:`_cost_forward`, :func:`_cost_backward`)
through :func:`repro_torch.kernels._cost.run`.

:class:`WKV6Function` is the ``torch.autograd.Function`` that a gradient
flows through.  :func:`wkv6` takes it only when autograd is recording
and an input requires a gradient; otherwise (serving, decode's in-place
state among it) it calls the forward directly, so the inference path
launches exactly what it did before the backward existed."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cost
from .backward import check_args as bwd_check_args
from .backward import wkv6_bwd_cuda
from .backward import workspace_bytes as bwd_workspace_bytes
from .kernel import CHUNK, body_for, check_args, check_shapes, wkv6_cuda
from .ref import wkv6_bwd_ref, wkv6_ref


def _cost_forward(r, s0) -> tuple:
    """(flops, bytes, workspace) of the forward kernel: 3 operations a
    state element a step; r, k, v, w read, y written, u read, the final
    state written and s0 read (PERF.md §6's bound); the chunked body's
    chunk states and decays (float32)."""
    B, S, H, n = r.shape
    moved = (r.numel() * (3 * r.element_size() + 4 + 4)
             + (2 if s0 is not None else 1) * B * H * n * n * 4
             + H * n * 4)
    ws = 0
    if body_for(S, n) == "chunked":
        nc = -(-S // CHUNK)
        ws = 4 * B * H * nc * (n * n + n)
    return 3.0 * B * S * H * n * n, moved, ws


def _cost_backward(r, s0) -> tuple:
    """(flops, bytes, workspace) of the backward kernels: 8 operations a
    state element a step; PERF.md §6's bytes (r, k, v, w, dy read, their
    gradients written; with s0, s0 and ds read and ds0 written); the
    body's workspace (:func:`.backward.workspace_bytes`) and du's float32
    partials."""
    B, S, H, n = r.shape
    body = body_for(S, n)
    moved = (r.numel() * (6 * r.element_size() + 12)
             + (4 * B * H * n * n * 4 if s0 is not None else 0)
             + 2 * H * n * 4)
    part = B * H * n * (1 if body == "serial" else -(-S // CHUNK))
    ws = bwd_workspace_bytes(B, S, H, n, body) + 4 * part
    return 8.0 * B * S * H * n * n, moved, ws


def _run_forward(r, k, v, w, u, s0, state_out):
    if r.device.type == "cuda":
        return wkv6_cuda(r, k, v, w, u, s0, state_out)
    if r.device.type == "cpu":
        check_shapes(r, k, v, w, u, s0, state_out)
        y, s = wkv6_ref(r, k, v, w, u, s0)
        if state_out is not None:
            s = state_out.copy_(s)
        return y, s
    if r.device.type == "meta":
        check_args(r, k, v, w, u, s0, state_out)
        B, _, H, n = r.shape
        y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        return y, (state_out if state_out is not None else torch.empty(
            (B, H, n, n), dtype=torch.float32, device=r.device))
    raise ValueError(f"wkv6: unsupported device {r.device}")


def _run_backward(r, k, v, w, u, s0, dy, ds):
    if r.device.type == "cuda":
        return wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds)
    if r.device.type == "meta":
        bwd_check_args(r, k, v, w, u, s0, dy, ds)
        return (*(torch.empty_like(t) for t in (r, k, v, w, u)),
                None if s0 is None else torch.empty_like(s0))
    raise ValueError(f"wkv6: unsupported device {r.device}")


def _forward(r, k, v, w, u, s0=None, state_out=None):
    return _cost.run("wkv6", lambda: _cost_forward(r, s0),
                     lambda: _run_forward(r, k, v, w, u, s0, state_out),
                     (r, k, v, w, u, s0, state_out))


def _backward(r, k, v, w, u, s0, dy, ds) -> tuple:
    return _cost.run("wkv6_bwd", lambda: _cost_backward(r, s0),
                     lambda: _run_backward(r, k, v, w, u, s0, dy, ds),
                     (r, k, v, w, u, s0, dy, ds))


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
