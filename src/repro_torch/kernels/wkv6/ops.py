"""Public WKV6 recurrence in the model layout: dispatch on the tensor's
device.

A CUDA tensor goes to the hand-written kernel (:func:`.kernel.wkv6_cuda`)
or raises; a CPU tensor goes to the plain PyTorch version (:mod:`.ref`).
There is no other route and no fallback, and on CUDA no gradient: a call
that autograd records raises
(:func:`repro_torch.kernels._grad.refuse_grad`)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._grad import refuse_grad

from .kernel import check_shapes, wkv6_cuda
from .ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, n); u (H, n); s0 (B, H, n, n) or None ->
    (y (B, S, H, n) float32, final state (B, H, n, n) float32).  With
    ``state_out`` (which may be ``s0``) the final state is written there,
    in place, and returned."""
    if r.device.type == "cuda":
        refuse_grad("wkv6", r, k, v, w, u, s0)
        return wkv6_cuda(r, k, v, w, u, s0, state_out)
    if r.device.type == "cpu":
        check_shapes(r, k, v, w, u, s0, state_out)
        y, s = wkv6_ref(r, k, v, w, u, s0)
        if state_out is not None:
            s = state_out.copy_(s)
        return y, s
    raise ValueError(f"wkv6: unsupported device {r.device}")
