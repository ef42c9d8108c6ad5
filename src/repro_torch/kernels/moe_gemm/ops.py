"""Public fused expert SwiGLU: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel
(:func:`.kernel.moe_swiglu_cuda`) or raises; a CPU tensor goes to the
plain PyTorch version (:mod:`.ref`).  There is no other route and no
fallback, and on CUDA no gradient: a call that autograd records
raises (:func:`repro_torch.kernels._grad.refuse_grad`)."""
from __future__ import annotations

import torch

from repro_torch.kernels._grad import refuse_grad

from .kernel import check_shapes, moe_swiglu_cuda
from .ref import moe_swiglu_ref


def moe_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, ff); wd (E, ff, d) -> (E, C, d)."""
    if x.device.type == "cuda":
        refuse_grad("moe_swiglu", x, wg, wu, wd)
        return moe_swiglu_cuda(x, wg, wu, wd)
    if x.device.type == "cpu":
        check_shapes(x, wg, wu, wd)
        return moe_swiglu_ref(x, wg, wu, wd)
    raise ValueError(f"moe_swiglu: unsupported device {x.device}")
