"""Public RG-LRU scan: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel
(:func:`.kernel.rglru_scan_cuda`) or raises; a CPU tensor goes to the
plain PyTorch version (:mod:`.ref`).  There is no other route and no
fallback, and on CUDA no gradient: a call that autograd records
raises (:func:`repro_torch.kernels._grad.refuse_grad`)."""
from __future__ import annotations

import torch

from repro_torch.kernels._grad import refuse_grad

from .kernel import check_shapes, rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, C) float32 -> h (B, S, C) float32, h_t = a_t h_{t-1}
    + b_t from h = 0."""
    if a.device.type == "cuda":
        refuse_grad("rglru_scan", a, b)
        return rglru_scan_cuda(a, b)
    if a.device.type == "cpu":
        check_shapes(a, b)
        return rglru_scan_ref(a, b)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")
