"""Plain PyTorch RG-LRU scan: the CPU path of :mod:`.ops` and what the
CUDA kernel is held against on the card.  The JAX package's
``kernels/rglru/ref.py::rglru_scan_ref``: a float32 loop over time."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t from h = 0 (so h_0 = b_0).  a, b
    (B, S, C) -> h (B, S, C) float32."""
    a32, b32 = a.float(), b.float()
    h = torch.zeros_like(b32[:, 0])
    out = torch.empty_like(b32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out
