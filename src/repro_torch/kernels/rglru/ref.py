"""Plain PyTorch RG-LRU scan: the CPU path of :mod:`.ops` and what the
CUDA kernel is held against on the card.  The JAX package's
``kernels/rglru/ref.py::rglru_scan_ref``: a float32 loop over time, and
its gradient (:func:`rglru_scan_bwd_ref`), what the backward kernel is
held against."""
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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor) -> tuple:
    """The gradients (da, db) of :func:`rglru_scan_ref` for the output
    gradient ``dh``, ``h`` being its output: a reverse scan g_t = dh_t +
    a_{t+1} ⊙ g_{t+1} (g past the end 0), db_t = g_t, da_t = g_t ⊙
    h_{t-1} with h_{-1} = 0.  All (B, S, C) float32."""
    a32, h32, dh32 = a.float(), h.float(), dh.float()
    da, db = torch.empty_like(dh32), torch.empty_like(dh32)
    carry = torch.zeros_like(dh32[:, 0])                    # a_{t+1} g_{t+1}
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh32[:, t] + carry
        db[:, t] = g
        da[:, t] = g * h32[:, t - 1] if t else 0.0
        carry = a32[:, t] * g
    return da, db
