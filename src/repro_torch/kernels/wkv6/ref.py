"""Plain PyTorch WKV6 recurrence: the CPU path of :mod:`.ops` and what the
CUDA kernel is held against on the card.  The JAX package's
``models/rwkv.py::wkv6_scan``, step for step, in the model layout."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, n); w (B, S, H, n) decays in (0, 1); u (H, n);
    s0 (B, H, n, n) or None (zeros).  Returns (y (B, S, H, n) float32,
    s_final (B, H, n, n) float32); state layout s[k_dim, v_dim]."""
    B, S, H, n = r.shape
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r32[:, t], k32[:, t], v32[:, t], w32[:, t]
        y = torch.einsum("bhk,bhkv->bhv", rt, s)
        y = y + vt * torch.sum(rt * (u32 * kt), dim=-1, keepdim=True)
        s = wt[..., None] * s + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, n), dtype=torch.float32, device=r.device))
    return y, s
