"""Plain PyTorch fused expert SwiGLU: the CPU path of :mod:`.ops` and
what the CUDA kernel is held against on the card.  The JAX package's
``kernels/moe_gemm/ref.py::moe_swiglu_ref``, op for op: every product in
float32, the result cast to x's dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_swiglu_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, ff); wd (E, ff, d) -> (E, C, d) in x's
    dtype, ``(silu(x·Wg) ⊙ x·Wu)·Wd`` per expert in float32."""
    x32 = x.float()
    g = torch.bmm(x32, wg.float())
    u = torch.bmm(x32, wu.float())
    return torch.bmm(F.silu(g) * u, wd.float()).to(x.dtype)
