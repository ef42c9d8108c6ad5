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


def moe_swiglu_split_ref(x: torch.Tensor, wg: torch.Tensor,
                         wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """A plain float32 model of the wgmma body's two kernels, same
    contract as :func:`moe_swiglu_ref`: g and u in float32, h written as
    bf16 hi and lo = bf16(h - hi) and read back, y = hi·Wd + lo·Wd summed
    in float32 and cast once.  The tests hold it against
    :func:`moe_swiglu_ref`."""
    x32 = x.float()
    h = F.silu(torch.bmm(x32, wg.float())) * torch.bmm(x32, wu.float())
    hi = h.to(torch.bfloat16)
    lo = (h - hi.float()).to(torch.bfloat16)
    wd32 = wd.float()
    return (torch.bmm(hi.float(), wd32)
            + torch.bmm(lo.float(), wd32)).to(x.dtype)
