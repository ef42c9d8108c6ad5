"""Plain PyTorch fused expert SwiGLU: the CPU path of :mod:`.ops` and
what the CUDA kernel is held against on the card.  The JAX package's
``kernels/moe_gemm/ref.py::moe_swiglu_ref``, op for op: every product in
float32, the result cast to x's dtype.  :func:`moe_swiglu_bwd_ref` is its
gradient written out, what the backward kernel is held against."""
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


def moe_swiglu_bwd_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor, dy: torch.Tensor) -> tuple:
    """The gradients (dx, dwg, dwu, dwd), each in its input's dtype, of
    :func:`moe_swiglu_ref` for the output gradient ``dy`` (E, C, d), in
    float32: with G = x·Wg, U = x·Wu, σ = sigmoid(G), H = silu(G) ⊙ U and
    dH = dy·Wdᵀ: dWd = Hᵀ·dy, dG = dH ⊙ U ⊙ σ(1 + G(1 − σ)),
    dU = dH ⊙ silu(G), dx = dG·Wgᵀ + dU·Wuᵀ, dWg = xᵀ·dG, dWu = xᵀ·dU."""
    x32, wg32, wu32, wd32 = (t.float() for t in (x, wg, wu, wd))
    dy32 = dy.float()
    g, u = torch.bmm(x32, wg32), torch.bmm(x32, wu32)
    sig = torch.sigmoid(g)
    silu = g * sig
    dh = torch.bmm(dy32, wd32.transpose(1, 2))
    dg = dh * u * (sig * (1.0 + g * (1.0 - sig)))
    du = dh * silu
    xt = x32.transpose(1, 2)
    dx = (torch.bmm(dg, wg32.transpose(1, 2))
          + torch.bmm(du, wu32.transpose(1, 2)))
    return (dx.to(x.dtype), torch.bmm(xt, dg).to(wg.dtype),
            torch.bmm(xt, du).to(wu.dtype),
            torch.bmm((silu * u).transpose(1, 2), dy32).to(wd.dtype))
