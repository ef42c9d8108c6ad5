"""Plain PyTorch attention: the CPU path of :mod:`.ops` and what the CUDA
kernel is held against on the card.  The JAX package's
``kernels/flash_attention/ref.py::attention_ref`` (naive softmax
attention, float32 math) in the model layout: q (B, Sq, Hq, hd), k/v
(B, Skv, Hkv, hd).  Query position i aligns with key position i, as in
the TPU kernel."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """-> (B, Sq, Hq, hd) in q's dtype; k/v heads serve Hq // Hkv query
    heads each (GQA), scale hd**-0.5."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.float().transpose(1, 2)                          # (B, Hq, Sq, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * hd ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2).to(q.dtype)
