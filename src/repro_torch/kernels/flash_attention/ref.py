"""Plain PyTorch attention and its backward: the CPU path of :mod:`.ops`
and what the CUDA kernels are held against on the card.  The JAX package's
``kernels/flash_attention/ref.py::attention_ref`` (naive softmax
attention, float32 math) in the model layout: q (B, Sq, Hq, hd), k/v
(B, Skv, Hkv, hd).  Query position i aligns with key position i, as in
the TPU kernel.  :func:`attention_bwd_ref` is the gradient of
:func:`attention_ref` written out (FA-2's formulas, float32), which is
what the reference's train step gets from XLA's autodiff of its jnp
attention.

A training forward also returns (``stats=True``) what the backward
kernel takes from it: each row's log-sum-exp of the scaled scores in
base 2 (the kernels exponentiate in base 2) and ``out_lo``, what the
output's rounding to its dtype left out, so that the backward's
D = rowsum(dO ⊙ (out + out_lo)) sees the float32 output (zeros in
float32)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, stats: bool = False):
    """-> (B, Sq, Hq, hd) in q's dtype; k/v heads serve Hq // Hkv query
    heads each (GQA), scale hd**-0.5.  ``stats=True`` -> (out, lse
    (B, Hq, Sq) float32 in base 2, out_lo in q's dtype)."""
    _, _, vf, p, s = _probs(q, k, v, causal, window)
    o = torch.matmul(p, vf).transpose(1, 2)
    out = o.to(q.dtype)
    if not stats:
        return out
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    return out, lse, (o - out.float()).to(q.dtype)


def _probs(q, k, v, causal: bool, window: int):
    """q, k, v in float32 as (B, Hq, S, hd), k/v widened to Hq heads, the
    masked softmax probabilities (B, Hq, Sq, Skv) and the masked scaled
    scores (NEG_INF where masked)."""
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
    return qf, kf, vf, torch.softmax(s, dim=-1), s


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      lse: torch.Tensor = None,
                      out_lo: torch.Tensor = None) -> tuple:
    """The gradients (dq, dk, dv), each in its input's dtype, of
    :func:`attention_ref` for the output gradient ``dout`` (B, Sq, Hq,
    hd), ``out`` being the forward's output: with P the probabilities,
    dV = Pᵀ·dO, dP = dO·Vᵀ, D = rowsum(dO ⊙ O), dS = P ⊙ (dP − D),
    dQ = scale·dS·K and dK = scale·dSᵀ·Q, dK and dV summed over the
    Hq // Hkv query heads of each k/v head.  With the training forward's
    ``lse`` and ``out_lo`` (``attention_ref(stats=True)``), P is
    2^(s·log2 e − lse) and O is out + out_lo, in float32, as the
    tensor-core kernel takes them."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    qf, kf, vf, p, s = _probs(q, k, v, causal, window)
    if lse is not None:
        p = torch.where(s > 0.5 * NEG_INF,
                        torch.exp2(s * LOG2E - lse.float()[..., None]), 0.0)
    do = dout.float().transpose(1, 2)                       # (B, Hq, Sq, hd)
    o = out.float() if out_lo is None else out.float() + out_lo.float()
    delta = (do * o.transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale    # (B, Hq, Skv, hd)
    dv = torch.matmul(p.transpose(-1, -2), do)

    def group(t):                                           # -> (B, Skv, Hkv, hd)
        return t.reshape(B, Hkv, Hq // Hkv, Skv, hd).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), group(dk).to(k.dtype),
            group(dv).to(v.dtype))
